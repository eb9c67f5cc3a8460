"""Pseudo-realtime tracers: FastTracer, GameTracer, path-space filtering.

Counterparts of reference ``Integrators/PseudoRealtime/``:
  * FastTracer (FastTracer.{h,cu}): buffered primary-visibility/depth renderer
    — the raw Mrays/s baseline;
  * GameTracer (GameTracer.{h,cu}): primary hit + direct light + temporally
    reused path-space-filtered indirect irradiance;
  * PathSpaceFilteringBuffer (Kernel/PathSpaceFilteringBuffer.{h,cu}): a
    hash-grid of shaded hit points blended over frames. Translation: the
    RGBE-compressed `path_entry` grid becomes the sort-based hash grid with a
    fixed-K gather and an exponential temporal blend carried as a pytree.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import hashgrid
from ..math import montecarlo as mc
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import (PTConfig, _light_select_pmf, _offset_ray,
                          _select_light, block_order_pixels, specialize_config,
                          trace_radiance)


@partial(jax.jit, static_argnames=("width", "height"))
def render_fast(scene: Scene, width: int, height: int, seed=0):
    """FastTracer: primary visibility only — depth + flat shading.
    The rays/s of this pass is the traversal speed-of-light measurement."""
    n_px = width * height
    pid = block_order_pixels(width, height)
    px = (pid % width).astype(jnp.float32)
    py = (pid // width).astype(jnp.float32)
    uv = jnp.stack([(px + 0.5) / width, (py + 0.5) / height], -1)
    smp = Sampler.create(seed, pid, 0)
    _, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit)
    mp = gather_mat_params(scene, it)
    # headlight shading: albedo * |n . -d|
    shade = mp.albedo * jnp.abs(jnp.sum(it.frame.n * -d, -1, keepdims=True))
    img = jnp.zeros((n_px, 3)).at[pid.astype(jnp.int32)].set(
        jnp.where(hit.valid[..., None], shade, 0.0)
    )
    depth = jnp.zeros((n_px,)).at[pid.astype(jnp.int32)].set(
        jnp.where(hit.valid, hit.t, 0.0)
    )
    return img.reshape(height, width, 3), depth.reshape(height, width)


class PSFBuffer(NamedTuple):
    """Path-space filtering state: cached hit-point irradiance
    (PathSpaceFilteringBuffer.h:17-24 path_entry{p, Li, nor, wi})."""

    p: jnp.ndarray        # (N, 3) cache positions
    li: jnp.ndarray       # (N, 3) cached indirect irradiance
    n: jnp.ndarray        # (N, 3) normals
    valid: jnp.ndarray    # (N,)
    frame: jnp.ndarray    # () frame counter

    @staticmethod
    def create(capacity: int) -> "PSFBuffer":
        return PSFBuffer(
            p=jnp.zeros((capacity, 3)), li=jnp.zeros((capacity, 3)),
            n=jnp.zeros((capacity, 3)), valid=jnp.zeros((capacity,), bool),
            frame=jnp.zeros(()),
        )


class GTConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=3, rr_start=99)
    radius: float = 0.05
    max_gather: int = 16
    grid_res: int = 64
    alpha: float = 0.15   # temporal blend (PathSpaceFilteringBuffer.cu alpha)


@partial(jax.jit, static_argnames=("width", "height", "config"))
def _game_impl(scene: Scene, psf: PSFBuffer, width: int, height: int, seed,
               config: GTConfig):
    cfg = config.base
    n_px = width * height
    pid = block_order_pixels(width, height)
    px = (pid % width).astype(jnp.float32)
    py = (pid // width).astype(jnp.float32)
    smp = Sampler.create(seed, pid, jnp.uint32(0x6A3E))
    smp, jit2 = smp.next_2d()
    uv = jnp.stack([(px + jit2[:, 0]) / width, (py + jit2[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)

    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit)
    mp = gather_mat_params(scene, it, cfg.tex_types)
    wo_local = it.frame.to_local(-d)

    # direct light at the primary hit
    smp, u_sel = smp.next_1d()
    smp, u_l2 = smp.next_2d()
    direct = jnp.zeros((n_px, 3))[: hit.t.shape[0]] * 0.0
    direct = jnp.zeros((hit.t.shape[0], 3))
    if scene.n_lights > 0:
        lsel, lpmf, _ = _select_light(scene, u_sel)
        ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2,
                                           active=cfg.light_types)
        f_l, _ = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d),
                                    active=cfg.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, cfg.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                           ds.dist - 2 * cfg.ray_eps)
        pdf_l = jnp.where(ds.measure == 2, 1.0, ds.pdf) * lpmf
        ok = hit.valid & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        direct = jnp.where(ok[..., None],
                           f_l * Lrad / jnp.maximum(pdf_l, 1e-12)[..., None], 0.0)

    # fresh one-bounce indirect estimate at the hit points
    smp, u_b2 = smp.next_2d()
    smp, u_b1 = smp.next_1d()
    bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=cfg.bsdf_types)
    wi_world = it.frame.to_world(bs.wi)
    o2 = _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps)
    L_ind, _ = trace_radiance(scene, o2, wi_world, smp, cfg)
    fresh_li = bs.weight * L_ind

    # temporal blend into the cache (hit points keyed by pixel slot)
    new_p = jnp.where(hit.valid[..., None], it.p, psf.p)
    blend = jnp.where(
        psf.valid & hit.valid,
        1.0 - config.alpha,
        0.0,
    )[..., None]
    new_li = jnp.where(hit.valid[..., None],
                       psf.li * blend + fresh_li * (1.0 - blend), psf.li)
    new_psf = PSFBuffer(
        p=new_p, li=new_li,
        n=jnp.where(hit.valid[..., None], it.frame.n, psf.n),
        valid=psf.valid | hit.valid, frame=psf.frame + 1,
    )

    # spatial filtering: gather cached irradiance around each hit point
    grid = hashgrid.build_grid(
        new_psf.p, scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3,
        res=config.grid_res, valid=new_psf.valid,
    )
    idx, valid_n = hashgrid.query_sphere(grid, it.p, config.radius,
                                         config.max_gather)
    nb_li = new_psf.li[idx]
    nb_n = new_psf.n[idx]
    nb_p = new_psf.p[idx]
    d2 = jnp.sum((nb_p - it.p[:, None, :]) ** 2, -1)
    w = (
        valid_n & (d2 < config.radius ** 2)
        & (jnp.sum(nb_n * it.frame.n[:, None, :], -1) > 0.8)
    ).astype(jnp.float32)
    filt = jnp.sum(nb_li * w[..., None], 1) / jnp.maximum(
        jnp.sum(w, 1, keepdims=True), 1.0
    )

    L = direct + filt
    img = jnp.zeros((n_px, 3)).at[pid.astype(jnp.int32)].set(
        jnp.where(hit.valid[..., None], L, 0.0)
    )
    return img.reshape(height, width, 3), new_psf


def render_game(scene: Scene, psf: PSFBuffer | None, width: int, height: int,
                seed=0, config: GTConfig = GTConfig()):
    """GameTracer frame: returns (image, updated PSFBuffer)."""
    config = config._replace(base=specialize_config(scene, config.base))
    if psf is None:
        psf = PSFBuffer.create(width * height)
    return _game_impl(scene, psf, width, height, jnp.uint32(seed), config)
