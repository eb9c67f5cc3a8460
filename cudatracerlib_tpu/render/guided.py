"""Path guiding: per-cell incident-radiance direction distributions, learned
from photon flights, mixed into BSDF sampling with one-sample MIS.

The reference ships the *infrastructure* for this — on-line EM GMMs and
per-cell model grids (Kernel/ParametricModels/GaussianMixtureModel.h,
GridModelBuffer.h) — without a full guided integrator. Here the guiding
distribution is a per-spatial-cell direction histogram (models/discretized.py
machinery over a cylindrical equal-area direction map), which gives *exact*
pdfs and CDF-inversion sampling under XLA's static shapes; the GMM variant
(models/gmm.py) remains available for fitting tasks. Training data comes from
the photon pass: each photon deposit contributes (cell(position),
direction-toward-light, luminance(power)) — i.e. the histogram estimates the
incident radiance distribution per cell, and the guided sampler importance-
samples it. One-sample MIS with the BSDF keeps the estimator unbiased for any
histogram content.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math import montecarlo as mc
from ..math.vecmath import PI, dot
from ..models.grid import ModelGrid, cell_of_position, make_model_grid
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction
from ..image import film as film_mod
from .path_tracer import (PTConfig, _light_select_pmf, _offset_ray,
                          _select_light, specialize_config)
from .ppm import trace_photons

N_DIR_BINS = 8  # per axis: 8x8 = 64 direction bins per cell


class Guiding(NamedTuple):
    grid: ModelGrid
    hist: jnp.ndarray   # (C, N_DIR_BINS^2) accumulated luminance per dir bin


def make_guiding(scene: Scene, res: int = 8) -> Guiding:
    grid = make_model_grid(scene.bvh.world_min - 1e-3,
                           scene.bvh.world_max + 1e-3, res)
    return Guiding(
        grid=grid,
        hist=jnp.zeros((res ** 3, N_DIR_BINS * N_DIR_BINS), jnp.float32),
    )


def _dir_to_uv(d):
    """Cylindrical equal-area map: u = phi/2pi, v = (1+z)/2 — area-preserving,
    so pdf_dir = pdf_uv / (4 pi)."""
    u = jnp.arctan2(d[..., 1], d[..., 0]) / (2.0 * PI) + 0.5
    v = (d[..., 2] + 1.0) * 0.5
    return jnp.stack([jnp.clip(u, 0.0, 1.0 - 1e-6),
                      jnp.clip(v, 0.0, 1.0 - 1e-6)], -1)


def _uv_to_dir(uv):
    phi = (uv[..., 0] - 0.5) * (2.0 * PI)
    z = uv[..., 1] * 2.0 - 1.0
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], -1)


def _bin_of(uv):
    b = (uv * N_DIR_BINS).astype(jnp.int32)
    b = jnp.clip(b, 0, N_DIR_BINS - 1)
    return b[..., 1] * N_DIR_BINS + b[..., 0]


def train_guiding(scene: Scene, guiding: Guiding, n_photons: int, seed,
                  config: PTConfig) -> Guiding:
    """One training batch: photon pass -> histogram deposits."""
    config = specialize_config(scene, config)
    return _train_impl(scene, guiding, n_photons, jnp.uint32(seed), config)


@partial(jax.jit, static_argnames=("n_photons", "config"))
def _train_impl(scene: Scene, guiding: Guiding, n_photons: int, seed,
                config: PTConfig) -> Guiding:
    pm = trace_photons(scene, n_photons, seed, config)
    lum = jnp.sum(pm.power * jnp.asarray([0.212671, 0.715160, 0.072169]), -1)
    cell = cell_of_position(guiding.grid, pm.p)
    dbin = _bin_of(_dir_to_uv(pm.wi))
    flat = cell * (N_DIR_BINS * N_DIR_BINS) + dbin
    C = guiding.hist.shape[0]
    upd = jax.ops.segment_sum(jnp.where(pm.valid, lum, 0.0), flat,
                              num_segments=C * N_DIR_BINS * N_DIR_BINS)
    return guiding._replace(hist=guiding.hist + upd.reshape(guiding.hist.shape))


def _guided_sample(guiding: Guiding, p, u_sel, u2):
    """Sample a direction from the cell histogram. Returns (dir, pdf_sa,
    usable) — usable=False where the cell holds no data."""
    cell = cell_of_position(guiding.grid, p)
    h = guiding.hist[cell]                                    # (B, NB^2)
    tot = jnp.sum(h, -1, keepdims=True)
    usable = tot[..., 0] > 0
    cdf = jnp.cumsum(h / jnp.maximum(tot, 1e-12), axis=-1)
    b = jnp.sum((cdf < u_sel[..., None]).astype(jnp.int32), -1)
    b = jnp.minimum(b, h.shape[-1] - 1)
    p_bin = jnp.take_along_axis(h, b[..., None], -1)[..., 0] / jnp.maximum(
        tot[..., 0], 1e-12)
    bu = (b % N_DIR_BINS).astype(jnp.float32)
    bv = (b // N_DIR_BINS).astype(jnp.float32)
    uv = jnp.stack([(bu + u2[..., 0]) / N_DIR_BINS,
                    (bv + u2[..., 1]) / N_DIR_BINS], -1)
    d = _uv_to_dir(uv)
    # pdf over uv = p_bin * NB^2; over solid angle: / 4pi
    pdf_sa = p_bin * (N_DIR_BINS * N_DIR_BINS) / (4.0 * PI)
    return d, pdf_sa, usable


def _guided_pdf(guiding: Guiding, p, d):
    cell = cell_of_position(guiding.grid, p)
    h = guiding.hist[cell]
    tot = jnp.maximum(jnp.sum(h, -1), 1e-12)
    b = _bin_of(_dir_to_uv(d))
    p_bin = jnp.take_along_axis(h, b[..., None], -1)[..., 0] / tot
    return p_bin * (N_DIR_BINS * N_DIR_BINS) / (4.0 * PI)


class _GCarry(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    L: jnp.ndarray
    active: jnp.ndarray
    sampler: Sampler
    prev_pdf: jnp.ndarray
    prev_delta: jnp.ndarray


def trace_radiance_guided(scene: Scene, guiding: Guiding, o, d,
                          sampler: Sampler, config: PTConfig,
                          guide_prob: float = 0.5):
    """Guided unidirectional PT (NEE + MIS). Structure mirrors
    path_tracer.trace_radiance; the BSDF-sampling step becomes a one-sample
    MIS mixture of BSDF sampling and the per-cell guiding distribution:
    pdf_mix = a * pdf_guide + (1 - a) * pdf_bsdf evaluated for the CHOSEN
    direction, which is unbiased for any histogram content."""
    B = o.shape[0]
    init = _GCarry(
        o=o, d=d,
        throughput=jnp.ones((B, 3), jnp.float32),
        L=jnp.zeros((B, 3), jnp.float32),
        active=jnp.ones((B,), bool),
        sampler=sampler,
        prev_pdf=jnp.zeros((B,), jnp.float32),
        prev_delta=jnp.ones((B,), bool),
    )

    def bounce(carry: _GCarry, depth):
        s = carry.sampler
        hit = scene_mod.scene_intersect(scene, carry.o, carry.d)
        it, mp = scene_mod.hit_shading(scene, carry.o, carry.d, hit,
                                       config.tex_types,
                                       flat=config.flat_shading)
        found = hit.valid & carry.active
        L = carry.L

        # environment + emission with MIS (same as the megakernel PT)
        has_env = scene.env_light_id >= 0
        env_ids = jnp.broadcast_to(jnp.maximum(scene.env_light_id, 0), (B,))
        env_L = lights_mod.eval_env(scene.lights, env_ids, carry.d)
        w_env = jnp.where(carry.prev_delta, 1.0,
                          mc.mis_weight(carry.prev_pdf,
                                        lights_mod.pdf_env_dir(scene.lights, env_ids, carry.d)
                                        * _light_select_pmf(scene, env_ids)))
        escaped = carry.active & ~hit.valid & has_env
        L = L + jnp.where(escaped[..., None],
                          carry.throughput * env_L * w_env[..., None], 0.0)

        wo_world = -carry.d
        mat_light = scene.materials.light_id[it.mat_id]
        emissive = found & (mat_light >= 0)
        lid = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, wo_world)
        pdf_hit = lights_mod.pdf_direct_area(scene.lights, lid, carry.o, it.p,
                                             it.n_geo) * _light_select_pmf(scene, lid)
        w_hit = jnp.where(carry.prev_delta, 1.0,
                          mc.mis_weight(carry.prev_pdf, pdf_hit))
        L = L + jnp.where(emissive[..., None],
                          carry.throughput * Le * w_hit[..., None], 0.0)

        wo_local = it.frame.to_local(wo_world)

        # NEE
        s, u_sel = s.next_1d()
        s, u_l2 = s.next_2d()
        if config.direct and scene.n_lights > 0:
            lsel, lpmf, _ = _select_light(scene, u_sel)
            lpmf = jax.lax.stop_gradient(lpmf)
            ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2,
                                                active=config.light_types)
            f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local,
                                              it.frame.to_local(ds.d),
                                              active=config.bsdf_types)
            # the forward pdf for MIS is the MIXTURE pdf the walk would use
            pdf_g_l = _guided_pdf(guiding, it.p, ds.d)
            smooth = bsdf_mod.is_smooth(mp)
            a = jnp.where(smooth, guide_prob, 0.0)
            pdf_fwd = a * pdf_g_l + (1.0 - a) * pdf_b_l
            sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
            blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, config.ray_eps,
                                               ds.dist - 2.0 * config.ray_eps)
            is_delta_l = ds.measure == 2
            pdf_l = jnp.where(is_delta_l, 1.0, jax.lax.stop_gradient(ds.pdf)) * lpmf
            w_nee = jnp.where(is_delta_l, 1.0, mc.mis_weight(pdf_l, pdf_fwd))
            ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
            L = L + jnp.where(
                ok[..., None],
                carry.throughput * f_l * Lrad
                * (w_nee / jnp.maximum(pdf_l, 1e-12))[..., None], 0.0)

        # ---- mixed BSDF/guided sampling ----
        s, u_b2 = s.next_2d()
        s, u_b1 = s.next_1d()
        s, u_pick = s.next_1d()
        s, u_g1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1,
                                  active=config.bsdf_types)
        wi_bsdf = it.frame.to_world(bs.wi)
        d_guided, pdf_g_s, usable = _guided_sample(guiding, it.p, u_g1, u_b2)
        smooth = bsdf_mod.is_smooth(mp)
        a = jnp.where(smooth & usable, guide_prob, 0.0)
        take_guided = u_pick < a

        wi_world = jnp.where(take_guided[..., None], d_guided, wi_bsdf)
        wi_local = it.frame.to_local(wi_world)
        # mixture pdf + BSDF value of the chosen direction
        f_chosen, pdf_b_chosen = bsdf_mod.eval_bsdf(mp, wo_local, wi_local,
                                                    active=config.bsdf_types)
        pdf_g_chosen = _guided_pdf(guiding, it.p, wi_world)
        pdf_mix = a * pdf_g_chosen + (1.0 - a) * pdf_b_chosen
        # delta lobes can't be guided or mixture-evaluated: keep the pure
        # BSDF-sample weight there (a = 0 on non-smooth surfaces)
        w_mix = f_chosen / jnp.maximum(pdf_mix, 1e-12)[..., None]
        use_mix = smooth
        step_w = jnp.where(use_mix[..., None], w_mix, bs.weight)
        step_pdf = jnp.where(use_mix, pdf_mix, bs.pdf)

        new_o = _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps)
        throughput = carry.throughput * step_w
        cont = found & (step_pdf > 0) & (jnp.max(jnp.abs(throughput), -1) > 0)

        s, u_rr = s.next_1d()
        p_cont = jax.lax.stop_gradient(mc.russian_roulette_prob(
            jnp.max(throughput, -1), depth, config.rr_start))
        cont = cont & (u_rr < p_cont)
        throughput = throughput / jnp.maximum(p_cont, 1e-6)[..., None]

        delta_now = ~use_mix & (bsdf_mod.is_delta(mp)
                                | ((bs.sampled_type & (16 | 32 | 64)) > 0))
        return _GCarry(
            o=jnp.where(cont[..., None], new_o, carry.o),
            d=jnp.where(cont[..., None], wi_world, carry.d),
            throughput=jnp.where(cont[..., None], throughput, carry.throughput),
            L=L, active=cont, sampler=s,
            prev_pdf=jnp.where(cont, step_pdf, carry.prev_pdf),
            prev_delta=jnp.where(cont, delta_now, carry.prev_delta),
        ), None

    final, _ = jax.lax.scan(bounce, init, jnp.arange(config.max_depth))
    return final.L, final.sampler


def render_guided(scene: Scene, guiding: Guiding, width: int, height: int,
                  spp: int, seed, config: PTConfig = PTConfig(),
                  guide_prob: float = 0.5):
    config = specialize_config(scene, config)
    return _render_guided_impl(scene, guiding, width, height, spp,
                               jnp.uint32(seed), config, guide_prob)


@partial(jax.jit, static_argnames=("width", "height", "spp", "config",
                                   "guide_prob"))
def _render_guided_impl(scene, guiding, width, height, spp, seed, config,
                        guide_prob):
    n_px = width * height
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    sampler = Sampler.create(seed, pixel_id, sample_idx)
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    sampler, jitter = sampler.next_2d()
    uv = jnp.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)
    L, _ = trace_radiance_guided(scene, guiding, o, d, sampler, config,
                                 guide_prob)
    film = film_mod.Film.create(height, width)
    film = film_mod.add_samples(film, pixel_id.astype(jnp.int32), L * w_cam)
    return film_mod.develop(film)
