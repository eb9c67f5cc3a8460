"""Volumetric path tracer: surfaces + participating media.

Counterpart of the reference megakernel PathTracer's media handling
(Integrators/PathTracer.cu:26-54: V.sampleDistance + phase-function NEE) over
the media layer in scene/media.py. Structure mirrors path_tracer.py (lax.scan
over bounces) with a per-bounce medium event: distance sampling against the
union medium, phase NEE with transmittance-weighted shadow rays, HG phase
sampling — all differentiable (BASELINE config 4: transmittance gradients).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import traversal
from ..image import film as film_mod
from ..math import montecarlo as mc
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import media as media_mod
from ..scene import phase as phase_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import PTConfig, _light_select_pmf, _offset_ray, _select_light


class _VCarry(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    L: jnp.ndarray
    active: jnp.ndarray
    sampler: Sampler
    prev_pdf: jnp.ndarray
    prev_delta: jnp.ndarray
    n_rays: jnp.ndarray


def vol_bounce(scene: Scene, media: media_mod.Media, config: PTConfig,
               carry: _VCarry, depth) -> _VCarry:
        """One volumetric bounce (module-level so diagnostics can drive the
        loop one dispatch at a time; trace_radiance_vol scans over it)."""
        B = carry.o.shape[0]
        s = carry.sampler
        hit = scene_mod.scene_intersect(scene, carry.o, carry.d)
        it = make_interaction(scene, carry.o, carry.d, hit)
        found = hit.valid & carry.active
        t_surf = jnp.where(hit.valid, hit.t, 1e8)

        # ---- medium event along [eps, t_surf] ----
        s, t_m, scat, w_med, vid, p_scat, v_emit = media_mod.sample_distance(
            media, carry.o, carry.d, config.ray_eps, t_surf, s,
            modes=config.media_modes,
        )
        throughput = carry.throughput * jnp.where(carry.active[..., None], w_med, 1.0)
        medium_event = carry.active & scat

        # ---- escaped to env (no medium scatter, no surface) ----
        has_env = scene.env_light_id >= 0
        env_ids = jnp.broadcast_to(jnp.maximum(scene.env_light_id, 0), (B,))
        env_L = lights_mod.eval_env(scene.lights, env_ids, carry.d)
        escaped = carry.active & ~hit.valid & ~scat & has_env
        w_env = jnp.where(carry.prev_delta, 1.0,
                          mc.mis_weight(carry.prev_pdf,
                                        lights_mod.pdf_env_dir(scene.lights, env_ids, carry.d)
                                        * _light_select_pmf(scene, env_ids)))
        L = carry.L + jnp.where(escaped[..., None], throughput * env_L * w_env[..., None], 0.0)

        # ---- surface emission with MIS ----
        mat_light = scene.materials.light_id[it.mat_id]
        emissive = found & ~scat & (mat_light >= 0)
        lid_hit = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid_hit, it.n_geo, -carry.d)
        pdf_hit = lights_mod.pdf_direct_area(scene.lights, lid_hit, carry.o, it.p, it.n_geo) \
            * _light_select_pmf(scene, lid_hit)
        w_hit = jnp.where(carry.prev_delta, 1.0, mc.mis_weight(carry.prev_pdf, pdf_hit))
        L = L + jnp.where(emissive[..., None], throughput * Le * w_hit[..., None], 0.0)

        # ---- medium emission Lve (collision-sampled estimator; v_emit
        # already carries Tr * sigma_a * Le / pdf for this segment) ----
        L = L + jnp.where(medium_event[..., None],
                          carry.throughput * v_emit, 0.0)

        # ---- NEE from either the medium point or the surface point ----
        mp = gather_mat_params(scene, it)
        wo_world = -carry.d
        wo_local = it.frame.to_local(wo_world)
        nee_p = jnp.where(medium_event[..., None], p_scat, it.p)

        s, u_sel = s.next_1d()
        s, u_l2 = s.next_2d()
        if config.direct and scene.n_lights > 0:
            lsel, lpmf, _ = _select_light(scene, u_sel)
            lpmf = jax.lax.stop_gradient(lpmf)
            ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, nee_p, u_l2)
            # scattering function value toward the light
            f_surf, pdf_b_surf = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d))
            ph = phase_mod.eval_phase(media.phase_type[vid], media.phase_g[vid],
                                      wo_world, ds.d)
            pdf_ph = phase_mod.pdf_phase(media.phase_type[vid], media.phase_g[vid],
                                         wo_world, ds.d)
            f_val = jnp.where(medium_event[..., None], ph[..., None], f_surf)
            pdf_fwd = jnp.where(medium_event, pdf_ph, pdf_b_surf)

            sh_o = jnp.where(
                medium_event[..., None], nee_p,
                _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps),
            )
            blocked = scene_mod.scene_occluded(
                scene, sh_o, ds.d, config.ray_eps, ds.dist - 2.0 * config.ray_eps
            )
            tr_shadow = media_mod.transmittance(
                media, sh_o, ds.d, config.ray_eps,
                ds.dist - 2.0 * config.ray_eps, config.media_modes,
            )
            is_delta_l = ds.measure == 2
            pdf_l = jnp.where(is_delta_l, 1.0, jax.lax.stop_gradient(ds.pdf)) * lpmf
            w_nee = jnp.where(is_delta_l, 1.0, mc.mis_weight(pdf_l, pdf_fwd))
            contrib = throughput * f_val * Lrad * tr_shadow \
                * (w_nee / jnp.maximum(pdf_l, 1e-12))[..., None]
            ok = (found | medium_event) & ~blocked & (ds.pdf > 0) & (lpmf > 0)
            L = L + jnp.where(ok[..., None], contrib, 0.0)
            n_shadow = jnp.sum((found | medium_event).astype(jnp.float32))
        else:
            n_shadow = jnp.float32(0.0)

        # ---- continue the path: phase sample or BSDF sample ----
        s, u_p2 = s.next_2d()
        ps = phase_mod.sample_phase(media.phase_type[vid], media.phase_g[vid],
                                    wo_world, u_p2)
        s, u_b2 = s.next_2d()
        s, u_b1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1)
        wi_surf = it.frame.to_world(bs.wi)

        new_d = jnp.where(medium_event[..., None], ps.wi, wi_surf)
        new_o = jnp.where(
            medium_event[..., None],
            p_scat,
            _offset_ray(it.p, it.n_geo, wi_surf, config.ray_eps),
        )
        step_w = jnp.where(medium_event[..., None], ps.weight[..., None], bs.weight)
        new_pdf = jnp.where(medium_event, ps.pdf, bs.pdf)
        throughput = throughput * step_w
        cont = (found | medium_event) & (new_pdf > 0) & (
            jnp.max(jnp.abs(throughput), axis=-1) > 0
        )

        s, u_rr = s.next_1d()
        p_cont = jax.lax.stop_gradient(mc.russian_roulette_prob(
            jnp.max(throughput, axis=-1), depth, config.rr_start))
        cont = cont & (u_rr < p_cont)
        throughput = throughput / jnp.maximum(p_cont, 1e-6)[..., None]

        delta_now = ~medium_event & (
            bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0)
        )
        return _VCarry(
            o=jnp.where(cont[..., None], new_o, carry.o),
            d=jnp.where(cont[..., None], new_d, carry.d),
            throughput=jnp.where(cont[..., None], throughput, carry.throughput),
            L=L, active=cont, sampler=s,
            prev_pdf=jnp.where(cont, new_pdf, carry.prev_pdf),
            prev_delta=jnp.where(cont, delta_now, carry.prev_delta),
            n_rays=carry.n_rays
            + jnp.sum(carry.active.astype(jnp.float32)) + n_shadow,
        )


def init_vol_carry(o, d, sampler: Sampler) -> _VCarry:
    B = o.shape[0]
    return _VCarry(
        o=o, d=d,
        throughput=jnp.ones((B, 3), jnp.float32),
        L=jnp.zeros((B, 3), jnp.float32),
        active=jnp.ones((B,), bool),
        sampler=sampler,
        prev_pdf=jnp.zeros((B,), jnp.float32),
        prev_delta=jnp.ones((B,), bool),
        n_rays=jnp.zeros((), jnp.float32),
    )


def trace_radiance_vol(scene: Scene, media: media_mod.Media, o, d,
                       sampler: Sampler, config: PTConfig,
                       with_stats: bool = False):
    init = init_vol_carry(o, d, sampler)

    def bounce(carry: _VCarry, depth):
        return vol_bounce(scene, media, config, carry, depth), None

    body = jax.checkpoint(bounce, prevent_cse=False) if config.remat else bounce
    final, _ = jax.lax.scan(body, init, jnp.arange(config.max_depth))
    if with_stats:
        return final.L, final.sampler, final.n_rays
    return final.L, final.sampler


def _camera_batch(scene, width, height, spp, seed):
    """Camera-ray batch for one pass: (pixel_id, o, d, w_cam, sampler)."""
    n_px = width * height
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    sampler = Sampler.create(seed, pixel_id, sample_idx)
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    sampler, jitter = sampler.next_2d()
    film_uv = jnp.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    return pixel_id, o, d, w_cam, sampler


def _render_vol_body(scene, media, width, height, spp, seed, config,
                     with_stats):
    pixel_id, o, d, w_cam, sampler = _camera_batch(scene, width, height, spp,
                                                   seed)
    out = trace_radiance_vol(scene, media, o, d, sampler, config,
                             with_stats=with_stats)
    film = film_mod.Film.create(height, width)
    film = film_mod.add_samples(film, pixel_id.astype(jnp.int32), out[0] * w_cam)
    img = film_mod.develop(film)
    if with_stats:
        return img, out[2]
    return img


def specialize_media_config(media: media_mod.Media,
                            config: PTConfig) -> PTConfig:
    """Fill config.media_modes from a CONCRETE media pytree (host side)."""
    if config.media_modes is not None:
        return config
    return config._replace(media_modes=media_mod.static_modes(media))


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _render_vol_impl(scene: Scene, media, width: int, height: int,
                     spp: int, seed, config: PTConfig):
    return _render_vol_body(scene, media, width, height, spp, seed, config,
                            False)


def render_vol(scene: Scene, media: media_mod.Media, width: int, height: int,
               spp: int, seed, config: PTConfig = PTConfig()):
    config = specialize_media_config(media, config)
    return _render_vol_impl(scene, media, width, height, spp, seed, config)


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _render_vol_counted_impl(scene: Scene, media, width: int, height: int,
                             spp: int, seed, config: PTConfig):
    return _render_vol_body(scene, media, width, height, spp, seed, config,
                            True)


def render_vol_counted(scene: Scene, media: media_mod.Media, width: int,
                       height: int, spp: int, seed,
                       config: PTConfig = PTConfig()):
    """(image, rays actually traced) — see trace_radiance with_stats."""
    config = specialize_media_config(media, config)
    return _render_vol_counted_impl(scene, media, width, height, spp, seed,
                                    config)


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _vol_pass_setup(scene: Scene, media, width: int, height: int, spp: int,
                    seed, config: PTConfig):
    pixel_id, o, d, w_cam, sampler = _camera_batch(scene, width, height, spp,
                                                   seed)
    return pixel_id, w_cam, init_vol_carry(o, d, sampler)


@partial(jax.jit, static_argnames=("config",))
def _vol_step(scene: Scene, media, config: PTConfig, carry, depth):
    return vol_bounce(scene, media, config, carry, depth)


@partial(jax.jit, static_argnames=("width", "height"))
def _vol_accumulate(acc, pixel_id, w_cam, L, width: int, height: int):
    film = film_mod.Film.create(height, width)
    film = film_mod.add_samples(film, pixel_id.astype(jnp.int32), L * w_cam)
    return acc + film_mod.develop(film)


def render_vol_stepwise(scene: Scene, media: media_mod.Media, width: int,
                        height: int, spp: int, n_passes: int, seed,
                        config: PTConfig = PTConfig(),
                        with_stats: bool = False):
    """Host-stepped volumetric renderer: ONE jit dispatch per bounce.

    Numerics match render_vol* bitwise on CPU (same bounce body, same
    sampler stream); only the dispatch granularity differs: one small
    program per bounce instead of one fused program, at ~6 dispatches per
    pass of host overhead.
    """
    config = specialize_media_config(media, config)
    acc = jnp.zeros((height, width, 3), jnp.float32)
    n_rays = jnp.zeros((), jnp.float32)
    seed = jnp.uint32(seed)
    for p in range(n_passes):
        pixel_id, w_cam, carry = _vol_pass_setup(scene, media, width, height,
                                                 spp, seed + p, config)
        for depth in range(config.max_depth):
            carry = _vol_step(scene, media, config, carry, jnp.int32(depth))
        acc = _vol_accumulate(acc, pixel_id, w_cam, carry.L, width, height)
        n_rays = n_rays + carry.n_rays
    img = acc / n_passes
    if with_stats:
        return img, n_rays
    return img


def render_vol_progressive(scene: Scene, media: media_mod.Media, width: int,
                           height: int, spp: int, n_passes: int, seed,
                           config: PTConfig = PTConfig()):
    config = specialize_media_config(media, config)
    return _render_vol_progressive_impl(scene, media, width, height, spp,
                                        n_passes, seed, config)


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "n_passes", "config"))
def _render_vol_progressive_impl(scene: Scene, media, width: int,
                                 height: int, spp: int, n_passes: int, seed,
                                 config: PTConfig = PTConfig()):
    """N volumetric passes fused into one dispatch (cf. render_progressive)."""
    def one_pass(acc, i):
        img = _render_vol_body(scene, media, width, height, spp,
                               seed + i, config, False)
        return acc + img, None

    acc, _ = jax.lax.scan(
        one_pass, jnp.zeros((height, width, 3), jnp.float32),
        jnp.arange(n_passes, dtype=jnp.uint32),
    )
    return acc / n_passes
