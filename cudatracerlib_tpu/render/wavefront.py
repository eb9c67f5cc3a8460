"""Wavefront path tracer: persistent ray pool with refill-on-death.

Counterpart of the reference WavefrontPathTracer
(Integrators/PseudoRealtime/WavefrontPathTracer.{h,cu}) + DoubleRayBuffer
(Kernel/DoubleRayBuffer.h). Design translation (SURVEY.md §7):

  * the CUDA atomic ray queues become a fixed-capacity SoA pool;
  * "compaction" is refill-on-death: every iteration, lanes whose path
    terminated are immediately re-seeded with the next unconsumed camera ray
    (prefix-sum assignment, the deterministic analogue of the reference's
    atomic-counter fetch WavefrontPathTracer.cu:17-49);
  * one iteration = intersect(all lanes) -> shade -> NEE shadow ray ->
    bsdf sample -> RR, i.e. the reference's per-depth kernel chain
    (generate / intersect / iterate) fused into one jitted step;
  * the loop is a `lax.while_loop` that runs until the camera-ray supply is
    exhausted and every lane has died. Lane utilization stays ~100% versus the
    megakernel's exponential die-off, which is exactly the wavefront win once
    warp divergence is off the table.

This is the intended engine for BVH-bound scenes (BASELINE config 3).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..sampling.rng import Sampler
from ..scene import sensors
from ..scene.scene import Scene
from .path_tracer import PTConfig, specialize_config, surface_bounce


class _Pool(NamedTuple):
    o: jnp.ndarray           # (C, 3)
    d: jnp.ndarray           # (C, 3)
    throughput: jnp.ndarray  # (C, 3)
    L: jnp.ndarray           # (C, 3) accumulated radiance of the current path
    pixel: jnp.ndarray       # (C,) int32 flat pixel id (-1 = empty lane)
    depth: jnp.ndarray       # (C,) int32 current bounce index
    state: jnp.ndarray       # (C,) uint32 sampler state
    prev_pdf: jnp.ndarray    # (C,)
    prev_delta: jnp.ndarray  # (C,) bool
    eta_scale: jnp.ndarray   # (C,) accumulated eta^2 for RR
    path_len: jnp.ndarray    # (C,) accumulated path length (texture cones)
    alive: jnp.ndarray       # (C,) bool


class _WFState(NamedTuple):
    pool: _Pool
    next_ray: jnp.ndarray    # () int32 — next camera-ray id to hand out
    film_rgb: jnp.ndarray    # (H*W, 3)
    film_w: jnp.ndarray      # (H*W,)
    iters: jnp.ndarray       # ()
    n_rays: jnp.ndarray      # () float32 — rays actually traced
    n_nonfinite: jnp.ndarray  # () float32 — non-finite contributions seen
                              # BEFORE laundering (debug counter)


def _camera_ray(scene: Scene, ray_id, seed, width, height, spp,
                pixel_map=None):
    """Decode ray id -> (pixel, o, d, sampler_state). ray_id: (K,) int32.

    `pixel_map` ((total,) int32, optional): adaptive ray->pixel assignment
    from the variance block sampler (render/adaptive.py); None = uniform
    spp-major layout."""
    n_px = width * height
    if pixel_map is not None:
        pixel = pixel_map[ray_id].astype(jnp.uint32)
        sample = ray_id.astype(jnp.uint32)  # globally unique per ray
    else:
        pixel = (ray_id % n_px).astype(jnp.uint32)
        sample = (ray_id // n_px).astype(jnp.uint32)
    smp = Sampler.create(seed, pixel, sample)
    smp, jitter = smp.next_2d()
    px = (pixel % width).astype(jnp.float32)
    py = (pixel // width).astype(jnp.float32)
    uv = jnp.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    return pixel.astype(jnp.int32), o, d, smp.state


@partial(jax.jit, static_argnames=("width", "height", "spp", "config",
                                   "capacity", "with_stats"))
def _wavefront_impl(scene: Scene, width: int, height: int, spp: int, seed,
                    config: PTConfig, capacity: int,
                    with_stats: bool = False, pixel_map=None):
    C = capacity
    total = width * height * spp
    n_px = width * height
    cone = sensors.pixel_spread(scene.camera, width, height)

    empty_pool = _Pool(
        o=jnp.zeros((C, 3)), d=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (C, 3)),
        throughput=jnp.zeros((C, 3)), L=jnp.zeros((C, 3)),
        pixel=jnp.full((C,), -1, jnp.int32), depth=jnp.zeros((C,), jnp.int32),
        state=jnp.zeros((C,), jnp.uint32),
        prev_pdf=jnp.zeros((C,)), prev_delta=jnp.ones((C,), bool),
        eta_scale=jnp.ones((C,)), path_len=jnp.zeros((C,)),
        alive=jnp.zeros((C,), bool),
    )
    init = _WFState(
        pool=empty_pool,
        next_ray=jnp.int32(0),
        film_rgb=jnp.zeros((n_px, 3)),
        film_w=jnp.zeros((n_px,)),
        iters=jnp.int32(0),
        n_rays=jnp.float32(0.0),
        n_nonfinite=jnp.float32(0.0),
    )

    def cond(st: _WFState):
        return ((st.next_ray < total) | jnp.any(st.pool.alive)) & (
            st.iters < config.max_depth + total // C + 64
        )

    def step(st: _WFState) -> _WFState:
        p = st.pool

        # ---- refill dead lanes with fresh camera rays (prefix-sum assign,
        #      the deterministic DoubleRayBuffer insert) ----
        dead = ~p.alive
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        new_id = st.next_ray + rank
        take = dead & (new_id < total)
        # flush finished paths' radiance to the film before reuse
        flush = dead & (p.pixel >= 0)
        film_rgb = st.film_rgb.at[jnp.where(flush, p.pixel, n_px), :].add(
            jnp.where(flush[:, None], jnp.nan_to_num(p.L, nan=0.0, posinf=0.0, neginf=0.0), 0.0),
            mode="drop",
        )
        film_w = st.film_w.at[jnp.where(flush, p.pixel, n_px)].add(
            jnp.where(flush, 1.0, 0.0), mode="drop"
        )
        n_taken = jnp.sum(take.astype(jnp.int32))

        pix_n, o_n, d_n, state_n = _camera_ray(scene, jnp.maximum(new_id, 0), seed,
                                               width, height, spp, pixel_map)
        p = _Pool(
            o=jnp.where(take[:, None], o_n, p.o),
            d=jnp.where(take[:, None], d_n, p.d),
            throughput=jnp.where(take[:, None], 1.0, p.throughput),
            L=jnp.where(take[:, None], 0.0, p.L),
            pixel=jnp.where(take, pix_n, jnp.where(dead, -1, p.pixel)),
            depth=jnp.where(take, 0, p.depth),
            state=jnp.where(take, state_n, p.state),
            prev_pdf=jnp.where(take, 0.0, p.prev_pdf),
            prev_delta=jnp.where(take, True, p.prev_delta),
            eta_scale=jnp.where(take, 1.0, p.eta_scale),
            path_len=jnp.where(take, 0.0, p.path_len),
            alive=p.alive | take,
        )

        # ---- one shared shading bounce (identical to the megakernel) ----
        out = surface_bounce(
            scene, config,
            o=p.o, d=p.d, active=p.alive,
            throughput=p.throughput, prev_pdf=p.prev_pdf,
            prev_delta=p.prev_delta, eta_scale=p.eta_scale,
            path_len=p.path_len, sampler=Sampler(state=p.state),
            depth=p.depth, cone=cone,
        )
        cont = out.cont & (p.depth + 1 < config.max_depth)
        L = p.L + out.L_add

        # ---- tail drain (round 4): once the camera-ray supply is exhausted
        # the pool decays ~50%/iteration, and every near-empty tail
        # iteration still costs a FULL-width step (the round-4 profile
        # measured ~30 of 49 bigscene iterations in this tail). Apply extra
        # Russian roulette with 1/p compensation to the stragglers —
        # unbiased, and the tail collapses in a few iterations.
        throughput_out = out.throughput
        supply_out = (st.next_ray + n_taken) >= total
        low_occ = jnp.sum(cont.astype(jnp.int32)) < (C // 8)
        drain = supply_out & low_occ
        smp_out = out.sampler
        smp_out, u_drain = smp_out.next_1d()
        p_keep = jnp.where(drain, 0.25, 1.0)
        keep = u_drain < p_keep
        throughput_out = throughput_out / p_keep[..., None]
        cont = cont & keep

        new_pool = _Pool(
            o=jnp.where(cont[:, None], out.o, p.o),
            d=jnp.where(cont[:, None], out.d, p.d),
            throughput=jnp.where(cont[:, None], throughput_out, p.throughput),
            L=L,
            pixel=p.pixel,
            depth=p.depth + 1,
            state=smp_out.state,
            prev_pdf=jnp.where(cont, out.bs_pdf, p.prev_pdf),
            prev_delta=jnp.where(cont, out.delta_now, p.prev_delta),
            eta_scale=jnp.where(cont, out.eta_scale, p.eta_scale),
            path_len=jnp.where(cont, out.path_len, p.path_len),
            alive=cont,
        )
        return _WFState(
            pool=new_pool,
            next_ray=st.next_ray + n_taken,
            film_rgb=film_rgb,
            film_w=film_w,
            iters=st.iters + 1,
            n_rays=st.n_rays + out.n_rays,
            n_nonfinite=st.n_nonfinite + out.n_nonfinite,
        )

    final = jax.lax.while_loop(cond, step, init)
    # flush the lanes that are still carrying radiance (all dead by now)
    p = final.pool
    flush = p.pixel >= 0
    film_rgb = final.film_rgb.at[jnp.where(flush, p.pixel, n_px), :].add(
        jnp.where(flush[:, None], jnp.nan_to_num(p.L, nan=0.0, posinf=0.0, neginf=0.0), 0.0),
        mode="drop")
    film_w = final.film_w.at[jnp.where(flush, p.pixel, n_px)].add(
        jnp.where(flush, 1.0, 0.0), mode="drop")
    img = film_rgb / jnp.maximum(film_w, 1e-8)[:, None]
    img = img.reshape(height, width, 3)
    if with_stats:
        return img, final.n_rays, final.n_nonfinite, final.iters
    return img


def render_wavefront(scene: Scene, width: int, height: int, spp: int, seed,
                     config: PTConfig = PTConfig(), capacity: int | None = None):
    """Wavefront render; capacity defaults to one full spp wave."""
    config = specialize_config(scene, config)
    if capacity is None:
        capacity = min(width * height * spp, 1 << 20)
    return _wavefront_impl(scene, width, height, spp, jnp.uint32(seed), config,
                           capacity)


def render_wavefront_counted(scene: Scene, width: int, height: int, spp: int,
                             seed, config: PTConfig = PTConfig(),
                             capacity: int | None = None):
    """(image, rays actually traced): alive pool lanes + NEE shadow rays per
    iteration (reference enqueued-ray counter, Kernel/TraceHelper.h:52-53)."""
    config = specialize_config(scene, config)
    if capacity is None:
        capacity = min(width * height * spp, 1 << 20)
    img, n_rays, _, _ = _wavefront_impl(scene, width, height, spp,
                                        jnp.uint32(seed), config, capacity,
                                        with_stats=True)
    return img, n_rays


def render_wavefront_with_counters(scene: Scene, width: int, height: int,
                                   spp: int, seed,
                                   config: PTConfig = PTConfig(),
                                   capacity: int | None = None):
    """Wavefront render + debug counters (see render_with_counters)."""
    config = specialize_config(scene, config)
    if capacity is None:
        capacity = min(width * height * spp, 1 << 20)
    img, n_rays, n_bad, n_iters = _wavefront_impl(scene, width, height, spp,
                                                  jnp.uint32(seed), config,
                                                  capacity, with_stats=True)
    return img, {"n_rays": n_rays, "n_nonfinite": n_bad,
                 "n_iters": n_iters}
