"""Stochastic progressive photon mapping with per-pixel adaptive radii and
volumetric photon estimators.

Counterpart of the reference's full PPPMTracer feature set
(Integrators/ProgressivePhotonMapping/):
  * per-pixel adaptive gather statistics — the reference's ``k_AdaptiveStruct``
    (PPPMTracer.h:61-146): every pixel carries its own radius^2, accumulated
    photon count N and unnormalized flux tau, updated with the SPPM ratio
    N' = N + alpha*M, r'^2 = r^2 (N + alpha M)/(N + M), tau' = (tau+phi) r'^2/r^2;
  * kNN-style initial radii (PhotonMapHelper.h:23-41 density->radius): the
    first pass measures the local photon density and sets
    r_px = r0 * sqrt(k_target / M_0), clamped — the translation of the
    reference's kNN radius scheme (radius scheme kNN vs Constant);
  * volumetric estimators (VolEstimators/PointStorage.h, BeamGrid.h):
    volume photons deposited at medium scatter events; the camera ray
    integrates in-scattered radiance either by fixed-step ray marching with a
    3-D kernel (PointStorage) or by a camera-beam x photon-point 2-D kernel
    estimate (BeamGrid / "beam radiance estimate") — Design: both are
    fixed-shape hash-grid gathers, no linked lists, no atomics.

Deposit convention: volume photons carry their power *after* the
sigma_s/sigma_t albedo factor of the scatter event, so the beam estimate is
L = sum_k K2(d_perp) * Tr(0->t_k) * p(w_k, w) * Phi_k with no extra sigma_s
(Jarosz et al., beam radiance estimate; derivation in the module tests).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import hashgrid, traversal
from ..image import film as film_mod
from ..math.vecmath import PI
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import media as media_mod
from ..scene import phase as phase_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import PTConfig, _offset_ray, _select_light, specialize_config
from .ppm import PPM_ALPHA, PhotonMap

VOL_NONE = 0
VOL_POINT = 1     # ray marching + 3-D kernel (VolEstimators/PointStorage.h)
VOL_BEAM = 2      # camera-beam x photon-point, 2-D kernel (VolEstimators/BeamGrid.h)
VOL_BEAMBEAM = 3  # photon-beam x camera-beam, 1-D kernel (VolEstimators/BeamBeamGrid.h)


class VolPhotonMap(NamedTuple):
    p: jnp.ndarray        # (P, 3) scatter positions
    power: jnp.ndarray    # (P, 3) post-albedo flux / n_emitted
    wi: jnp.ndarray       # (P, 3) direction toward the light path origin
    valid: jnp.ndarray    # (P,)


class PhotonBeams(NamedTuple):
    """Photon flight segments through media (BeamBeamGrid storage): each
    medium-crossing scan step of the photon walk emits one beam carrying the
    power *entering* the segment (pre-collision)."""
    o: jnp.ndarray        # (P, 3) segment origin
    d: jnp.ndarray        # (P, 3) unit direction
    t: jnp.ndarray        # (P,) segment length
    power: jnp.ndarray    # (P, 3) entering flux / n_emitted
    valid: jnp.ndarray    # (P,)


class SPPMConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=6, rr_start=2)
    n_photons: int = 1 << 17
    radius0: float = 0.07
    max_gather: int = 128
    grid_res: int = 64
    # kNN radius scheme (reference RadiusScheme kNN): target photon count per
    # gather disk; 0 disables (constant initial radius, scheme Constant)
    knn_target: int = 0
    vol_estimator: int = VOL_NONE
    vol_radius0: float = 0.1
    vol_steps: int = 24          # ray-march steps for VOL_POINT
    vol_max_gather: int = 32
    beam_samples: int = 16       # grid sample points per photon beam
    # one-bounce final gathering at the gather vertex (EyePass.cu:16-41)
    final_gather: bool = False


class SPPMState(NamedTuple):
    """Per-pixel adaptive gather state (k_AdaptiveStruct translation)."""
    r2: jnp.ndarray       # (B,) gather radius^2
    n_acc: jnp.ndarray    # (B,) accumulated photon count (SPPM ratio)
    tau: jnp.ndarray      # (B, 3) accumulated unnormalized flux
    l_other: jnp.ndarray  # (B, 3) accumulated direct+emission+volumetric
    n_passes: jnp.ndarray # () int32


def sppm_init(n_pixels_samples: int, radius0: float) -> SPPMState:
    B = n_pixels_samples
    return SPPMState(
        r2=jnp.full((B,), radius0 * radius0, jnp.float32),
        n_acc=jnp.zeros((B,), jnp.float32),
        tau=jnp.zeros((B, 3), jnp.float32),
        l_other=jnp.zeros((B, 3), jnp.float32),
        n_passes=jnp.zeros((), jnp.int32),
    )


def trace_photons_vol(scene: Scene, media: media_mod.Media, n_photons: int,
                      seed, config: PTConfig, with_beams: bool = False):
    """Media-aware photon pass: emitter walk through surfaces *and* volumes.

    Extends ppm.trace_photons (ParticleProcess equivalent) with medium events
    (reference PPPMTracer_PhotonPass.cu:30-90 stores into the volumetric
    estimator at every medium interaction). Returns (surface PhotonMap,
    VolPhotonMap[, PhotonBeams if with_beams])."""
    B = n_photons
    smp = Sampler.create(seed, jnp.arange(B, dtype=jnp.uint32), jnp.uint32(0xF00D))
    smp, u_sel = smp.next_1d()
    lsel, lpmf, _ = _select_light(scene, u_sel)
    smp, u_pos = smp.next_2d()
    smp, u_dir = smp.next_2d()
    o, d, w = lights_mod.sample_emitter_ray(scene.lights, lsel, u_pos, u_dir)
    w = w / jnp.maximum(jax.lax.stop_gradient(lpmf), 1e-9)[..., None]

    class _C(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        w: jnp.ndarray
        alive: jnp.ndarray
        smp: Sampler

    init = _C(o=o, d=d, w=w, alive=jnp.ones((B,), bool), smp=smp)

    def bounce(c: _C, depth):
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       config.tex_types)
        t_surf = jnp.where(hit.valid, hit.t, 1e8)

        s = c.smp
        s, t_m, scat, w_med, vid, p_scat, _ = media_mod.sample_distance(
            media, c.o, c.d, config.ray_eps, t_surf, s
        )
        w_here = c.w * jnp.where(c.alive[..., None], w_med, 1.0)
        medium_event = c.alive & scat
        found = hit.valid & c.alive & ~scat

        # surface deposit (direct photons excluded: eye pass does NEE)
        store_s = found & bsdf_mod.is_smooth(mp) & (depth > 0)
        surf_photon = (
            it.p,
            jnp.where(store_s[..., None], w_here, 0.0),
            -c.d,
            it.frame.n,
            store_s,
        )
        # volume deposit: post-albedo power (see module docstring)
        vol_photon = (
            p_scat,
            jnp.where(medium_event[..., None], w_here, 0.0),
            -c.d,
            medium_event,
        )
        # photon beam = this flight segment, carrying the ENTERING power
        # (BeamBeamGrid storage; the estimator applies sigma_s at the virtual
        # scatter point, so the beam power is pre-collision)
        t_end = jnp.where(scat, t_m, jnp.minimum(t_surf, 1e4))
        beam_valid = c.alive & media_mod.segment_in_media(
            media, c.o, c.d, config.ray_eps, t_end)
        beam = (c.o, c.d, t_end, jnp.where(beam_valid[..., None], c.w, 0.0),
                beam_valid)

        # continue: phase sample at medium events, BSDF sample at surfaces
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        wo_local = it.frame.to_local(-c.d)
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=config.bsdf_types)
        wi_surf = it.frame.to_world(bs.wi)
        ps = phase_mod.sample_phase(media.phase_type[vid], media.phase_g[vid],
                                    -c.d, u2)
        new_d = jnp.where(medium_event[..., None], ps.wi, wi_surf)
        new_o = jnp.where(
            medium_event[..., None], p_scat,
            _offset_ray(it.p, it.n_geo, wi_surf, config.ray_eps),
        )
        step_w = jnp.where(medium_event[..., None], ps.weight[..., None], bs.weight)
        new_pdf = jnp.where(medium_event, ps.pdf, bs.pdf)
        w_new = w_here * step_w

        s, u_rr = s.next_1d()
        p_cont = jax.lax.stop_gradient(
            jnp.minimum(jnp.max(jnp.abs(w_new), axis=-1), 0.9)
        )
        cont = (found | medium_event) & (new_pdf > 0) & (u_rr < p_cont)
        w_new = w_new / jnp.maximum(p_cont, 1e-6)[..., None]
        new = _C(
            o=jnp.where(cont[..., None], new_o, c.o),
            d=jnp.where(cont[..., None], new_d, c.d),
            w=jnp.where(cont[..., None], w_new, c.w),
            alive=cont,
            smp=s,
        )
        return new, (surf_photon, vol_photon, beam)

    _, (surf, vol, beams) = jax.lax.scan(bounce, init,
                                         jnp.arange(config.max_depth))
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    sp, spow, swi, sn, sval = surf
    vp, vpow, vwi, vval = vol
    out = (
        PhotonMap(p=flat(sp), power=flat(spow) / n_photons, wi=flat(swi),
                  n=flat(sn), valid=flat(sval), caustic=flat(sval) & False),
        VolPhotonMap(p=flat(vp), power=flat(vpow) / n_photons, wi=flat(vwi),
                     valid=flat(vval)),
    )
    if not with_beams:
        return out
    bo, bd, bt, bpow, bval = beams
    return out + (PhotonBeams(o=flat(bo), d=flat(bd), t=flat(bt),
                              power=flat(bpow) / n_photons, valid=flat(bval)),)


def _finish_beam(media, o, d, t_mid, ph_wi, ph_pow, use, k2, B, n_steps,
                 qw=None):
    # transmittance Tr(0 -> t_mid) per step (cheap: closed form / quadrature
    # per segment via media.transmittance on each prefix is O(S^2); instead
    # integrate incrementally with the same fixed-step quadrature)
    tr_steps = _prefix_transmittance(media, o, d, t_mid)    # (B, S, 3)
    # phase toward the camera at each photon
    vid0 = jnp.zeros((B,), jnp.int32)  # single-medium approximation for phase params
    pt = media.phase_type[vid0][:, None, None]
    pg = media.phase_g[vid0][:, None, None]
    wo = jnp.broadcast_to(-d[:, None, None, :], ph_wi.shape)
    ph = phase_mod.eval_phase(pt, pg, ph_wi, wo)
    contrib = jnp.where(use[..., None], ph_pow * (ph * k2)[..., None], 0.0)
    per_step = jnp.sum(contrib, axis=2)                     # (B, S, 3)
    if qw is not None:
        per_step = per_step * qw[..., None]
    return jnp.sum(per_step * tr_steps, axis=1)             # (B, 3)


def _prefix_transmittance(media: media_mod.Media, o, d, t_mid):
    """Tr(0 -> t_mid[s]) for all steps at once: cumulative optical depth via
    per-step segment taus (midpoint rule, matches media.tau_segment)."""
    B, S = t_mid.shape
    dt = jnp.diff(t_mid, axis=1, prepend=jnp.zeros((B, 1)))
    pts = o[:, None, :] + d[:, None, :] * t_mid[..., None]
    tau_tot = jnp.zeros((B, S, 3))
    for v in range(media_mod.MAX_VOLUMES):
        vid = jnp.full((B, S), v, jnp.int32)
        dens = media_mod.density_at(media, vid, pts)
        st = (media.sigma_a[v] + media.sigma_s[v])[None, None, :]
        tau_tot = tau_tot + st * dens[..., None] * dt[..., None]
    return jnp.exp(-jnp.cumsum(tau_tot, axis=1))


def _beambeam_estimate(media: media_mod.Media, grid: hashgrid.HashGrid,
                       beams: PhotonBeams, samples_per_beam: int,
                       o, d, t_max, radius, max_gather: int, n_steps: int):
    """Photon-beam x camera-beam estimate with a 1-D kernel on the line-line
    distance (VolEstimators/BeamBeamGrid.h; Jarosz et al. photon beams):

      L = sum_beams K1(dist) p(theta) Phi Tr_cam(t_c) Tr_beam(t_b)
          sigma_s(x) / sin(theta)

    Grid storage: each beam is sampled at `samples_per_beam` points whose
    cell ids index the CSR grid; payload = beam_id * S + sample_k, deduped at
    query time by requiring the closest-approach parameter t_b to fall in
    sample k's sub-segment and t_c in the camera step's cell. Tr_beam uses the
    locally-constant sigma_t(x) approximation (exact for homogeneous media)."""
    B = o.shape[0]
    SB = samples_per_beam
    t_cam = jnp.minimum(t_max, 1e4)
    dt = t_cam / n_steps
    t_mid = (jnp.arange(n_steps, dtype=jnp.float32)[None, :] + 0.5) * dt[:, None]
    centers = o[:, None, :] + d[:, None, :] * t_mid[..., None]
    idx, vmask, qw = hashgrid.query_sphere_sampled(grid, centers.reshape(-1, 3),
                                                   max_gather)
    K = max_gather
    idx = idx.reshape(B, n_steps, K)
    vmask = vmask.reshape(B, n_steps, K)
    qw = qw.reshape(B, n_steps)        # subsample reweight (unbiased sums)
    bid = idx // SB
    k_smp = idx % SB

    b_o = beams.o[bid]                                   # (B, S, K, 3)
    b_d = beams.d[bid]
    b_t = beams.t[bid]
    b_pow = beams.power[bid]
    ok = vmask & beams.valid[bid]

    # closest approach between camera line (o, d) and beam line (b_o, b_d)
    w0 = o[:, None, None, :] - b_o
    b_dot = jnp.einsum("bc,bskc->bsk", d, b_d,
                       precision=jax.lax.Precision.HIGHEST)
    denom = 1.0 - b_dot * b_dot
    d_w0 = jnp.einsum("bc,bskc->bsk", d, w0,
                      precision=jax.lax.Precision.HIGHEST)
    e_w0 = jnp.sum(b_d * w0, axis=-1)
    safe = denom > 1e-6
    inv = 1.0 / jnp.maximum(denom, 1e-6)
    t_c = (b_dot * e_w0 - d_w0) * inv
    t_b = (e_w0 - b_dot * d_w0) * inv
    diff = w0 + d[:, None, None, :] * t_c[..., None] - b_d * t_b[..., None]
    dist = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))

    # dedup: camera cell owns t_c, beam sample k owns t_b
    cell_lo = t_mid[..., None] - 0.5 * dt[:, None, None]
    cell_hi = t_mid[..., None] + 0.5 * dt[:, None, None]
    in_cam_cell = (t_c >= cell_lo) & (t_c < cell_hi)
    seg = jnp.maximum(b_t / SB, 1e-9)
    in_k = (t_b >= k_smp * seg) & (t_b < (k_smp + 1) * seg)
    use = ok & safe & in_cam_cell & in_k & (dist < radius) \
        & (t_c > 0) & (t_c < t_cam[:, None, None]) \
        & (t_b > 0) & (t_b < b_t)

    x = b_o + b_d * t_b[..., None]
    sig_s, sig_t = media_mod.sigma_at(media, x)
    # 1-D Epanechnikov kernel on the signed distance in [-r, r]
    t2 = jnp.clip((dist / jnp.maximum(radius, 1e-9)) ** 2, 0.0, 1.0)
    k1 = 0.75 * (1.0 - t2) / jnp.maximum(radius, 1e-9)
    sin_th = jnp.sqrt(jnp.maximum(denom, 1e-6))
    vid0 = jnp.zeros((B,), jnp.int32)
    pt = media.phase_type[vid0][:, None, None]
    pg = media.phase_g[vid0][:, None, None]
    wo = jnp.broadcast_to(-d[:, None, None, :], b_d.shape)
    ph = phase_mod.eval_phase(pt, pg, -b_d, wo)
    tr_beam = jnp.exp(-sig_t * t_b[..., None])
    scal = (k1 * ph / sin_th)[..., None]
    contrib = jnp.where(use[..., None], b_pow * sig_s * tr_beam * scal, 0.0)
    per_step = jnp.sum(contrib, axis=2) * qw[..., None]  # (B, S, 3)
    tr_cam = _prefix_transmittance(media, o, d, t_mid)
    return jnp.sum(per_step * tr_cam, axis=1)


def _point_estimate(media: media_mod.Media, grid: hashgrid.HashGrid,
                    vpm: VolPhotonMap, o, d, t_max, radius, max_gather: int,
                    n_steps: int):
    """Ray-marching 3-D kernel estimate (PointStorage): L = sum_s dt Tr(t_s)
    sum_k K3(|x_k - x_s|) p(w_k, -d) Phi_k."""
    B = o.shape[0]
    t_max = jnp.minimum(t_max, 1e4)
    dt = t_max / n_steps
    t_mid = (jnp.arange(n_steps, dtype=jnp.float32)[None, :] + 0.5) * dt[:, None]
    centers = o[:, None, :] + d[:, None, :] * t_mid[..., None]
    cflat = centers.reshape(-1, 3)
    idx, vmask, qw = hashgrid.query_sphere_sampled(grid, cflat, max_gather)
    idx = idx.reshape(B, n_steps, max_gather)
    vmask = vmask.reshape(B, n_steps, max_gather)
    qw = qw.reshape(B, n_steps)
    ph_p = vpm.p[idx]
    ph_pow = vpm.power[idx]
    ph_wi = vpm.wi[idx]
    ok = vmask & vpm.valid[idx]
    d2 = jnp.sum((ph_p - centers[:, :, None, :]) ** 2, axis=-1)
    use = ok & (d2 < radius * radius)
    # 3-D Epanechnikov kernel: K3(t) = 15/(8 pi r^3) (1 - t^2)
    t2 = jnp.clip(d2 / jnp.maximum(radius * radius, 1e-12), 0.0, 1.0)
    k3 = 15.0 / (8.0 * PI * radius ** 3) * (1.0 - t2)
    k2w = jnp.where(use, k3, 0.0)
    vid0 = jnp.zeros((B,), jnp.int32)
    pt = media.phase_type[vid0][:, None, None]
    pg = media.phase_g[vid0][:, None, None]
    wo = jnp.broadcast_to(-d[:, None, None, :], ph_wi.shape)
    ph = phase_mod.eval_phase(pt, pg, ph_wi, wo)
    per_step = jnp.sum(ph_pow * (ph * k2w)[..., None], axis=2) * qw[..., None]
    tr_steps = _prefix_transmittance(media, o, d, t_mid)
    return jnp.sum(per_step * tr_steps * dt[:, None, None], axis=1)


def render_sppm_pass(scene: Scene, width: int, height: int, seed, state,
                     config: SPPMConfig = SPPMConfig(),
                     media: media_mod.Media | None = None):
    """One SPPM pass. Returns (image, new_state). `state=None` initializes.

    Drives `_sppm_impl` with a static grid resolution derived from the scene
    extent (cell size >= max gather radius, like render_ppm_pass)."""
    import numpy as np

    base = specialize_config(scene, config.base)
    extent = float(
        np.min(np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min))
    ) + 2e-3
    # 3^3-neighborhood correctness requires cell size >= query radius; keeping
    # the cells *at* the radius (not above) minimizes out-of-radius candidates
    # competing for the fixed max_gather slots (query_sphere caps candidates)
    q_r = 2.0 * config.radius0 if config.knn_target > 0 else config.radius0
    res = max(4, min(config.grid_res, int(extent / max(q_r, 1e-6))))
    if config.vol_estimator == VOL_BEAMBEAM:
        # beam x beam capture guarantee: a beam's owning sample point must land
        # within the 3^3 neighborhood of the camera cell that owns the closest
        # approach -> cell >= dt/2 + r + seg/2 with dt <= cell when
        # vol_steps >= diag/cell; conservatively cell = 2 r + seg_max
        diag = float(np.linalg.norm(
            np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min)))
        seg_max = diag / config.beam_samples
        c_bb = 2.0 * config.vol_radius0 + seg_max
        vres = max(4, min(config.grid_res, int(extent / max(c_bb, 1e-6))))
    else:
        vres = max(4, min(config.grid_res,
                          int(extent / max(config.vol_radius0, 1e-6))))
    config = config._replace(base=base, grid_res=res)
    if media is None:
        media = media_mod.Media.empty()
        config = config._replace(vol_estimator=VOL_NONE)
    if state is None:
        state = sppm_init(width * height, config.radius0)
    return _sppm_impl(scene, media, width, height, jnp.uint32(seed), state,
                      config, vres)


@partial(jax.jit, static_argnames=("width", "height", "config", "vol_grid_res"))
def _sppm_impl(scene: Scene, media: media_mod.Media, width: int, height: int,
               seed, state: SPPMState, config: SPPMConfig, vol_grid_res: int):
    cfg = config.base
    seed = seed ^ state.n_passes.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)

    # ---- photon pass ----
    beams = None
    if config.vol_estimator == VOL_BEAMBEAM:
        pm, vpm, beams = trace_photons_vol(scene, media, config.n_photons,
                                           seed, cfg, with_beams=True)
        SB = config.beam_samples
        ks = (jnp.arange(SB, dtype=jnp.float32) + 0.5) / SB
        pts = beams.o[:, None, :] + beams.d[:, None, :] \
            * (ks[None, :, None] * beams.t[:, None, None])
        pts = pts.reshape(-1, 3)
        pval = jnp.repeat(beams.valid, SB) \
            & jnp.all(pts >= scene.bvh.world_min - 1e-3, -1) \
            & jnp.all(pts <= scene.bvh.world_max + 1e-3, -1)
        vgrid = hashgrid.build_grid(
            pts, scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3,
            res=vol_grid_res, valid=pval,
        )
    elif config.vol_estimator != VOL_NONE:
        pm, vpm = trace_photons_vol(scene, media, config.n_photons, seed, cfg)
        vgrid = hashgrid.build_grid(
            vpm.p, scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3,
            res=vol_grid_res, valid=vpm.valid,
        )
    else:
        from .ppm import trace_photons
        pm = trace_photons(scene, config.n_photons, seed, cfg)
        vpm = vgrid = None
    grid = hashgrid.build_grid(
        pm.p, scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3,
        res=config.grid_res, valid=pm.valid,
    )

    # ---- eye pass: one sample per pixel per SPPM pass ----
    B = width * height
    pixel_id = jnp.arange(B, dtype=jnp.uint32)
    smp = Sampler.create(seed ^ jnp.uint32(0x5EED), pixel_id, jnp.uint32(0))
    smp, jitter = smp.next_2d()
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    uv = jnp.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)

    class _E(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        w: jnp.ndarray
        L: jnp.ndarray
        alive: jnp.ndarray
        gathered: jnp.ndarray
        gp: jnp.ndarray
        gn: jnp.ndarray
        gwo: jnp.ndarray
        gw: jnp.ndarray
        gprim: jnp.ndarray
        smp: Sampler

    init = _E(
        o=o, d=d, w=jnp.ones((B, 3)), L=jnp.zeros((B, 3)),
        alive=jnp.ones((B,), bool), gathered=jnp.zeros((B,), bool),
        gp=jnp.zeros((B, 3)), gn=jnp.zeros((B, 3)), gwo=jnp.zeros((B, 3)),
        gw=jnp.zeros((B, 3)), gprim=jnp.zeros((B,), jnp.int32), smp=smp,
    )

    has_media = config.vol_estimator != VOL_NONE

    def eye_bounce(c: _E, depth):
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       cfg.tex_types)
        found = hit.valid & c.alive

        # medium transmittance along this eye segment (reference eye pass
        # attenuates the camera walk through the aggregate volume)
        w_seg = c.w
        if has_media:
            tr_seg = media_mod.transmittance(
                media, c.o, c.d, cfg.ray_eps,
                jnp.where(hit.valid, hit.t, 1e4))
            w_seg = jnp.where(c.alive[..., None], c.w * tr_seg, c.w)

        mat_light = scene.materials.light_id[it.mat_id]
        lid = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -c.d)
        L = c.L + jnp.where((found & (mat_light >= 0))[..., None], w_seg * Le, 0.0)

        smooth = bsdf_mod.is_smooth(mp)
        new_gather = found & smooth & ~c.gathered

        s = c.smp
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        wo_local = it.frame.to_local(-c.d)
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        cont = found & ~smooth & (bs.pdf > 0)
        new = _E(
            o=jnp.where(cont[..., None], _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), c.o),
            d=jnp.where(cont[..., None], wi_world, c.d),
            w=jnp.where(cont[..., None], w_seg * bs.weight, c.w),
            L=L,
            alive=cont,
            gathered=c.gathered | new_gather,
            gp=jnp.where(new_gather[..., None], it.p, c.gp),
            gn=jnp.where(new_gather[..., None], it.frame.n, c.gn),
            gwo=jnp.where(new_gather[..., None], -c.d, c.gwo),
            gw=jnp.where(new_gather[..., None], w_seg, c.gw),
            gprim=jnp.where(new_gather, it.prim, c.gprim),
            smp=s,
        )
        return new, None

    final, _ = jax.lax.scan(eye_bounce, init, jnp.arange(5))

    # ---- volumetric in-scatter along the primary camera segment ----
    L_pass = final.L
    if config.vol_estimator != VOL_NONE:
        prim_hit = scene_mod.scene_intersect(scene, o, d)
        t_end = jnp.where(prim_hit.valid, prim_hit.t, 1e4)
        vol_r = jnp.float32(config.vol_radius0)
        if config.vol_estimator == VOL_BEAMBEAM:
            L_vol = _beambeam_estimate(media, vgrid, beams, config.beam_samples,
                                       o, d, t_end, vol_r,
                                       config.vol_max_gather, config.vol_steps)
        elif config.vol_estimator == VOL_BEAM:
            L_vol = _finish_beam_wrapper(media, vgrid, vpm, o, d, t_end, vol_r,
                                         config.vol_max_gather, config.vol_steps)
        else:
            L_vol = _point_estimate(media, vgrid, vpm, o, d, t_end, vol_r,
                                    config.vol_max_gather, config.vol_steps)
        L_pass = L_pass + L_vol

    # ---- direct lighting at the gather vertex ----
    g_hit = traversal.Hit(
        t=jnp.zeros((B,)), prim=final.gprim,
        bary=jnp.full((B, 2), 1.0 / 3.0), valid=final.gathered,
    )
    it_g = make_interaction(scene, final.gp, -final.gwo, g_hit)
    it_g = it_g._replace(p=final.gp)
    mp_g = gather_mat_params(scene, it_g, cfg.tex_types)
    s = final.smp

    def _direct_light(mp, frame, p, n_geo, wo_world, gathered, s):
        """One-sample NEE at a gather/final-gather vertex; returns (L, s)."""
        s, u_sel = s.next_1d()
        s, u_l2 = s.next_2d()
        if scene.n_lights == 0:
            return jnp.zeros(p.shape[:-1] + (3,)), s
        lsel, lpmf, _ = _select_light(scene, u_sel)
        lpmf = jax.lax.stop_gradient(lpmf)
        ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, p, u_l2,
                                            active=cfg.light_types)
        f_l, _ = bsdf_mod.eval_bsdf(
            mp, frame.to_local(wo_world), frame.to_local(ds.d),
            active=cfg.bsdf_types,
        )
        sh_o = _offset_ray(p, n_geo, ds.d, cfg.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                           ds.dist - 2 * cfg.ray_eps)
        tr_sh = 1.0
        if has_media:
            tr_sh = media_mod.transmittance(media, sh_o, ds.d, cfg.ray_eps,
                                            ds.dist - 2.0 * cfg.ray_eps)
        pdf_l = jnp.where(ds.measure == 2, 1.0, jax.lax.stop_gradient(ds.pdf)) * lpmf
        ok = gathered & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        return jnp.where(
            ok[..., None],
            f_l * Lrad * tr_sh / jnp.maximum(pdf_l, 1e-12)[..., None], 0.0), s

    L_nee, s = _direct_light(mp_g, it_g.frame, final.gp, final.gn, final.gwo,
                             final.gathered, s)
    L_pass = L_pass + final.gw * L_nee

    # query radius covers the largest radius any pixel may hold: kNN radii can
    # grow to 2*r0 (grid cell size is derived from 2*r0 in render_sppm_pass)
    q_radius = 2.0 * config.radius0 if config.knn_target > 0 else config.radius0

    # ---- final gathering (PPPMTracer_EyePass.cu:16-41): one BSDF sample from
    # the gather vertex, density estimate at the secondary hit instead ----
    if config.final_gather:
        s, u_fg2 = s.next_2d()
        s, u_fg1 = s.next_1d()
        bs_fg = bsdf_mod.sample_bsdf(mp_g, it_g.frame.to_local(final.gwo),
                                     u_fg2, u_fg1, active=cfg.bsdf_types)
        wi_fg = it_g.frame.to_world(bs_fg.wi)
        fg_o = _offset_ray(final.gp, final.gn, wi_fg, cfg.ray_eps)
        hit2 = scene_mod.scene_intersect(scene, fg_o, wi_fg)
        it2 = make_interaction(scene, fg_o, wi_fg, hit2)
        mp2 = gather_mat_params(scene, it2, cfg.tex_types)
        ok2 = final.gathered & hit2.valid & (bs_fg.pdf > 0) \
            & bsdf_mod.is_smooth(mp2)
        r0 = jnp.float32(config.radius0)
        d2f, okf, nokf, frawf, powf = _gather_parts(
            grid, pm, it2.frame, it2.p, it2.frame.n, -wi_fg, ok2, mp2,
            q_radius, config.max_gather, cfg)
        use_f = okf & (d2f < r0 * r0) & nokf
        # constant-kernel density estimate of outgoing radiance at the FG hit
        L_ind2 = jnp.sum(jnp.where(use_f[..., None], frawf * powf, 0.0),
                         axis=1) / (PI * r0 * r0)
        # direct light at the FG hit (the photon map excludes direct deposits)
        L_dir2, s = _direct_light(mp2, it2.frame, it2.p, it2.n_geo, -wi_fg,
                                  ok2, s)
        L_pass = L_pass + jnp.where(
            ok2[..., None],
            final.gw * bs_fg.weight * (L_ind2 + L_dir2), 0.0)

    # ---- adaptive surface gather (k_AdaptiveStruct update) ----
    if config.final_gather:
        # final gathering replaces the density estimate at the primary vertex;
        # the adaptive statistics stay frozen (no tau/radius updates)
        new_state = SPPMState(
            r2=state.r2, n_acc=state.n_acc, tau=state.tau,
            l_other=state.l_other + L_pass * w_cam,
            n_passes=state.n_passes + 1,
        )
        return sppm_develop(new_state, width, height), new_state

    d2, ph_ok, n_ok, f_raw, ph_pow = _gather_parts(
        grid, pm, it_g.frame, final.gp, final.gn, final.gwo, final.gathered,
        mp_g, q_radius, config.max_gather, cfg)
    in_r = d2 < state.r2[:, None]
    use = ph_ok & in_r & n_ok
    # unnormalized per-pass flux phi = sum f * Phi (constant kernel; the SPPM
    # ratio handles normalization via pi r^2 at develop time)
    phi = jnp.sum(jnp.where(use[..., None], f_raw * ph_pow, 0.0), axis=1)
    M = jnp.sum(use, axis=1).astype(jnp.float32)

    # kNN initial radius on the very first pass (density -> radius): the
    # count M0 within r0 estimates the local density; r_knn^2 = r0^2 * k/M0
    # makes the expected count k (clamped to [r0/8, 2 r0], the reference's
    # min/max radius clamps in k_AdaptiveStruct)
    if config.knn_target > 0:
        in_r0 = ph_ok & (d2 < config.radius0 ** 2) & n_ok
        M0 = jnp.sum(in_r0, axis=1).astype(jnp.float32)
        ratio = jnp.clip(config.knn_target / jnp.maximum(M0, 1.0), 1.0 / 64.0, 4.0)
        r2_knn = jnp.clip(state.r2 * ratio, (config.radius0 / 8.0) ** 2,
                          (2.0 * config.radius0) ** 2)
        first = state.n_passes == 0
        r2_cur = jnp.where(first & final.gathered, r2_knn, state.r2)
        # recompute the gather under the adapted radius
        in_r = d2 < r2_cur[:, None]
        use = ph_ok & in_r & n_ok
        phi = jnp.sum(jnp.where(use[..., None], f_raw * ph_pow, 0.0), axis=1)
        M = jnp.sum(use, axis=1).astype(jnp.float32)
    else:
        r2_cur = state.r2

    # SPPM update (Hachisuka & Jensen 2009; reference getCurrentRadius ratio)
    has = M > 0
    n_new = state.n_acc + PPM_ALPHA * M
    denom = jnp.maximum(state.n_acc + M, 1e-6)
    r2_new = jnp.where(has, r2_cur * n_new / denom, r2_cur)
    tau_new = jnp.where(
        has[..., None],
        (state.tau + final.gw * phi) * (r2_new / jnp.maximum(r2_cur, 1e-12))[..., None],
        state.tau,
    )

    new_state = SPPMState(
        r2=r2_new,
        n_acc=jnp.where(has, n_new, state.n_acc),
        tau=tau_new,
        l_other=state.l_other + L_pass * w_cam,
        n_passes=state.n_passes + 1,
    )

    img = sppm_develop(new_state, width, height)
    return img, new_state


def _gather_parts(grid, pm: PhotonMap, frame, gp, gn, gwo, gathered, mp,
                  q_radius, max_gather: int, cfg: PTConfig):
    """Shared photon-gather machinery: returns per-candidate (d2, validity,
    normal agreement, raw BSDF value toward each photon, photon power)."""
    idx, valid_n = hashgrid.query_sphere(grid, gp, q_radius, max_gather)
    ph_p = pm.p[idx]
    ph_pow = pm.power[idx]
    ph_wi = pm.wi[idx]
    ph_n = pm.n[idx]
    ph_ok = valid_n & pm.valid[idx] & gathered[:, None]
    d2 = jnp.sum((ph_p - gp[:, None, :]) ** 2, axis=-1)
    n_ok = jnp.sum(ph_n * gn[:, None, :], axis=-1) > 0.7

    wo_l = frame.to_local(gwo)[:, None, :]
    wi_l = jnp.stack(
        [
            jnp.einsum("bkc,bc->bk", ph_wi, frame.s,
                       precision=jax.lax.Precision.HIGHEST),
            jnp.einsum("bkc,bc->bk", ph_wi, frame.t,
                       precision=jax.lax.Precision.HIGHEST),
            jnp.einsum("bkc,bc->bk", ph_wi, frame.n,
                       precision=jax.lax.Precision.HIGHEST),
        ],
        axis=-1,
    )
    mp_b = jax.tree.map(lambda a: a[:, None] if a.ndim == 1 else a[:, None, :], mp)
    f_ph, _ = bsdf_mod.eval_bsdf(mp_b, jnp.broadcast_to(wo_l, wi_l.shape), wi_l,
                                 active=cfg.bsdf_types)
    cos_i = jnp.abs(wi_l[..., 2])
    f_raw = f_ph / jnp.maximum(cos_i, 1e-6)[..., None]
    return d2, ph_ok, n_ok, f_raw, ph_pow


def sppm_develop(state: SPPMState, width: int, height: int):
    """Combine accumulated flux and per-pass radiance into an image:
    L = tau / (n_passes * pi * r^2) + l_other / n_passes."""
    n = jnp.maximum(state.n_passes.astype(jnp.float32), 1.0)
    ind = state.tau / (n * PI * jnp.maximum(state.r2, 1e-12))[..., None]
    other = state.l_other / n
    return (ind + other).reshape(height, width, 3)


def _finish_beam_wrapper(media, vgrid, vpm, o, d, t_end, vol_r, max_gather, n_steps):
    """Beam estimate entry (kept separate so _beam_estimate stays testable)."""
    B = o.shape[0]
    t_max = jnp.minimum(t_end, 1e4)
    dt = t_max / n_steps
    t_mid = (jnp.arange(n_steps, dtype=jnp.float32)[None, :] + 0.5) * dt[:, None]
    centers = o[:, None, :] + d[:, None, :] * t_mid[..., None]
    cflat = centers.reshape(-1, 3)
    idx, vmask, qw = hashgrid.query_sphere_sampled(vgrid, cflat, max_gather)
    idx = idx.reshape(B, n_steps, max_gather)
    vmask = vmask.reshape(B, n_steps, max_gather)
    qw = qw.reshape(B, n_steps)
    ph_p = vpm.p[idx]
    ph_pow = vpm.power[idx]
    ph_wi = vpm.wi[idx]
    ok = vmask & vpm.valid[idx]
    rel = ph_p - o[:, None, None, :]
    t_proj = jnp.einsum("bskc,bc->bsk", rel, d,
                        precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.maximum(jnp.sum(rel * rel, axis=-1) - t_proj * t_proj, 0.0)
    cell_lo = t_mid[..., None] - 0.5 * dt[:, None, None]
    cell_hi = t_mid[..., None] + 0.5 * dt[:, None, None]
    in_cell = (t_proj >= cell_lo) & (t_proj < cell_hi)
    in_r = (d2 < vol_r * vol_r) & (t_proj > 0) & (t_proj < t_max[:, None, None])
    use = ok & in_cell & in_r
    t2 = jnp.clip(d2 / jnp.maximum(vol_r * vol_r, 1e-12), 0.0, 1.0)
    k2 = 2.0 * (1.0 - t2) / (PI * vol_r * vol_r)
    return _finish_beam(media, o, d, t_mid, ph_wi, ph_pow, use, k2, B, n_steps,
                        qw=qw)
