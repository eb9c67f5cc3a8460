"""Progressive photon mapping (PPM/PPPM).

Counterpart of reference ``Integrators/ProgressivePhotonMapping/``:
  * photon pass = generic particle process (Kernel/ParticleProcess.h:37):
    emitter ray sampling -> bounce walk -> store a photon at every surface
    interaction (PPPMTracer_PhotonPass.cu:30-90). Translation: photons go
    to fixed (max_depth, N) SoA arrays (masked), then into a *sorted* hash
    grid (accel/hashgrid.py) instead of atomic linked lists;
  * eye pass = camera walk to the first diffuse vertex through specular
    chains, then a kernel density estimate over the photon grid
    (PPPMTracer_EyePass.cu:42-110, SurfEstimators/EntryEstimator.h:25-59);
  * progressive radius shrink r_{n+1}^2 = r_n^2 (n+alpha)/(n+1)
    (PhotonMapHelper.h getCurrentRadius, alpha=0.75).

Direct lighting + emission come from the eye path (NEE at the gather vertex),
indirect from the photon estimate — the reference's split.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import hashgrid, traversal
from ..image import film as film_mod
from ..math import montecarlo as mc
from ..math.vecmath import PI, dot
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import PTConfig, _light_select_pmf, _offset_ray, _select_light, specialize_config

PPM_ALPHA = 0.75  # reference PhotonMapHelper.h ALPHA


class PhotonMap(NamedTuple):
    p: jnp.ndarray        # (P, 3) positions
    power: jnp.ndarray    # (P, 3) flux (already divided by n_emitted)
    wi: jnp.ndarray       # (P, 3) incoming direction (toward the light path)
    n: jnp.ndarray        # (P, 3) surface normal at deposit
    valid: jnp.ndarray    # (P,) bool
    caustic: jnp.ndarray  # (P,) bool — every bounce before the deposit was
                          # specular (reference m_sSurfaceMapCaustic,
                          # PPPMTracer.h:152 + specular-only store,
                          # PPPMTracer_PhotonPass.cu:27,63)


def trace_photons(scene: Scene, n_photons: int, seed, config: PTConfig,
                  with_stats: bool = False) -> PhotonMap:
    """Photon pass: emit + walk + deposit (ParticleProcess equivalent).

    with_stats=True also returns the number of rays actually enqueued (sum of
    alive walk lanes per bounce, the reference's traced-ray counter
    semantics, Kernel/TraceHelper.h:52-53)."""
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
        spec_chain: jnp.ndarray  # all surface bounces so far were specular
        smp: Sampler

    init = _C(o=o, d=d, w=w, alive=jnp.ones((B,), bool),
              spec_chain=jnp.ones((B,), bool), smp=smp)

    def bounce(c: _C, depth):
        n_rays = jnp.sum(c.alive.astype(jnp.float32))
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       config.tex_types)
        found = hit.valid & c.alive

        # deposit at non-delta surfaces; first-bounce (direct) photons are
        # excluded because the eye pass handles direct lighting via NEE
        # (prevents double counting; reference splits the same way).
        # A photon is a CAUSTIC photon when every prior bounce was specular
        # (L S+ D paths) — those go into their own map with a smaller
        # progressive radius (PPPMTracer_PhotonPass.cu:27,63).
        store = found & bsdf_mod.is_smooth(mp) & (depth > 0)
        photon = (
            it.p,
            jnp.where(store[..., None], c.w, 0.0),
            -c.d,
            it.frame.n,
            store,
            store & c.spec_chain,
        )

        # continue: sample BSDF in importance (adjoint) mode
        s = c.smp
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        wo_local = it.frame.to_local(-c.d)
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=config.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        w_new = c.w * bs.weight
        s, u_rr = s.next_1d()
        p_cont = jax.lax.stop_gradient(
            jnp.minimum(jnp.max(jnp.abs(bs.weight), axis=-1), 0.9)
        )
        cont = found & (bs.pdf > 0) & (u_rr < p_cont)
        w_new = w_new / jnp.maximum(p_cont, 1e-6)[..., None]
        delta_now = bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0)
        new = _C(
            o=jnp.where(cont[..., None], _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps), c.o),
            d=jnp.where(cont[..., None], wi_world, c.d),
            w=jnp.where(cont[..., None], w_new, c.w),
            alive=cont,
            spec_chain=c.spec_chain & delta_now,
            smp=s,
        )
        return new, (photon, n_rays)

    _, (photons, n_rays) = jax.lax.scan(bounce, init, jnp.arange(config.max_depth))
    p, power, wi, n, valid, caustic = photons  # each (depth, B, ...)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    pm = PhotonMap(
        p=flat(p), power=flat(power) / n_photons, wi=flat(wi), n=flat(n),
        valid=flat(valid), caustic=flat(caustic),
    )
    if with_stats:
        return pm, jnp.sum(n_rays)
    return pm


def progressive_radius(r0, pass_idx):
    """r_n^2 = r_0^2 * prod (i+alpha)/(i+1) (PhotonMapHelper.h:18-21)."""
    i = jnp.arange(1, 256, dtype=jnp.float32)
    factors = jnp.where(i[None] <= pass_idx, (i + PPM_ALPHA) / (i + 1.0), 1.0)
    return r0 * jnp.sqrt(jnp.prod(factors))


class PPMConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=6, rr_start=2)
    n_photons: int = 1 << 17
    radius0: float = 0.07
    max_gather: int = 128
    grid_res: int = 64
    final_gather: bool = False
    # separate caustic photon map (PPPMTracer.h:152): L S+ D photons gather
    # with their own, smaller progressive radius — caustics are sharp, and
    # sharing the (larger) global radius blurs exactly the feature this
    # algorithm exists for. scale=1 + caustic_map=False reproduces the
    # single-map estimator.
    caustic_map: bool = True
    caustic_radius_scale: float = 0.4


def render_ppm_pass(scene: Scene, width: int, height: int, spp: int, seed,
                    pass_idx, config: PPMConfig = PPMConfig()):
    """One PPM pass: photon pass + eye pass. Returns an (H, W, 3) image whose
    average over passes converges (radius handled per pass_idx)."""
    import numpy as np

    base = specialize_config(scene, config.base)
    # grid cell size must stay >= the gather radius (3^3 neighborhood
    # correctness); derive a static resolution from the scene extent
    extent = float(
        np.min(np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min))
    ) + 2e-3
    res = max(4, min(config.grid_res, int(extent / max(config.radius0, 1e-6))))
    config = config._replace(base=base, grid_res=res)
    radius = progressive_radius(jnp.float32(config.radius0), jnp.float32(pass_idx))
    return _ppm_impl(scene, width, height, spp, jnp.uint32(seed),
                     radius, config)


def build_photon_grids(scene: Scene, pm: PhotonMap, config: PPMConfig):
    """(global grid, caustic grid | None): caustic photons get their own
    grid + smaller radius when config.caustic_map (PPPMTracer.h:152)."""
    lo = scene.bvh.world_min - 1e-3
    hi = scene.bvh.world_max + 1e-3
    if not config.caustic_map:
        return (hashgrid.build_grid(pm.p, lo, hi, res=config.grid_res,
                                    valid=pm.valid), None)
    return (
        hashgrid.build_grid(pm.p, lo, hi, res=config.grid_res,
                            valid=pm.valid & ~pm.caustic),
        hashgrid.build_grid(pm.p, lo, hi, res=config.grid_res,
                            valid=pm.valid & pm.caustic),
    )


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _ppm_impl(scene: Scene, width: int, height: int, spp: int, seed, radius,
              config: PPMConfig):
    # ---- photon pass ----
    pm = trace_photons(scene, config.n_photons, seed, config.base)
    grids = build_photon_grids(scene, pm, config)

    n_px = width * height
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    film = ppm_eye_pass(scene, pm, grids, pixel_id, sample_idx, seed, radius,
                        width, height, config)
    return film_mod.develop(film)


def ppm_eye_pass(scene: Scene, pm: PhotonMap, grids, pixel_id, sample_idx,
                 seed, radius, width: int, height: int, config: PPMConfig):
    """Eye pass over an arbitrary pixel/sample batch -> Film (unnormalized).

    `grids`: (global grid, caustic grid | None) from build_photon_grids —
    the caustic map gathers at radius * caustic_radius_scale, restoring the
    sharpness the global radius would blur away (the eye-pass caustic
    estimate of PPPMTracer_EyePass.cu).

    Factored out so the multi-chip path (parallel/shard.py) can shard pixels
    while the photon map is the all-gathered union of per-device photon
    passes (BASELINE config 5: sharded light pass)."""
    grid, grid_caustic = grids if isinstance(grids, tuple) else (grids, None)
    cfg = config.base
    B = pixel_id.shape[0]
    smp = Sampler.create(seed ^ jnp.uint32(0x5EED), pixel_id, sample_idx)
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
        alive: jnp.ndarray      # still looking for the gather vertex
        gathered: jnp.ndarray   # gather vertex found: position/normal/wo/mat
        gp: jnp.ndarray
        gn: jnp.ndarray
        gwo: jnp.ndarray
        gprim: jnp.ndarray
        smp: Sampler

    init = _E(
        o=o, d=d, w=jnp.ones((B, 3)), L=jnp.zeros((B, 3)),
        alive=jnp.ones((B,), bool), gathered=jnp.zeros((B,), bool),
        gp=jnp.zeros((B, 3)), gn=jnp.zeros((B, 3)), gwo=jnp.zeros((B, 3)),
        gprim=jnp.zeros((B,), jnp.int32), smp=smp,
    )

    def eye_bounce(c: _E, depth):
        """Walk through specular surfaces to the first smooth vertex
        (PPPMTracer_EyePass camera walk, <=5 specular bounces)."""
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       cfg.tex_types)
        found = hit.valid & c.alive

        # emission pickup along the specular chain
        mat_light = scene.materials.light_id[it.mat_id]
        lid = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -c.d)
        L = c.L + jnp.where((found & (mat_light >= 0))[..., None], c.w * Le, 0.0)

        smooth = bsdf_mod.is_smooth(mp)
        new_gather = found & smooth & ~c.gathered

        # continue through delta surfaces
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
            w=jnp.where(cont[..., None], c.w * bs.weight, c.w),
            L=L,
            alive=cont,
            gathered=c.gathered | new_gather,
            gp=jnp.where(new_gather[..., None], it.p, c.gp),
            gn=jnp.where(new_gather[..., None], it.frame.n, c.gn),
            gwo=jnp.where(new_gather[..., None], -c.d, c.gwo),
            gprim=jnp.where(new_gather, it.prim, c.gprim),
            smp=s,
        )
        return new, None

    final, _ = jax.lax.scan(eye_bounce, init, jnp.arange(5))

    # direct lighting at the gather vertex (NEE, one sample)
    g_hit = traversal.Hit(
        t=jnp.zeros((B,)), prim=final.gprim,
        bary=jnp.full((B, 2), 1.0 / 3.0), valid=final.gathered,
    )
    it_g = make_interaction(scene, final.gp, -final.gwo, g_hit)
    it_g = it_g._replace(p=final.gp)
    mp_g = gather_mat_params(scene, it_g, cfg.tex_types)
    s = final.smp
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    L = final.L
    if scene.n_lights > 0:
        lsel, lpmf, _ = _select_light(scene, u_sel)
        lpmf = jax.lax.stop_gradient(lpmf)
        ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, final.gp, u_l2,
                                            active=cfg.light_types)
        f_l, _ = bsdf_mod.eval_bsdf(
            mp_g,
            it_g.frame.to_local(final.gwo),
            it_g.frame.to_local(ds.d),
            active=cfg.bsdf_types,
        )
        sh_o = _offset_ray(final.gp, final.gn, ds.d, cfg.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                     ds.dist - 2 * cfg.ray_eps)
        pdf_l = jnp.where(ds.measure == 2, 1.0, jax.lax.stop_gradient(ds.pdf)) * lpmf
        ok = final.gathered & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + jnp.where(ok[..., None],
                          final.w * f_l * Lrad / jnp.maximum(pdf_l, 1e-12)[..., None],
                          0.0)

    # ---- photon density estimate (EntryEstimator.h:25-59) ----
    def density_estimate(g, sel_valid, r):
        idx, valid_n = hashgrid.query_sphere(g, final.gp, r, config.max_gather)
        ph_p = pm.p[idx]
        ph_pow = pm.power[idx]
        ph_wi = pm.wi[idx]
        ph_n = pm.n[idx]
        ph_ok = valid_n & sel_valid[idx] & final.gathered[:, None]
        d2 = jnp.sum((ph_p - final.gp[:, None, :]) ** 2, axis=-1)
        in_r = d2 < r * r
        # normal agreement threshold (EntryEstimator normal check)
        n_ok = jnp.sum(ph_n * final.gn[:, None, :], axis=-1) > 0.7
        use = ph_ok & in_r & n_ok
        # BSDF eval f(wo, wi_photon) per photon
        wo_l = it_g.frame.to_local(final.gwo)[:, None, :]
        wi_l = jnp.stack(
            [
                jnp.einsum("bkc,bc->bk", ph_wi, it_g.frame.s,
                           precision=jax.lax.Precision.HIGHEST),
                jnp.einsum("bkc,bc->bk", ph_wi, it_g.frame.t,
                           precision=jax.lax.Precision.HIGHEST),
                jnp.einsum("bkc,bc->bk", ph_wi, it_g.frame.n,
                           precision=jax.lax.Precision.HIGHEST),
            ],
            axis=-1,
        )
        mp_b = jax.tree.map(lambda a: a[:, None] if a.ndim == 1 else a[:, None, :], mp_g)
        f_ph, _ = bsdf_mod.eval_bsdf(mp_b, jnp.broadcast_to(wo_l, wi_l.shape), wi_l,
                                     active=cfg.bsdf_types)
        # remove the cosine folded into eval (photon estimate needs raw f)
        cos_i = jnp.abs(wi_l[..., 2])
        f_raw = f_ph / jnp.maximum(cos_i, 1e-6)[..., None]
        # Epanechnikov-like kernel weight (Math/Kernel.h)
        t2 = jnp.clip(d2 / jnp.maximum(r * r, 1e-12), 0.0, 1.0)
        kw = 2.0 * (1.0 - t2) / (PI * r * r)  # integrates to 1 on the disk
        return jnp.sum(
            jnp.where(use[..., None], f_raw * ph_pow * kw[..., None], 0.0),
            axis=1,
        )

    with jax.named_scope("photon_density_estimate"):
        if grid_caustic is None:
            L = L + final.w * density_estimate(grid, pm.valid, radius)
        else:
            L = L + final.w * density_estimate(grid, pm.valid & ~pm.caustic,
                                               radius)
            L = L + final.w * density_estimate(
                grid_caustic, pm.valid & pm.caustic,
                radius * config.caustic_radius_scale,
            )

    film = film_mod.Film.create(height, width)
    return film_mod.add_samples(film, pixel_id.astype(jnp.int32), L * w_cam)
