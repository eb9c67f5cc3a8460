"""Spectral path tracer: hero-wavelength sampling + dispersive dielectrics.

Closes the reference's spectral capability (Math/Spectrum.h:10-15 generic-N
TSpectrum over 360-830 nm; SceneTypes/Dispersion.h wavelength-dependent
IOR) the array-program way:

* each path carries N_WAVES spectral radiance samples at hero-rotated
  wavelengths (math/spectral.py; Wilkie et al. 2014) through the SAME
  lax.scan bounce structure as the RGB tracer;
* shading reuses the RGB BSDF/light machinery — every RGB quantity (albedo,
  Fresnel, emitter radiance) is uplifted to the path's wavelengths by the
  calibrated 3-band basis, so achromatic transport matches the RGB tracer
  by construction (the spectral-vs-RGB furnace gate);
* dielectrics with a nonzero Cauchy coefficient (Materials.cauchy_c)
  sample refraction with the HERO wavelength's IOR; on a dispersive
  refraction the companion wavelengths terminate (PBRT v4's
  SampledSpectrum::TerminateSecondary simplification of spectral MIS) —
  glass renders with physically-ordered chromatic fringes;
* everything stays differentiable: d(image)/d(cauchy_c) flows through the
  refraction direction, d(image)/d(radiance) through the uplift matrices.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..image import film as film_mod
from ..math import montecarlo as mc
from ..math import spectral as sp
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import (Scene, gather_mat_params, make_interaction,
                           small_gather)
from .path_tracer import PTConfig, _light_select_pmf, _offset_ray, _select_light

LAMBDA_D_UM = 0.5893  # sodium d-line (the wavelength Materials.eta is quoted at)


def dispersive_eta(eta_d, cauchy_c, lam_nm, sellmeier_b=None,
                   sellmeier_c=None):
    """Wavelength-dependent IOR (SceneTypes/Dispersion.h counterpart).

    Cauchy: n(lambda) = eta_d + C * (1/lam^2 - 1/lam_d^2), lam in um.
    Sellmeier (any B_i > 0 on the lane): the absolute
    n^2 = 1 + sum B_i l^2/(l^2 - C_i) — eta_d is ignored there, as in the
    reference (the Sellmeier form IS the material's index)."""
    lam_um = lam_nm * 1e-3
    n_cauchy = eta_d + cauchy_c * (1.0 / (lam_um * lam_um)
                                   - 1.0 / (LAMBDA_D_UM * LAMBDA_D_UM))
    if sellmeier_b is None:
        return n_cauchy
    lam2 = (lam_um * lam_um)[..., None]               # (..., 1)
    terms = sellmeier_b * lam2 / (lam2 - sellmeier_c)  # (..., 3)
    n_sell = jnp.sqrt(jnp.maximum(1.0 + jnp.sum(terms, -1), 1.0))
    use_sell = jnp.any(sellmeier_b > 0.0, axis=-1)
    return jnp.where(use_sell, n_sell, n_cauchy)


class _SCarry(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray   # (B, N_WAVES) spectral path throughput
    L: jnp.ndarray            # (B, N_WAVES) spectral radiance
    active: jnp.ndarray
    sampler: Sampler
    prev_pdf: jnp.ndarray
    prev_delta: jnp.ndarray
    mono: jnp.ndarray         # (B,) companions already terminated


def trace_radiance_spectral(scene: Scene, o, d, lam, sampler: Sampler,
                            config: PTConfig):
    """Spectral radiance samples (B, N_WAVES) along rays at wavelengths lam
    (B, N_WAVES); lam[:, 0] is the hero."""
    B = o.shape[0]
    NW = lam.shape[-1]
    uplift = lambda rgb: sp.rgb_to_spectrum(rgb, lam)
    init = _SCarry(
        o=o, d=d,
        throughput=jnp.ones((B, NW), jnp.float32),
        L=jnp.zeros((B, NW), jnp.float32),
        active=jnp.ones((B,), bool),
        sampler=sampler,
        prev_pdf=jnp.zeros((B,), jnp.float32),
        prev_delta=jnp.ones((B,), bool),
        mono=jnp.zeros((B,), bool),
    )

    def bounce(carry: _SCarry, depth):
        s = carry.sampler
        hit = scene_mod.scene_intersect(scene, carry.o, carry.d)
        it = make_interaction(scene, carry.o, carry.d, hit,
                              flat=config.flat_shading)
        found = hit.valid & carry.active
        L = carry.L

        # ---- environment on escape ----
        has_env = scene.env_light_id >= 0
        env_ids = jnp.broadcast_to(jnp.maximum(scene.env_light_id, 0), (B,))
        env_rgb = lights_mod.eval_env(scene.lights, env_ids, carry.d)
        w_env = jnp.where(
            carry.prev_delta | ~jnp.asarray(config.direct), 1.0,
            mc.mis_weight(carry.prev_pdf,
                          lights_mod.pdf_env_dir(scene.lights, env_ids,
                                                 carry.d)
                          * _light_select_pmf(scene, env_ids)))
        escaped = carry.active & ~hit.valid & has_env
        L = L + jnp.where(escaped[:, None],
                          carry.throughput * uplift(env_rgb) * w_env[:, None],
                          0.0)

        # ---- area emission at hit (MIS) ----
        mat_light = scene.materials.light_id[it.mat_id]
        emissive = found & (mat_light >= 0)
        lid = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo,
                                           -carry.d)
        pdf_hit = lights_mod.pdf_direct_area(
            scene.lights, lid, carry.o, it.p, it.n_geo
        ) * _light_select_pmf(scene, lid)
        w_hit = jnp.where(carry.prev_delta | ~jnp.asarray(config.direct),
                          1.0, mc.mis_weight(carry.prev_pdf, pdf_hit))
        L = L + jnp.where(emissive[:, None],
                          carry.throughput * uplift(Le) * w_hit[:, None], 0.0)

        # ---- shading setup: hero-wavelength dispersive eta ----
        mp = gather_mat_params(scene, it, config.tex_types)
        cc = small_gather(scene.materials.cauchy_c, it.mat_id)
        sb = small_gather(scene.materials.sellmeier_b, it.mat_id)
        sc2 = small_gather(scene.materials.sellmeier_c, it.mat_id)
        eta_base = mp.eta
        eta_hero = dispersive_eta(eta_base, cc, lam[..., 0], sb, sc2)
        mp = mp._replace(eta=eta_hero)
        wo_local = it.frame.to_local(-carry.d)

        # ---- NEE ----
        s, u_sel = s.next_1d()
        s, u_l2 = s.next_2d()
        if config.direct and scene.n_lights > 0:
            lsel, lpmf, _ = _select_light(scene, u_sel)
            ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p,
                                                u_l2,
                                                active=config.light_types)
            f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local,
                                              it.frame.to_local(ds.d),
                                              active=config.bsdf_types)
            sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
            blocked = scene_mod.scene_occluded(
                scene, sh_o, ds.d, config.ray_eps,
                ds.dist - 2.0 * config.ray_eps)
            is_delta_l = ds.measure == 2
            lpmf = jax.lax.stop_gradient(lpmf)
            pdf_l = jnp.where(is_delta_l, 1.0,
                              jax.lax.stop_gradient(ds.pdf)) * lpmf
            w_nee = jnp.where(is_delta_l, 1.0, mc.mis_weight(pdf_l, pdf_b_l))
            contrib = carry.throughput * uplift(f_l * Lrad) \
                * (w_nee / jnp.maximum(pdf_l, 1e-12))[:, None]
            ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
            L = L + jnp.where(ok[:, None], contrib, 0.0)

        # ---- BSDF sample (hero-eta directions) ----
        s, u_b2 = s.next_2d()
        s, u_b1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1,
                                  active=config.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        new_o = _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps)
        tp = carry.throughput * uplift(bs.weight)

        # ---- hero-wavelength MIS through ROUGH dispersive refraction
        # (Wilkie et al. 2014 §4): a glossy lobe has
        # nonzero pdf at every wavelength's eta along the sampled
        # direction, so companions SURVIVE with the one-sample MIS weight
        # f_lambda(wi) / mean_k pdf_k(wi) — only delta lobes still
        # terminate companions (their value off the hero direction is
        # exactly zero). Statically gated on the scene containing
        # roughdielectric at all. ----
        t = mp.bsdf_type
        has_rough_diel = (config.bsdf_types is None
                          or bsdf_mod.ROUGHDIELECTRIC in config.bsdf_types)
        nw = lam.shape[-1]
        rough_disp = jnp.zeros_like(found)
        pdf_mean = bs.pdf
        if has_rough_diel:
            etas = dispersive_eta(eta_base[..., None], cc[..., None], lam,
                                  sb[..., None, :], sc2[..., None, :])
            f_l_list, pdf_l_list = [], []
            for j in range(nw):
                f_j, p_j = bsdf_mod.eval_bsdf(
                    mp._replace(eta=etas[..., j]), wo_local, bs.wi,
                    active=config.bsdf_types)
                f_l_list.append(uplift(f_j)[..., j])
                pdf_l_list.append(p_j)
            f_lam = jnp.stack(f_l_list, axis=-1)        # (B, NW)
            pdf_lam = jnp.stack(pdf_l_list, axis=-1)    # (B, NW)
            pdf_mean_rd = jnp.mean(pdf_lam, axis=-1)
            refr_now = (bs.sampled_type & ((1 << 5) | (1 << 3))) > 0
            rough_disp = (found & refr_now
                          & ((cc > 0.0) | jnp.any(sb > 0.0, -1))
                          & (t == bsdf_mod.ROUGHDIELECTRIC))
            tp = jnp.where(
                rough_disp[:, None],
                carry.throughput * f_lam
                / jnp.maximum(jax.lax.stop_gradient(pdf_mean_rd),
                              1e-12)[:, None],
                tp)
            pdf_mean = jnp.where(rough_disp, pdf_mean_rd, bs.pdf)

        # DELTA dispersive refraction: companions terminate (hero
        # continues) — their delta lobe points elsewhere, so their value
        # along the hero's direction is exactly zero. This is
        # hero-wavelength MIS (Wilkie et al. 2014 §4) in the delta limit:
        # the per-wavelength pdf of the sampled direction is p for the
        # hero and 0 for every companion, so the one-sample MIS weight is
        # p / (mean_k p_k) = N_WAVES on the surviving hero lane —
        # spectral_to_rgb averages over N_WAVES lanes, and without this
        # factor all delta-dispersive transport lands ~N_WAVES x too dark.
        # (ROUGH dispersive lanes took the companion-preserving MIS branch
        # above and are excluded from the kill.)
        # transmission lobes: E_DELTA_TRANSMISSION | E_GLOSSY_TRANSMISSION
        refracted = (bs.sampled_type & ((1 << 5) | (1 << 3))) > 0
        dispersive = found & refracted & ~rough_disp \
            & ((cc > 0.0) | jnp.any(sb > 0.0, axis=-1)) & (
                (t == bsdf_mod.DIELECTRIC) | (t == bsdf_mod.THINDIELECTRIC)
                | (t == bsdf_mod.ROUGHDIELECTRIC))
        # the MIS factor applies ONCE — after the first dispersive event the
        # path is monochromatic and later dispersive refractions neither
        # re-kill nor re-weight (PBRT TerminateSecondary early-outs when
        # secondaries are already terminated)
        first_disp = dispersive & ~carry.mono
        kill = first_disp[:, None] & (jnp.arange(nw) > 0)
        hero_w = jnp.where(first_disp[:, None] & (jnp.arange(nw) == 0),
                           jnp.float32(nw), 1.0)
        tp = jnp.where(kill, 0.0, tp * hero_w)

        cont = found & (pdf_mean > 0) & (jnp.max(tp, axis=-1) > 0)
        s, u_rr = s.next_1d()
        p_cont = jax.lax.stop_gradient(mc.russian_roulette_prob(
            jnp.max(tp, axis=-1), depth, config.rr_start))
        cont = cont & (u_rr < p_cont)
        tp = tp / jnp.maximum(p_cont, 1e-6)[:, None]

        delta_now = bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0)
        return _SCarry(
            o=jnp.where(cont[:, None], new_o, carry.o),
            d=jnp.where(cont[:, None], wi_world, carry.d),
            throughput=jnp.where(cont[:, None], tp, carry.throughput),
            L=L, active=cont, sampler=s,
            prev_pdf=jnp.where(cont, pdf_mean, carry.prev_pdf),
            prev_delta=jnp.where(cont, delta_now, carry.prev_delta),
            mono=carry.mono | first_disp,
        ), None

    body = jax.checkpoint(bounce, prevent_cse=False) if config.remat else bounce
    final, _ = jax.lax.scan(body, init, jnp.arange(config.max_depth))
    return final.L, final.sampler


def uplift_sigma(sig_rgb, lam):
    """sigma spectra from RGB coefficients — the same calibrated 3-band
    uplift surfaces use for albedo (math/spectral.py), clamped positive
    (sigma must stay a density; the residual basis can undershoot).
    Counterpart of the reference's sigma-as-Spectrum volumes
    (SceneTypes/Volumes.h)."""
    return jnp.maximum(sp.rgb_to_spectrum(sig_rgb, lam), 0.0)


def spectral_transmittance(media, o, d, t0, t1, lam, modes=None):
    """Per-wavelength transmittance through ANY media aggregate.

    Within the 3-band spectral model, sigma_lambda is piecewise-constant
    per band, so the per-band OPTICAL DEPTH is the linear uplift of the
    per-channel RGB optical depth: tau_lambda = uplift(-ln T_rgb) and
    T_lambda = exp(-tau_lambda). Exact for every volume type media.py
    supports (homogeneous, per-channel grids, 16-volume unions) at the
    cost of one RGB transmittance evaluation."""
    from ..scene import media as media_mod

    T_rgb = media_mod.transmittance(media, o, d, t0, t1, modes)
    tau_rgb = -jnp.log(jnp.clip(T_rgb, 1e-30, 1.0))
    return jnp.exp(-jnp.maximum(sp.rgb_to_spectrum(tau_rgb, lam), 0.0))


def trace_radiance_spectral_vol(scene: Scene, media, o, d, lam,
                                sampler: Sampler, config: PTConfig):
    """Spectral volumetric transport: hero-wavelength sigma_t through a
    HOMOGENEOUS medium (collision sampling against the hero extinction,
    per-companion transmittance weights — the same detached-decision /
    attached-weight scheme the RGB media sampler and _sss_walk use), with
    per-wavelength NEE shadow transmittance via `spectral_transmittance`
    (any media). Collisions inside heterogeneous grids are out of scope —
    use the RGB volpath there; spectral SHADOW attenuation through grids
    still works via the optical-depth uplift.

    Returns (L (B, N_WAVES), sampler)."""
    from ..math.vecmath import dot as _dot
    from ..scene import phase as phase_mod

    B = o.shape[0]
    NW = lam.shape[-1]
    uplift = lambda rgb: sp.rgb_to_spectrum(rgb, lam)
    sg = jax.lax.stop_gradient

    # single homogeneous volume (static): base sigma spectra at the path's
    # wavelengths
    sa_l = uplift_sigma(media.sigma_a[0], lam)       # (B, NW)
    ss_l = uplift_sigma(media.sigma_s[0], lam)
    st_l = sa_l + ss_l
    st_hero = sg(jnp.maximum(st_l[..., 0], 1e-8))
    blo = media.box_min[0]
    bhi = media.box_max[0]
    ph_t = media.phase_type[jnp.int32(0)]
    ph_g = media.phase_g[jnp.int32(0)]

    def box_span(ro, rd, t_lo, t_hi):
        inv = 1.0 / jnp.where(jnp.abs(rd) < 1e-20, 1e-20, rd)
        ta = (blo - ro) * inv
        tb = (bhi - ro) * inv
        near = jnp.max(jnp.minimum(ta, tb), axis=-1)
        far = jnp.min(jnp.maximum(ta, tb), axis=-1)
        return jnp.clip(near, t_lo, t_hi), jnp.clip(far, t_lo, t_hi)

    class _SV(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        tp: jnp.ndarray
        L: jnp.ndarray
        active: jnp.ndarray
        smp: Sampler
        prev_pdf: jnp.ndarray
        prev_delta: jnp.ndarray

    init = _SV(o=o, d=d, tp=jnp.ones((B, NW)), L=jnp.zeros((B, NW)),
               active=jnp.ones((B,), bool), smp=sampler,
               prev_pdf=jnp.zeros((B,)), prev_delta=jnp.ones((B,), bool))

    def bounce(c: _SV, depth):
        s = c.smp
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it = make_interaction(scene, c.o, c.d, hit,
                              flat=config.flat_shading)
        found = hit.valid & c.active
        t_surf = jnp.where(hit.valid, hit.t, 1e8)

        # ---- homogeneous medium event on the in-box segment ----
        t0, t1 = box_span(c.o, c.d, config.ray_eps, t_surf)
        seg = jnp.maximum(t1 - t0, 0.0)
        s, u_t = s.next_1d()
        dt = -jnp.log(jnp.maximum(1.0 - u_t, 1e-12)) / st_hero
        scat = c.active & (dt < seg)
        t_m = t0 + jnp.minimum(dt, seg)
        p_scat = c.o + c.d * t_m[..., None]
        # hero-sampled pdfs, per-wavelength numerators (detached decisions)
        w_scat = ss_l * jnp.exp(-st_l * dt[..., None]) / sg(
            st_hero * jnp.exp(-st_hero * dt))[..., None]
        w_pass = jnp.exp(-st_l * seg[..., None]) / jnp.maximum(
            sg(jnp.exp(-st_hero * seg)), 1e-30)[..., None]
        tp = c.tp * jnp.where(c.active[..., None],
                              jnp.where(scat[..., None], w_scat, w_pass),
                              1.0)

        # ---- escaped to env ----
        has_env = scene.env_light_id >= 0
        env_ids = jnp.broadcast_to(jnp.maximum(scene.env_light_id, 0), (B,))
        env_rgb = lights_mod.eval_env(scene.lights, env_ids, c.d)
        w_env = jnp.where(c.prev_delta, 1.0,
                          mc.mis_weight(c.prev_pdf,
                                        lights_mod.pdf_env_dir(
                                            scene.lights, env_ids, c.d)
                                        * _light_select_pmf(scene, env_ids)))
        escaped = c.active & ~hit.valid & ~scat & has_env
        L = c.L + jnp.where(escaped[:, None],
                            tp * uplift(env_rgb) * w_env[:, None], 0.0)

        # ---- surface emission (MIS) ----
        mat_light = scene.materials.light_id[it.mat_id]
        emissive = found & ~scat & (mat_light >= 0)
        lid = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo,
                                           -c.d)
        pdf_hit = lights_mod.pdf_direct_area(
            scene.lights, lid, c.o, it.p, it.n_geo
        ) * _light_select_pmf(scene, lid)
        w_hit = jnp.where(c.prev_delta, 1.0,
                          mc.mis_weight(c.prev_pdf, pdf_hit))
        L = L + jnp.where(emissive[:, None],
                          tp * uplift(Le) * w_hit[:, None], 0.0)

        # ---- NEE from the medium point or the surface ----
        mp = gather_mat_params(scene, it, config.tex_types)
        wo_world = -c.d
        wo_local = it.frame.to_local(wo_world)
        nee_p = jnp.where(scat[..., None], p_scat, it.p)
        s, u_sel = s.next_1d()
        s, u_l2 = s.next_2d()
        if config.direct and scene.n_lights > 0:
            lsel, lpmf, _ = _select_light(scene, u_sel)
            lpmf = sg(lpmf)
            ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, nee_p,
                                                u_l2,
                                                active=config.light_types)
            f_surf, pdf_b = bsdf_mod.eval_bsdf(
                mp, wo_local, it.frame.to_local(ds.d),
                active=config.bsdf_types)
            ph_v = phase_mod.eval_phase(ph_t, ph_g, wo_world, ds.d)
            pdf_ph = phase_mod.pdf_phase(ph_t, ph_g, wo_world, ds.d)
            f_l = jnp.where(scat[..., None], ph_v[..., None],
                            uplift(f_surf))
            pdf_fwd = jnp.where(scat, pdf_ph, pdf_b)
            sh_o = jnp.where(scat[..., None], nee_p,
                             _offset_ray(it.p, it.n_geo, ds.d,
                                         config.ray_eps))
            blocked = scene_mod.scene_occluded(
                scene, sh_o, ds.d, config.ray_eps,
                ds.dist - 2.0 * config.ray_eps)
            tr_l = spectral_transmittance(
                media, sh_o, ds.d, config.ray_eps,
                ds.dist - 2.0 * config.ray_eps, lam,
                modes=config.media_modes)
            is_delta_l = ds.measure == 2
            pdf_l = jnp.where(is_delta_l, 1.0, sg(ds.pdf)) * lpmf
            w_nee = jnp.where(is_delta_l, 1.0,
                              mc.mis_weight(pdf_l, pdf_fwd))
            contrib = tp * f_l * tr_l * uplift(Lrad) \
                * (w_nee / jnp.maximum(pdf_l, 1e-12))[:, None]
            ok = (found | scat) & ~blocked & (ds.pdf > 0) & (lpmf > 0)
            L = L + jnp.where(ok[:, None], contrib, 0.0)

        # ---- continue: phase or BSDF sample ----
        s, u_p2 = s.next_2d()
        ps = phase_mod.sample_phase(ph_t, ph_g, wo_world, u_p2)
        s, u_b2 = s.next_2d()
        s, u_b1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1,
                                  active=config.bsdf_types)
        wi_surf = it.frame.to_world(bs.wi)
        new_d = jnp.where(scat[..., None], ps.wi, wi_surf)
        new_o = jnp.where(scat[..., None], p_scat,
                          _offset_ray(it.p, it.n_geo, wi_surf,
                                      config.ray_eps))
        step_w = jnp.where(scat[..., None], ps.weight[..., None],
                           uplift(bs.weight))
        new_pdf = jnp.where(scat, ps.pdf, bs.pdf)
        tp2 = tp * step_w
        cont = (found | scat) & (new_pdf > 0) & (jnp.max(tp2, -1) > 0)
        s, u_rr = s.next_1d()
        p_cont = sg(mc.russian_roulette_prob(jnp.max(tp2, -1), depth,
                                             config.rr_start))
        cont = cont & (u_rr < p_cont)
        tp2 = tp2 / jnp.maximum(p_cont, 1e-6)[:, None]
        delta_now = ~scat & (bsdf_mod.is_delta(mp)
                             | ((bs.sampled_type & (16 | 32 | 64)) > 0))
        return _SV(
            o=jnp.where(cont[:, None], new_o, c.o),
            d=jnp.where(cont[:, None], new_d, c.d),
            tp=jnp.where(cont[:, None], tp2, c.tp),
            L=L, active=cont, smp=s,
            prev_pdf=jnp.where(cont, new_pdf, c.prev_pdf),
            prev_delta=jnp.where(cont, delta_now, c.prev_delta),
        ), None

    final, _ = jax.lax.scan(bounce, init, jnp.arange(config.max_depth))
    return final.L, final.smp


def _render_spectral_vol_body(scene, media, width, height, spp, seed,
                              config):
    n_px = width * height
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    sampler = Sampler.create(seed, pixel_id, sample_idx)
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    sampler, jitter = sampler.next_2d()
    uv = jnp.stack([(px + jitter[:, 0]) / width,
                    (py + jitter[:, 1]) / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)
    sampler, u_lam = sampler.next_1d()
    lam, pdf_lam = sp.sample_wavelengths(u_lam)
    Ls, _ = trace_radiance_spectral_vol(scene, media, o, d, lam, sampler,
                                        config)
    rgb = sp.spectral_to_rgb(Ls, lam, pdf_lam) * w_cam
    rgb = jnp.nan_to_num(rgb, nan=0.0, posinf=0.0, neginf=0.0)
    film = film_mod.Film.create(height, width)
    film = film_mod.add_samples(film, pixel_id.astype(jnp.int32), rgb)
    return film_mod.develop(film)


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "config"))
def _render_spectral_vol_impl(scene, media, width, height, spp, seed,
                              config):
    return _render_spectral_vol_body(scene, media, width, height, spp,
                                     seed, config)


def render_spectral_vol(scene: Scene, media, width: int, height: int,
                        spp: int, seed, config: PTConfig = PTConfig()):
    """Spectral volumetric render -> (H, W, 3) linear sRGB (homogeneous
    media collisions; see trace_radiance_spectral_vol)."""
    from .path_tracer import specialize_config
    from .volpath import specialize_media_config

    config = specialize_media_config(media, specialize_config(scene, config))
    return _render_spectral_vol_impl(scene, media, width, height, spp,
                                     jnp.uint32(seed), config)


def _render_spectral_body(scene, width, height, spp, seed, config):
    n_px = width * height
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    sampler = Sampler.create(seed, pixel_id, sample_idx)
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    sampler, jitter = sampler.next_2d()
    uv = jnp.stack([(px + jitter[:, 0]) / width,
                    (py + jitter[:, 1]) / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)
    sampler, u_lam = sampler.next_1d()
    lam, pdf_lam = sp.sample_wavelengths(u_lam)
    Ls, _ = trace_radiance_spectral(scene, o, d, lam, sampler, config)
    rgb = sp.spectral_to_rgb(Ls, lam, pdf_lam) * w_cam
    rgb = jnp.nan_to_num(rgb, nan=0.0, posinf=0.0, neginf=0.0)
    film = film_mod.Film.create(height, width)
    film = film_mod.add_samples(film, pixel_id.astype(jnp.int32), rgb)
    return film_mod.develop(film)


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _render_spectral_impl(scene, width, height, spp, seed, config):
    return _render_spectral_body(scene, width, height, spp, seed, config)


def render_spectral(scene: Scene, width: int, height: int, spp: int, seed,
                    config: PTConfig = PTConfig()):
    """Full spectral render -> (H, W, 3) linear sRGB image."""
    from .path_tracer import specialize_config

    config = specialize_config(scene, config)
    return _render_spectral_impl(scene, width, height, spp, jnp.uint32(seed),
                                 config)


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "n_passes", "config"))
def _render_spectral_prog_impl(scene, width, height, spp, n_passes, seed,
                               config):
    def one(acc, i):
        return acc + _render_spectral_body(scene, width, height, spp,
                                           seed + i, config), None

    acc, _ = jax.lax.scan(one, jnp.zeros((height, width, 3), jnp.float32),
                          jnp.arange(n_passes, dtype=jnp.uint32))
    return acc / n_passes


def render_spectral_progressive(scene: Scene, width: int, height: int,
                                spp: int, n_passes: int, seed,
                                config: PTConfig = PTConfig()):
    from .path_tracer import specialize_config

    config = specialize_config(scene, config)
    return _render_spectral_prog_impl(scene, width, height, spp, n_passes,
                                      jnp.uint32(seed), config)
