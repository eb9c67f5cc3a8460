"""Unidirectional path tracer with next-event estimation and MIS.

Counterpart of the reference megakernel PathTracer
(Integrators/PathTracer.cu:10-113: NEE + power-heuristic MIS at :62-86,
env MIS :98-111, RR from depth 5 :91-96). Design translation (SURVEY.md §7):
the per-pixel CUDA megakernel becomes a `lax.scan` over bounce index applied
to a SoA ray batch with alive masks; `Image::AddSample` atomics become
deterministic scatter-adds; the whole step is differentiable w.r.t. scene
parameters (materials / lights / camera) with detached sampling decisions.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import traversal
from ..image import film as film_mod
from ..math import montecarlo as mc
from ..math.vecmath import dot, normalize
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import (Scene, gather_mat_params, gather_nested_params,
                           make_interaction)

RAY_EPS = 1e-3


class PTConfig(NamedTuple):
    max_depth: int = 6
    rr_start: int = 5
    direct: bool = True          # NEE on/off (reference PathTracer "Direct" param)
    ray_eps: float = RAY_EPS
    # path-space regularization (reference PathTracer.cu:115-170): after the
    # first bounce, delta BSDFs are mollified into rough lobes of this alpha
    # (0 = off) so NEE/BDPT strategies can connect through them
    regularization: float = 0.0
    # scene-static specialization (filled by specialize_config): tuples of the
    # bsdf/light/texture type tags actually present — absent families are
    # never computed (analogue of per-type template instantiation)
    bsdf_types: tuple | None = None
    light_types: tuple | None = None
    tex_types: tuple | None = None
    flat_shading: bool = False  # normals==face normals and default UV chart
    # material-map specialization (Engine/Material.h maps; set from the scene)
    normal_maps: bool = False
    height_maps: bool = False
    parallax: bool = False
    alpha_test: bool = False
    # rematerialize each bounce in the backward pass (jax.checkpoint over the
    # scan body): memory per differentiable render drops from O(depth * live
    # intermediates) to O(1 bounce), making 512^2+ gradient renders fit in
    # device memory
    # (SURVEY.md §5 "long context" = rays/chip + remat)
    remat: bool = False
    # reconstruction filter applied at ACCUMULATION time (filter-importance
    # splatting, Engine/Image.cu:22-44 + CanonicalFilter.cu): 0=box (fast
    # reshape-sum path), 1=gaussian, 2=mitchell, 3=lanczos, 4=triangle
    rec_filter: int = 0
    rec_radius: float = 1.5
    # static per-volume media specialization (media.static_modes tuple) —
    # set host-side by volpath's public entry points; hashable so the jit
    # cache keys on it like the other specialization fields
    media_modes: tuple | None = None
    # BSSRDF subsurface random walk (Engine/Material.h:66): enabled by
    # specialize_config when any material carries sss > 0
    sss: bool = False
    sss_steps: int = 16  # interior walk scan length (truncation ~albedo^N)


def specialize_config(scene: Scene, config: PTConfig) -> PTConfig:
    """Derive the static type sets from a concrete scene (host side).

    build_scene registers the host-derived specialization at build time
    (scene.py _SPECIALIZE_CACHE) so that no shading array is read back from
    the device here; the readback path below is only a fallback for
    hand-assembled scenes."""
    if config.bsdf_types is not None:
        return config
    import numpy as np

    from ..scene.scene import get_registered_specialization

    reg = get_registered_specialization(scene)
    if reg is not None:
        merged = config._replace(**reg)
        if config.regularization > 0.0:
            import cudatracerlib_tpu.scene.bsdf as B

            mapped = set(merged.bsdf_types)
            if B.CONDUCTOR in mapped:
                mapped.add(B.ROUGHCONDUCTOR)
            if B.DIELECTRIC in mapped or B.THINDIELECTRIC in mapped:
                mapped.add(B.ROUGHDIELECTRIC)
            merged = merged._replace(bsdf_types=tuple(sorted(mapped)))
        return merged

    used_mats = np.unique(np.asarray(scene.shading.mat_id))
    mats = scene.materials
    # include materials nested inside coating/blend (one level)
    used_mats = np.unique(np.concatenate(
        [used_mats, np.asarray(mats.nested_id)[used_mats]]
    ))
    bsdf_types = tuple(sorted(int(x) for x in np.unique(np.asarray(mats.bsdf_type)[used_mats])))
    light_types = tuple(sorted(int(x) for x in np.unique(np.asarray(scene.lights.ltype))))
    map_ids = np.concatenate([
        np.asarray(mats.tex_normal)[used_mats],
        np.asarray(mats.tex_height)[used_mats],
        np.asarray(mats.tex_alpha)[used_mats],
    ])
    tex_ids = np.unique(np.concatenate([
        np.asarray(mats.tex_albedo)[used_mats],
        np.asarray(mats.tex_specular)[used_mats],
        np.asarray(mats.tex_transmittance)[used_mats],
        map_ids[map_ids >= 0],
    ]))
    tex_types = tuple(sorted(int(x) for x in np.unique(np.asarray(scene.textures.ttype)[tex_ids])))
    normal_maps = bool((np.asarray(mats.tex_normal)[used_mats] >= 0).any())
    height_maps = bool((np.asarray(mats.tex_height)[used_mats] >= 0).any())
    parallax = height_maps and bool(
        (np.asarray(mats.parallax)[used_mats] > 0).any()
    )
    alpha = bool((
        (np.asarray(mats.alpha_mode)[used_mats] > 0)
        & (np.asarray(mats.tex_alpha)[used_mats] >= 0)
    ).any())
    sss_any = bool((np.asarray(mats.sss)[used_mats] > 0).any())
    if config.regularization > 0.0:
        import cudatracerlib_tpu.scene.bsdf as B

        mapped = set(bsdf_types)
        if B.CONDUCTOR in mapped:
            mapped.add(B.ROUGHCONDUCTOR)
        if B.DIELECTRIC in mapped or B.THINDIELECTRIC in mapped:
            mapped.add(B.ROUGHDIELECTRIC)
        bsdf_types = tuple(sorted(mapped))
    sh = scene.shading
    nrm = np.asarray(sh.normals)
    uvs_np = np.asarray(sh.uvs)
    flat = bool(
        np.allclose(nrm, np.asarray(sh.n_face)[:, None, :], atol=1e-5)
        and np.allclose(uvs_np[:, 0], 0.0)
        and np.allclose(uvs_np[:, 1], [1.0, 0.0])
        and np.allclose(uvs_np[:, 2], [0.0, 1.0])
    )
    return config._replace(
        bsdf_types=bsdf_types, light_types=light_types, tex_types=tex_types,
        flat_shading=flat, normal_maps=normal_maps, height_maps=height_maps,
        parallax=parallax, alpha_test=alpha, sss=sss_any,
    )


def _select_light(scene: Scene, u):
    """Power-CDF light selection with sample reuse
    (Engine/KernelDynamicScene.cu:25-46). Single-light scenes (statically
    known from the table shape) use a scalar index so every downstream
    per-lane table lookup becomes a broadcast instead of a 1M-row gather."""
    if scene.light_cdf.shape[0] == 1:
        return jnp.int32(0), jnp.ones_like(u), u
    idx, pmf, u_re = mc.sample_discrete(scene.light_cdf, u)
    return idx, pmf, u_re


def _light_select_pmf(scene: Scene, lid):
    if scene.light_cdf.shape[0] == 1:
        return jnp.ones(jnp.shape(lid), jnp.float32)
    cdf = scene.light_cdf
    hi = cdf[lid]
    lo = jnp.where(lid > 0, cdf[jnp.maximum(lid - 1, 0)], 0.0)
    return jnp.maximum(hi - lo, 0.0)


def _regularize(mp, depth, alpha):
    """Mollify delta lobes into rough microfacet lobes after the first bounce
    (reference path-space regularization, PathTracer.cu:115-170)."""
    t = mp.bsdf_type
    mollify = depth > 0
    new_t = jnp.where(
        mollify & (t == bsdf_mod.CONDUCTOR), bsdf_mod.ROUGHCONDUCTOR, t
    )
    new_t = jnp.where(
        mollify & ((t == bsdf_mod.DIELECTRIC) | (t == bsdf_mod.THINDIELECTRIC)),
        bsdf_mod.ROUGHDIELECTRIC, new_t,
    )
    was_delta = new_t != t
    a = jnp.where(was_delta, jnp.float32(alpha), mp.alpha_u)
    return mp._replace(bsdf_type=new_t, alpha_u=a,
                       alpha_v=jnp.where(was_delta, jnp.float32(alpha), mp.alpha_v))


def _offset_ray(p, n_geo, w, eps):
    """Offset origin along the geometric normal on w's side."""
    s = jnp.sign(dot(n_geo, w, keepdims=True))
    return p + n_geo * s * eps


def _sss_walk(scene: Scene, config: PTConfig, *, entered, p0, d0, n_entry,
              mat_id, sampler: Sampler):
    """Random-walk subsurface transport (Engine/Material.h:66 GetBSSRDF +
    Kernel/ParticleProcess.h SSS handling).

    A lane that refracted into an sss material walks its homogeneous
    interior: distances sampled against the channel-mean sigma_t (per-
    channel weights keep the estimator exact AND differentiable w.r.t. the
    sigmas — the BASELINE sigma_s gradient gate), HG phase at each scatter,
    boundary exits refract through the dielectric interface (TIR reflects
    back inside). Fixed-trip scan (config.sss_steps); lanes still inside at
    the cap terminate (truncation ~ albedo^N).

    Returns (exited, exit_o, exit_d, weight (B,3), sampler, n_rays)."""
    B = p0.shape[0]
    m = scene.materials
    g = lambda t: scene_mod.small_gather(t, mat_id)
    sig_s = g(m.sss_sigma_s)
    sig_a = g(m.sss_sigma_a)
    sig_t = sig_s + sig_a
    hg = g(m.sss_g)
    eta_mat = g(m.eta)
    sig_mean = jax.lax.stop_gradient(
        jnp.maximum(jnp.mean(sig_t, axis=-1), 1e-6))

    from ..math import fresnel as fres
    from ..math.vecmath import reflect, refract
    from ..scene import phase as phase_mod

    class _W(NamedTuple):
        pos: jnp.ndarray
        dir: jnp.ndarray
        w: jnp.ndarray          # (B, 3) accumulated interior weight
        inside: jnp.ndarray
        exited: jnp.ndarray
        exit_o: jnp.ndarray
        exit_d: jnp.ndarray
        smp: Sampler
        n_rays: jnp.ndarray

    # start just inside the surface
    init = _W(pos=p0 - n_entry * config.ray_eps, dir=d0,
              w=jnp.ones((B, 3), jnp.float32), inside=entered,
              exited=jnp.zeros((B,), bool), exit_o=p0, exit_d=d0,
              smp=sampler, n_rays=jnp.zeros((), jnp.float32))

    def step(st: _W, _):
        s, u_t = st.smp.next_1d()
        t_s = -jnp.log(jnp.maximum(1.0 - u_t, 1e-12)) / sig_mean
        hit = scene_mod.scene_intersect(scene, st.pos, st.dir,
                                        config.ray_eps, t_s)
        hit_bound = st.inside & hit.valid
        scat = st.inside & ~hit.valid

        # ---- scatter event: per-channel weight over the mean-sigma pdf ----
        tr_c = jnp.exp(-sig_t * t_s[..., None])
        pdf_sc = jax.lax.stop_gradient(
            sig_mean * jnp.exp(-sig_mean * t_s))[..., None]
        w_sc = sig_s * tr_c / jnp.maximum(pdf_sc, 1e-20)
        s, u_ph = s.next_2d()
        ps = phase_mod.sample_phase(
            jnp.broadcast_to(jnp.int32(phase_mod.HG), (B,)), hg,
            -st.dir, u_ph)
        p_sc = st.pos + st.dir * t_s[..., None]

        # ---- boundary event: pass weight, Fresnel exit or TIR ----
        t_b = jnp.where(hit.valid, hit.t, 1.0)
        tr_b = jnp.exp(-sig_t * t_b[..., None])
        pdf_b = jax.lax.stop_gradient(
            jnp.exp(-sig_mean * t_b))[..., None]
        w_b = tr_b / jnp.maximum(pdf_b, 1e-20)
        if scene.instances:
            # instanced scene: hit.prim packs (instance, local prim) and
            # n_face rows are OBJECT space — decode to the shading row (as
            # make_interaction does) and map the normal to world via the
            # world->object linear part transposed (round-4 advisor fix:
            # the raw packed prim can exceed the table and silently clamp)
            from ..scene import instances as inst_mod

            tpad = inst_mod.instance_tpad(scene.blas)
            inst_id, _, row = inst_mod.decode_hit(scene.instances, tpad, hit)
            nf_obj = scene_mod.gather_rows(scene.shading.n_face, row)
            to_obj_f, _, _, _ = inst_mod.flat_instance_arrays(scene.instances)
            Lo = scene_mod.small_gather(to_obj_f, inst_id)[..., :, :3]
            nf = normalize(jnp.einsum("...ij,...i->...j", Lo, nf_obj,
                                         precision=jax.lax.Precision.HIGHEST))
        else:
            nf = scene_mod.gather_rows(scene.shading.n_face,
                                       jnp.maximum(hit.prim, 0))
        n_out = nf * jnp.sign(dot(nf, st.dir, keepdims=True))  # points along exit
        p_b = st.pos + st.dir * t_b[..., None]
        wo = -st.dir
        ci = dot(wo, n_out)  # negative: hitting the boundary from inside
        F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(ci, eta_mat)
        s, u_f = s.next_1d()
        do_exit = hit_bound & (u_f >= F)          # transmit out
        tir = hit_bound & ~do_exit                # reflect back inside
        d_refr = refract(wo, n_out, eta_ti, cos_t)
        d_refl = reflect(wo, n_out)
        # radiance compression exiting the dense medium (cf.
        # _dielectric_sample's eta_ti^2 factor on the way in)
        w_exit = w_b * (eta_ti * eta_ti)[..., None] \
            * ((1.0 - F) / jnp.maximum(_sg(1.0 - F), 1e-12))[..., None]
        w_tir = w_b * (F / jnp.maximum(_sg(F), 1e-12))[..., None]

        new_inside = scat | tir
        new_pos = jnp.where(scat[..., None], p_sc,
                            jnp.where(tir[..., None],
                                      p_b - st.dir * config.ray_eps, st.pos))
        new_dir = jnp.where(scat[..., None], ps.wi,
                            jnp.where(tir[..., None], d_refl, st.dir))
        new_w = jnp.where(scat[..., None], st.w * w_sc * ps.weight[..., None],
                          jnp.where(tir[..., None], st.w * w_tir,
                                    jnp.where(do_exit[..., None],
                                              st.w * w_exit, st.w)))
        return _W(
            pos=new_pos, dir=new_dir, w=new_w, inside=new_inside,
            exited=st.exited | do_exit,
            exit_o=jnp.where(do_exit[..., None],
                             p_b + n_out * config.ray_eps, st.exit_o),
            exit_d=jnp.where(do_exit[..., None], d_refr, st.exit_d),
            smp=s,
            n_rays=st.n_rays + jnp.sum(st.inside.astype(jnp.float32)),
        ), None

    fin, _ = jax.lax.scan(step, init, None, length=config.sss_steps)
    return fin.exited, fin.exit_o, fin.exit_d, fin.w, fin.smp, fin.n_rays


_sg = jax.lax.stop_gradient


class BounceOut(NamedTuple):
    """Result of one shared surface bounce (see surface_bounce)."""
    o: jnp.ndarray           # next ray origin
    d: jnp.ndarray           # next ray direction
    throughput: jnp.ndarray  # updated path throughput (RR-compensated)
    L_add: jnp.ndarray       # radiance added this bounce (env/emission/NEE)
    cont: jnp.ndarray        # path continues
    bs_pdf: jnp.ndarray      # solid-angle pdf of the sampled direction
    delta_now: jnp.ndarray   # sampled lobe was delta (suppress next MIS)
    eta_scale: jnp.ndarray   # updated accumulated eta^2
    path_len: jnp.ndarray    # updated path length (ray-cone footprint)
    sampler: Sampler
    n_rays: jnp.ndarray      # rays actually traced this bounce (scalar)
    n_nonfinite: jnp.ndarray  # lanes whose contribution/throughput went
                              # non-finite this bounce, BEFORE any
                              # nan_to_num laundering (scalar; psum-able
                              # next to n_rays — SURVEY §5 NaN accounting)


def surface_bounce(scene: Scene, config: PTConfig, *, o, d, active,
                   throughput, prev_pdf, prev_delta, eta_scale, path_len,
                   sampler: Sampler, depth, cone=None) -> BounceOut:
    """One full surface-path bounce: intersect -> material maps / alpha test
    -> env + area-light emission with MIS -> NEE -> BSDF sample -> RR.

    The single shading implementation shared by the megakernel scan
    (trace_radiance) and the wavefront pool (render/wavefront.py), so the two
    engines shade identically by construction — the analogue of the
    reference sharing PathTrace device code between PathTracer.cu and
    WavefrontPathTracer.cu. `depth` may be a scalar (scan index) or a per-lane
    (B,) vector (wavefront pool depth)."""
    B = o.shape[0]
    lt = config.light_types
    has_env_static = lt is None or (lights_mod.INFINITE in lt) or (lights_mod.CONSTANT_ENV in lt)
    has_area_static = lt is None or (lights_mod.AREA_LIGHT in lt)
    bt = config.bsdf_types
    has_nested = bt is None or any(
        x in bt for x in (bsdf_mod.COATING, bsdf_mod.ROUGHCOATING, bsdf_mod.BLEND)
    )
    from ..scene import textures as tex_mod

    filter_textures = cone is not None and (
        config.tex_types is None or tex_mod.IMAGE in config.tex_types
    )

    s = sampler
    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit, flat=config.flat_shading)
    found_any = hit.valid & active
    if config.normal_maps or config.height_maps:
        it = scene_mod.apply_material_maps(
            scene, it, -d, config.tex_types,
            use_normal=config.normal_maps, use_height=config.height_maps,
            use_parallax=config.parallax,
        )
    if config.alpha_test:
        # alpha-tested-away surfaces pass the ray straight through
        # (Material::AlphaTest; consumes one bounce like the reference's
        # wavefront iteration does)
        keep = scene_mod.alpha_test(scene, it, config.tex_types)
        passthru = found_any & ~keep
        found = found_any & keep
    else:
        passthru = None
        found = found_any
    L = jnp.zeros((B, 3), jnp.float32)

    # ---- environment on escape (PathTracer.cu:98-111) ----
    if has_env_static:
        has_env = scene.env_light_id >= 0
        env_id = jnp.maximum(scene.env_light_id, 0)
        env_ids = jnp.broadcast_to(env_id, (B,))
        env_L = lights_mod.eval_env(scene.lights, env_ids, d)
        env_pdf_l = lights_mod.pdf_env_dir(scene.lights, env_ids, d)
        env_sel = _light_select_pmf(scene, env_ids)
        w_env = jnp.where(
            prev_delta | ~jnp.asarray(config.direct),
            1.0,
            mc.mis_weight(prev_pdf, env_pdf_l * env_sel),
        )
        escaped = active & ~hit.valid & has_env
        L = L + jnp.where(escaped[..., None], throughput * env_L * w_env[..., None], 0.0)

    # ---- emission at hit (MIS against NEE, PathTracer.cu:62-86) ----
    wo_world = -d
    if has_area_static:
        mat_light = scene.materials.light_id[it.mat_id]
        emissive = found & (mat_light >= 0)
        lid = (jnp.int32(0) if scene.n_lights == 1
               else jnp.maximum(mat_light, 0))
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, wo_world)
        pdf_light_hit = lights_mod.pdf_direct_area(
            scene.lights, lid, o, it.p, it.n_geo
        ) * _light_select_pmf(scene, lid)
        w_hit = jnp.where(
            prev_delta | ~jnp.asarray(config.direct),
            1.0,
            mc.mis_weight(prev_pdf, pdf_light_hit),
        )
        L = L + jnp.where(emissive[..., None], throughput * Le * w_hit[..., None], 0.0)

    # ---- surface shading setup ----
    if filter_textures:
        r0, slope = cone
        path_t = path_len + jnp.where(found_any, hit.t, 0.0)
        uv_width = (r0 + slope * path_t) * jnp.take(
            scene.shading.uv_density, it.prim)
    else:
        path_t = path_len
        uv_width = None
    mp = gather_mat_params(scene, it, config.tex_types, uv_width=uv_width)
    if config.regularization > 0.0:
        mp = _regularize(mp, depth, config.regularization)
    wo_local = it.frame.to_local(wo_world)

    # ---- next-event estimation (TraceAlgorithms.cu:44-101) ----
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        lsel, lpmf, _ = _select_light(scene, u_sel)
        ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2,
                                            active=config.light_types)
        wi_l_local = it.frame.to_local(ds.d)
        if has_nested:
            mp_in = gather_nested_params(scene, it, config.tex_types,
                                         uv_width=uv_width)
            f_l, pdf_b_l = bsdf_mod.eval_bsdf_nested(
                mp, mp_in, wo_local, wi_l_local, active=config.bsdf_types)
        else:
            f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local, wi_l_local,
                                              active=config.bsdf_types)
        # occlusion
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
        blocked = scene_mod.scene_occluded(
            scene, sh_o, ds.d, t_min=config.ray_eps,
            t_max=ds.dist - 2.0 * config.ray_eps,
        )
        is_delta_l = ds.measure == 2  # DISCRETE
        lpmf = jax.lax.stop_gradient(lpmf)
        pdf_l_sa = jnp.where(is_delta_l, 1.0, jax.lax.stop_gradient(ds.pdf)) * lpmf
        w_nee = jnp.where(
            is_delta_l, 1.0, mc.mis_weight(pdf_l_sa, pdf_b_l)
        )
        contrib = (
            throughput
            * f_l
            * Lrad
            * (w_nee / jnp.maximum(pdf_l_sa, 1e-12))[..., None]
        )
        nee_ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + jnp.where(nee_ok[..., None], contrib, 0.0)
        n_shadow = jnp.sum(found.astype(jnp.float32))
    else:
        n_shadow = jnp.float32(0.0)

    # ---- BSDF sampling ----
    s, u_b2 = s.next_2d()
    s, u_b1 = s.next_1d()
    if has_nested:
        mp_in2 = gather_nested_params(scene, it, config.tex_types,
                                          uv_width=uv_width)
        bs = bsdf_mod.sample_bsdf_nested(mp, mp_in2, wo_local, u_b2, u_b1,
                                         active=config.bsdf_types)
    else:
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1,
                                  active=config.bsdf_types)
    wi_world = it.frame.to_world(bs.wi)
    new_o = _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps)
    new_tp = throughput * bs.weight
    cont = found & (bs.pdf > 0) & (jnp.max(jnp.abs(new_tp), axis=-1) > 0)

    # ---- russian roulette (PathTracer.cu:91-96) ----
    s, u_rr = s.next_1d()
    tmax_c = jnp.max(new_tp, axis=-1) * eta_scale
    p_cont = jax.lax.stop_gradient(
        mc.russian_roulette_prob(tmax_c, depth, config.rr_start)
    )
    survive = u_rr < p_cont
    new_tp = new_tp / jnp.maximum(p_cont, 1e-6)[..., None]
    cont = cont & survive

    delta_now = bsdf_mod.is_delta(mp) | (
        (bs.sampled_type & (16 | 32 | 64)) > 0  # delta/null lobes
    )
    n_sss = jnp.float32(0.0)
    if config.sss:
        # ---- BSSRDF: refraction INTO an sss material starts the interior
        # random walk; the path resumes from the exit point/direction ----
        sss_mask = scene_mod.small_gather(scene.materials.sss, it.mat_id) > 0
        entering = cont & sss_mask & ((bs.sampled_type & (32 | 8)) > 0) \
            & (dot(wi_world, it.n_geo) * dot(wo_world, it.n_geo) < 0.0)
        n_out_entry = it.n_geo * jnp.sign(dot(it.n_geo, wo_world,
                                              keepdims=True))
        ex, ex_o, ex_d, w_sss, s, n_sss = _sss_walk(
            scene, config, entered=entering, p0=it.p, d0=wi_world,
            n_entry=n_out_entry, mat_id=it.mat_id, sampler=s)
        new_o = jnp.where(entering[..., None], ex_o, new_o)
        wi_world = jnp.where(entering[..., None], ex_d, wi_world)
        new_tp = jnp.where(entering[..., None], new_tp * w_sss, new_tp)
        cont = jnp.where(entering, ex, cont)
        delta_now = jnp.where(entering, True, delta_now)
    if passthru is not None:
        # alpha pass-through: continue the unchanged ray from behind the
        # surface with untouched throughput/MIS state
        new_o = jnp.where(passthru[..., None], it.p + d * config.ray_eps, new_o)
        wi_world = jnp.where(passthru[..., None], d, wi_world)
        new_tp = jnp.where(passthru[..., None], throughput, new_tp)
        cont = cont | passthru
        bs_pdf = jnp.where(passthru, prev_pdf, bs.pdf)
        delta_now = jnp.where(passthru, prev_delta, delta_now)
        eta_next = jnp.where(passthru, eta_scale, eta_scale * bs.eta * bs.eta)
    else:
        bs_pdf = bs.pdf
        eta_next = eta_scale * bs.eta * bs.eta
    bad = active & (
        jnp.any(~jnp.isfinite(L), axis=-1)
        | (cont & jnp.any(~jnp.isfinite(new_tp), axis=-1))
    )
    return BounceOut(
        o=new_o, d=wi_world, throughput=new_tp, L_add=L, cont=cont,
        bs_pdf=bs_pdf, delta_now=delta_now, eta_scale=eta_next,
        path_len=path_t, sampler=s,
        n_rays=jnp.sum(active.astype(jnp.float32)) + n_shadow + n_sss,
        n_nonfinite=jnp.sum(bad.astype(jnp.float32)),
    )


class _Carry(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    L: jnp.ndarray
    active: jnp.ndarray
    sampler: Sampler
    prev_pdf: jnp.ndarray      # solid-angle pdf of the last BSDF sample
    prev_delta: jnp.ndarray    # last bounce was a delta lobe (no MIS)
    eta_scale: jnp.ndarray     # accumulated eta^2 for RR throughput
    path_len: jnp.ndarray      # accumulated path length (ray-cone footprint)
    n_rays: jnp.ndarray        # rays actually enqueued (closest + shadow)
    n_nonfinite: jnp.ndarray   # non-finite contributions (debug counter)


def trace_radiance(scene: Scene, o, d, sampler: Sampler, config: PTConfig,
                   cone=None, with_stats: bool = False):
    """Estimate radiance along a batch of rays. Returns (L (B,3), sampler).

    `cone`: optional (r0, slope) per-pixel ray-cone (sensors.pixel_spread)
    driving MIP-mapped texture LOD; None disables texture filtering.

    `with_stats=True` appends a scalar count of rays actually traced — the
    sum over bounces of alive closest-hit lanes plus NEE shadow rays cast —
    matching the reference's enqueued-ray counter semantics
    (Kernel/TraceHelper.h:52-53), NOT the padded lane count."""
    B = o.shape[0]
    init = _Carry(
        o=o,
        d=d,
        throughput=jnp.ones((B, 3), jnp.float32),
        L=jnp.zeros((B, 3), jnp.float32),
        active=jnp.ones((B,), bool),
        sampler=sampler,
        prev_pdf=jnp.zeros((B,), jnp.float32),
        prev_delta=jnp.ones((B,), bool),   # depth 0: emission counts fully
        eta_scale=jnp.ones((B,), jnp.float32),
        path_len=jnp.zeros((B,), jnp.float32),
        n_rays=jnp.zeros((), jnp.float32),
        n_nonfinite=jnp.zeros((), jnp.float32),
    )

    def bounce(carry: _Carry, depth):
        out = surface_bounce(
            scene, config,
            o=carry.o, d=carry.d, active=carry.active,
            throughput=carry.throughput, prev_pdf=carry.prev_pdf,
            prev_delta=carry.prev_delta, eta_scale=carry.eta_scale,
            path_len=carry.path_len, sampler=carry.sampler,
            depth=depth, cone=cone,
        )
        cont = out.cont
        new_carry = _Carry(
            o=jnp.where(cont[..., None], out.o, carry.o),
            d=jnp.where(cont[..., None], out.d, carry.d),
            throughput=jnp.where(cont[..., None], out.throughput,
                                 carry.throughput),
            L=carry.L + out.L_add,
            active=cont,
            sampler=out.sampler,
            prev_pdf=jnp.where(cont, out.bs_pdf, carry.prev_pdf),
            prev_delta=jnp.where(cont, out.delta_now, carry.prev_delta),
            eta_scale=jnp.where(cont, out.eta_scale, carry.eta_scale),
            path_len=jnp.where(cont, out.path_len, carry.path_len),
            n_rays=carry.n_rays + out.n_rays,
            n_nonfinite=carry.n_nonfinite + out.n_nonfinite,
        )
        return new_carry, None

    body = jax.checkpoint(bounce, prevent_cse=False) if config.remat else bounce
    final, _ = jax.lax.scan(body, init, jnp.arange(config.max_depth))
    if with_stats:
        return final.L, final.sampler, final.n_rays, final.n_nonfinite
    return final.L, final.sampler


def render(scene: Scene, width: int, height: int, spp: int, seed,
           config: PTConfig = PTConfig()):
    """Render a full frame: returns (H, W, 3) radiance image.

    One pass = spp camera samples per pixel, stratified jitter, box filter —
    matching the reference Tracer<>::DoPass structure (Kernel/Tracer.h:209-248).
    Thin wrapper: derives the scene-static specialization, then calls the
    jitted implementation (cache keyed on the specialized config).
    """
    config = specialize_config(scene, config)
    return _render_impl(scene, width, height, spp, seed, config)


def block_order_pixels_np(width: int, height: int, block: int = 32):
    import numpy as np

    bw = (width + block - 1) // block
    bh = (height + block - 1) // block
    ids = []
    for by in range(bh):
        for bx in range(bw):
            ys = np.arange(by * block, min((by + 1) * block, height))
            xs = np.arange(bx * block, min((bx + 1) * block, width))
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            ids.append((Y * width + X).reshape(-1))
    return np.concatenate(ids).astype(np.uint32)


def block_order_pixels(width: int, height: int, block: int = 32):
    """Pixel ids in block-major order: consecutive rays form compact screen
    tiles, so neighbouring kernel threads walk similar BVH paths. Film
    scatter handles the permutation for free."""
    import numpy as np

    bw = (width + block - 1) // block
    bh = (height + block - 1) // block
    ids = []
    for by in range(bh):
        for bx in range(bw):
            ys = np.arange(by * block, min((by + 1) * block, height))
            xs = np.arange(bx * block, min((bx + 1) * block, width))
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            ids.append((Y * width + X).reshape(-1))
    return jnp.asarray(np.concatenate(ids).astype(np.uint32))


def _render_body(scene: Scene, width: int, height: int, spp: int, seed,
                 config: PTConfig, with_stats: bool):
    import numpy as np

    n_px = width * height
    block_perm_np = block_order_pixels_np(width, height)
    block_perm = jnp.asarray(block_perm_np)
    pixel_id = jnp.tile(block_perm, spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    sampler = Sampler.create(seed, pixel_id, sample_idx)

    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    sampler, jitter = sampler.next_2d()
    film_uv = jnp.stack(
        [(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], axis=-1
    )
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)

    cone = sensors.pixel_spread(scene.camera, width, height)
    out = trace_radiance(scene, o, d, sampler, config, cone=cone,
                         with_stats=with_stats)
    L = out[0]
    stats = (out[2], out[3]) if with_stats else None
    L = jnp.nan_to_num(L * w_cam, nan=0.0, posinf=0.0, neginf=0.0)

    if config.rec_filter != 0:
        # filter-importance splatting: each sample lands in its filter
        # support with continuous weights (image/film.py)
        from ..image import film as film_mod

        film = film_mod.Film.create(height, width)
        film = film_mod.add_samples_filtered(
            film, px + jitter[:, 0], py + jitter[:, 1], L,
            config.rec_filter, config.rec_radius,
            support=max(1, int(np.ceil(config.rec_radius - 0.5))),
        )
        img = film.rgb / jnp.maximum(film.weight, 1e-8)[..., None]
        if with_stats:
            return img, stats
        return img

    # the sample->pixel map is a fixed permutation repeated spp times, so the
    # film "scatter" is a reshape-sum + static inverse-permutation gather
    # (deterministic, and much faster than a 1M-way scatter-add)
    slot_sum = L.reshape(spp, n_px, 3).sum(0) / spp
    inv_perm = jnp.asarray(np.argsort(block_perm_np).astype(np.int32))
    img = slot_sum[inv_perm].reshape(height, width, 3)
    if with_stats:
        return img, stats
    return img


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _render_impl(scene: Scene, width: int, height: int, spp: int, seed,
                 config: PTConfig):
    return _render_body(scene, width, height, spp, seed, config, False)


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _render_counted_impl(scene: Scene, width: int, height: int, spp: int,
                         seed, config: PTConfig):
    return _render_body(scene, width, height, spp, seed, config, True)


def render_counted(scene: Scene, width: int, height: int, spp: int, seed,
                   config: PTConfig = PTConfig()):
    """Like `render` but also returns the number of rays actually traced
    (alive closest-hit lanes + NEE shadow rays, summed over bounces)."""
    config = specialize_config(scene, config)
    img, (n_rays, _) = _render_counted_impl(scene, width, height, spp, seed,
                                            config)
    return img, n_rays


def render_with_counters(scene: Scene, width: int, height: int, spp: int,
                         seed, config: PTConfig = PTConfig()):
    """Render + debug counters: {'n_rays', 'n_nonfinite'}. n_nonfinite
    counts lanes whose bounce contribution or throughput went non-finite
    BEFORE the film's nan_to_num (a counter that separates "rare fp edge"
    from "broken estimator" — SURVEY §5 NaN accounting; the engine
    cross-validation tests assert it is zero)."""
    config = specialize_config(scene, config)
    img, (n_rays, n_bad) = _render_counted_impl(scene, width, height, spp,
                                                seed, config)
    return img, {"n_rays": n_rays, "n_nonfinite": n_bad}


def render_pass_fn(scene: Scene, width: int, height: int, spp: int,
                   config: PTConfig = PTConfig()):
    """Returns a jitted fn(seed) -> image, for progressive accumulation."""
    return partial(render, scene, width, height, spp, config=config)


def render_progressive(scene: Scene, width: int, height: int, spp: int,
                       n_passes: int, seed, config: PTConfig = PTConfig()):
    """N progressive passes fused into ONE dispatch (lax.scan over pass
    index) — the whole reference `main.cpp` pass loop as a single XLA
    program, amortizing host dispatch overhead."""
    config = specialize_config(scene, config)
    return _render_progressive_impl(scene, width, height, spp, n_passes,
                                    jnp.uint32(seed), config)


@partial(jax.jit, static_argnames=("width", "height", "spp", "n_passes", "config"))
def _render_progressive_impl(scene: Scene, width: int, height: int, spp: int,
                             n_passes: int, seed, config: PTConfig):
    def one_pass(acc, i):
        img = _render_impl(scene, width, height, spp, seed + i, config)
        return acc + img, None

    acc, _ = jax.lax.scan(
        one_pass, jnp.zeros((height, width, 3), jnp.float32),
        jnp.arange(n_passes, dtype=jnp.uint32),
    )
    return acc / n_passes
