"""Vertex Connection and Merging (VCM).

Counterpart of reference ``Integrators/Bidirectional/VCM.{h,cu}`` — light
subpaths stored in a ping-pong photon grid and both connected (BDPT
strategies) and *merged* against camera subpaths, with the full recursive MIS
triple dVCM/dVC/dVM (VCMHelper.h:46-67; the Georgiev SmallVCM formulation the
reference implements).

Translation: the reference's per-pass photon hash grid
(VCMSurfMap = SpatialGridList_Linked, VCM.h:18-20) becomes the sort-based
grid of accel/hashgrid.py built fresh each pass from the light-vertex SoA
stack; merging is a fixed-K neighbor gather (progressive radius per pass,
PhotonMapHelper.h:18-21).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import hashgrid
from ..math.vecmath import INV_PI, PI, dot
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .bdpt import _camera_pdf_w
from .path_tracer import (PTConfig, _light_select_pmf, _offset_ray,
                          _select_light, specialize_config)
from .ppm import PPM_ALPHA, progressive_radius


class VCMConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=5, rr_start=99)
    s_max: int = 4
    radius0: float = 0.05
    max_gather: int = 32
    grid_res: int = 64


class _LV(NamedTuple):
    """Stored light vertex with the VCM MIS triple."""

    p: jnp.ndarray
    n: jnp.ndarray
    wo: jnp.ndarray
    thr: jnp.ndarray
    d_vcm: jnp.ndarray
    d_vc: jnp.ndarray
    d_vm: jnp.ndarray
    prim: jnp.ndarray
    uv: jnp.ndarray
    valid: jnp.ndarray


def _light_walk(scene: Scene, B, seed, cfg: PTConfig, s_max, mis_vc, mis_vm):
    smp = Sampler.create(seed ^ jnp.uint32(0x7C77), jnp.arange(B, dtype=jnp.uint32),
                         jnp.uint32(2))
    smp, u_sel = smp.next_1d()
    lsel, lpmf, _ = _select_light(scene, u_sel)
    lpmf = jax.lax.stop_gradient(lpmf)
    smp, u_pos = smp.next_2d()
    smp, u_dir = smp.next_2d()
    o, d, w = lights_mod.sample_emitter_ray(scene.lights, lsel, u_pos, u_dir)
    w = w / jnp.maximum(lpmf, 1e-9)[..., None]

    is_area = scene.lights.ltype[lsel] == lights_mod.AREA_LIGHT
    area = jnp.maximum(scene.lights.area[lsel], 1e-12)
    n_light = scene.lights.tri_n[jnp.clip(scene.lights.tri_first[lsel], 0,
                                          scene.lights.tris.shape[0] - 1)]
    cos_light = jnp.maximum(jnp.abs(dot(d, n_light)), 1e-6)
    pdf_pos_a = jnp.where(is_area, 1.0 / area, 1.0) * lpmf
    pdf_dir_w = jnp.where(is_area, cos_light * INV_PI, INV_PI * 0.25)
    pdf_emit_w = jnp.maximum(pdf_pos_a * pdf_dir_w, 1e-20)

    d_vcm = pdf_pos_a / pdf_emit_w
    d_vc = jnp.where(is_area, cos_light / pdf_emit_w, 0.0)
    d_vm = d_vc * mis_vc

    class _C(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        w: jnp.ndarray
        d_vcm: jnp.ndarray
        d_vc: jnp.ndarray
        d_vm: jnp.ndarray
        alive: jnp.ndarray
        smp: Sampler

    init = _C(o, d, w, d_vcm, d_vc, d_vm, jnp.ones((B,), bool), smp)

    def step(c: _C, depth):
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       cfg.tex_types)
        found = hit.valid & c.alive

        cos_in = jnp.maximum(jnp.abs(dot(it.frame.n, -c.d)), 1e-6)
        dist2 = jnp.maximum(it.t * it.t, 1e-12)
        d_vcm = c.d_vcm * dist2 / cos_in
        d_vc = c.d_vc / cos_in
        d_vm = c.d_vm / cos_in

        vtx = _LV(
            p=it.p, n=it.frame.n, wo=-c.d, thr=c.w,
            d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm,
            prim=it.prim, uv=it.uv,
            valid=found & bsdf_mod.is_smooth(mp),
        )

        s = c.smp
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        wo_local = it.frame.to_local(-c.d)
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp, bs.wi, wo_local, active=cfg.bsdf_types)
        cos_out = jnp.maximum(jnp.abs(bs.wi[..., 2]), 1e-6)
        is_spec = (bs.sampled_type & (16 | 32 | 64)) > 0
        p_fwd = jnp.maximum(bs.pdf, 1e-20)
        new_d_vc = jnp.where(
            is_spec, (cos_out / p_fwd) * d_vc * pdf_rev,
            (cos_out / p_fwd) * (d_vc * pdf_rev + d_vcm + mis_vm),
        )
        new_d_vm = jnp.where(
            is_spec, (cos_out / p_fwd) * d_vm * pdf_rev,
            (cos_out / p_fwd) * (d_vm * pdf_rev + d_vcm * mis_vc + 1.0),
        )
        new_d_vcm = jnp.where(is_spec, 0.0, 1.0 / p_fwd)
        cont = found & (bs.pdf > 0)
        return _C(
            o=jnp.where(cont[..., None], _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), c.o),
            d=jnp.where(cont[..., None], wi_world, c.d),
            w=jnp.where(cont[..., None], c.w * bs.weight, c.w),
            d_vcm=new_d_vcm, d_vc=new_d_vc, d_vm=new_d_vm,
            alive=cont, smp=s,
        ), vtx

    _, verts = jax.lax.scan(step, init, jnp.arange(s_max))
    return verts


@partial(jax.jit, static_argnames=("width", "height", "spp", "config"))
def _vcm_impl(scene: Scene, width: int, height: int, spp: int, seed, radius,
              config: VCMConfig):
    cfg = config.base
    n_px = width * height
    B = n_px * spp
    r2 = radius * radius
    eta_vcm = PI * r2 * B
    mis_vc = 1.0 / jnp.maximum(eta_vcm, 1e-12)
    mis_vm = eta_vcm

    lverts = _light_walk(scene, B, seed, cfg, config.s_max, mis_vc, mis_vm)

    # flatten light vertices into the merging grid
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    lv_flat = _LV(*[flat(x) for x in lverts])
    grid = hashgrid.build_grid(
        lv_flat.p, scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3,
        res=config.grid_res, valid=lv_flat.valid,
    )

    # ---- t = 1: light-vertex -> camera splats (VM-aware weights) ----
    splat_film = jnp.zeros((n_px, 3))
    cam = scene.camera
    for si in range(config.s_max):
        lv = jax.tree.map(lambda a: a[si], lverts)
        uv, d_cam, dist_cam, _, in_frustum = sensors.sample_direct(cam, lv.p)
        from ..accel.traversal import Hit as _Hit

        g_hit = _Hit(t=jnp.zeros((B,)), prim=lv.prim,
                     bary=jnp.full((B, 2), 1.0 / 3.0), valid=lv.valid)
        it_l = make_interaction(scene, lv.p, -lv.wo,
                                g_hit)._replace(p=lv.p)
        mp_l = gather_mat_params(scene, it_l._replace(uv=lv.uv),
                                 cfg.tex_types)
        wo_loc = it_l.frame.to_local(lv.wo)
        wi_loc = it_l.frame.to_local(d_cam)
        f_cam, _ = bsdf_mod.eval_bsdf(mp_l, wo_loc, wi_loc, active=cfg.bsdf_types)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp_l, wi_loc, wo_loc, active=cfg.bsdf_types)
        cos_cam = jnp.maximum(jnp.abs(wi_loc[..., 2]), 1e-6)
        f_noc = f_cam / cos_cam[..., None]
        cam_pdf_w = _camera_pdf_w(cam, -d_cam, height)
        cam_pdf_a = cam_pdf_w * cos_cam / jnp.maximum(dist_cam * dist_cam, 1e-9)
        w_light = (cam_pdf_a / B) * (mis_vm + lv.d_vcm + lv.d_vc * pdf_rev)
        mis_t1 = 1.0 / (w_light + 1.0)
        sh_o = _offset_ray(lv.p, it_l.n_geo, d_cam, cfg.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, d_cam, cfg.ray_eps,
                                           dist_cam - 2 * cfg.ray_eps)
        contrib = lv.thr * f_noc * (mis_t1 * cam_pdf_a / B)[..., None]
        ok = lv.valid & in_frustum & ~blocked
        sx = jnp.clip((uv[..., 0] * width).astype(jnp.int32), 0, width - 1)
        sy = jnp.clip((uv[..., 1] * height).astype(jnp.int32), 0, height - 1)
        splat_film = splat_film.at[sy * width + sx].add(
            jnp.where(ok[..., None],
                      jnp.nan_to_num(contrib, nan=0.0, posinf=0.0, neginf=0.0), 0.0))

    # ---- eye walk: s=0 + s=1 + connections + merging ----
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    smp = Sampler.create(seed, pixel_id, sample_idx)
    smp, jitter = smp.next_2d()
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    film_uv = jnp.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    cam_pdf_w0 = _camera_pdf_w(scene.camera, d, height)

    class _E(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        w: jnp.ndarray
        L: jnp.ndarray
        d_vcm: jnp.ndarray
        d_vc: jnp.ndarray
        d_vm: jnp.ndarray
        alive: jnp.ndarray
        smp: Sampler

    init = _E(o, d, jnp.ones((B, 3)), jnp.zeros((B, 3)),
              B / jnp.maximum(cam_pdf_w0, 1e-9), jnp.zeros((B,)), jnp.zeros((B,)),
              jnp.ones((B,), bool), smp)

    def eye_step(c: _E, depth):
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       cfg.tex_types)
        found = hit.valid & c.alive

        cos_in = jnp.maximum(jnp.abs(dot(it.frame.n, -c.d)), 1e-6)
        dist2 = jnp.maximum(it.t * it.t, 1e-12)
        d_vcm = c.d_vcm * dist2 / cos_in
        d_vc = c.d_vc / cos_in
        d_vm = c.d_vm / cos_in
        L = c.L
        wo_local = it.frame.to_local(-c.d)

        # s = 0
        mat_light = scene.materials.light_id[it.mat_id]
        lid = jnp.maximum(mat_light, 0)
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -c.d)
        lpmf_hit = _light_select_pmf(scene, lid)
        pdf_pos_a = lpmf_hit / jnp.maximum(scene.lights.area[lid], 1e-12)
        cos_l = jnp.maximum(jnp.abs(dot(it.n_geo, -c.d)), 1e-6)
        pdf_emit_w = pdf_pos_a * cos_l * INV_PI
        w_camera = pdf_pos_a * d_vcm + pdf_emit_w * d_vc
        mis0 = jnp.where(depth == 0, 1.0, 1.0 / (1.0 + w_camera))
        L = L + jnp.where((found & (mat_light >= 0))[..., None],
                          c.w * Le * mis0[..., None], 0.0)

        s = c.smp
        s, u_sel = s.next_1d()
        s, u_l2 = s.next_2d()

        # s = 1 (NEE with VCM weights)
        if scene.n_lights > 0:
            lsel, lpmf, _ = _select_light(scene, u_sel)
            lpmf = jax.lax.stop_gradient(lpmf)
            ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2,
                                               active=cfg.light_types)
            wi_l = it.frame.to_local(ds.d)
            f_l, pdf_b_fwd = bsdf_mod.eval_bsdf(mp, wo_local, wi_l, active=cfg.bsdf_types)
            _, pdf_b_rev = bsdf_mod.eval_bsdf(mp, wi_l, wo_local, active=cfg.bsdf_types)
            sh_o = _offset_ray(it.p, it.n_geo, ds.d, cfg.ray_eps)
            blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                               ds.dist - 2 * cfg.ray_eps)
            is_delta_l = ds.measure == 2
            pdf_l_w = jnp.where(is_delta_l, 1.0, jax.lax.stop_gradient(ds.pdf)) * lpmf
            cos_at_light = jnp.maximum(jnp.abs(dot(ds.n, -ds.d)), 1e-6)
            cos_to_light = jnp.maximum(jnp.abs(wi_l[..., 2]), 1e-6)
            pdf_emit = (lpmf / jnp.maximum(scene.lights.area[lsel], 1e-12)) \
                * cos_at_light * INV_PI
            w_light_m = pdf_b_fwd / jnp.maximum(pdf_l_w, 1e-20)
            w_cam_m = (pdf_emit * cos_to_light /
                       jnp.maximum(pdf_l_w * cos_at_light, 1e-20)) \
                * (mis_vm + d_vcm + d_vc * pdf_b_rev)
            mis1 = jnp.where(is_delta_l, 1.0, 1.0 / (w_light_m + 1.0 + w_cam_m))
            contrib = c.w * f_l * Lrad * (mis1 / jnp.maximum(pdf_l_w, 1e-12))[..., None]
            ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
            L = L + jnp.where(ok[..., None], contrib, 0.0)

        # s >= 2 connections (with VM-aware weights)
        for si in range(config.s_max):
            lv = jax.tree.map(lambda a: a[si], lverts)
            to_l = lv.p - it.p
            dist2_c = jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-9)
            dir_c = to_l / jnp.sqrt(dist2_c)[..., None]
            wi_e = it.frame.to_local(dir_c)
            f_e, pdf_e_fwd = bsdf_mod.eval_bsdf(mp, wo_local, wi_e, active=cfg.bsdf_types)
            _, pdf_e_rev = bsdf_mod.eval_bsdf(mp, wi_e, wo_local, active=cfg.bsdf_types)
            cos_e = jnp.maximum(jnp.abs(wi_e[..., 2]), 1e-6)
            f_e_raw = f_e / cos_e[..., None]

            from ..accel.traversal import Hit as _Hit

            g_hit = _Hit(
                t=jnp.zeros((B,)), prim=lv.prim,
                bary=jnp.full((B, 2), 1.0 / 3.0), valid=lv.valid,
            )
            it_l = make_interaction(scene, lv.p, -lv.wo,
                                    g_hit)._replace(p=lv.p)
            mp_l = gather_mat_params(scene, it_l._replace(uv=lv.uv),
                                     cfg.tex_types)
            wo_l_loc = it_l.frame.to_local(lv.wo)
            wi_l_loc = it_l.frame.to_local(-dir_c)
            f_lv, pdf_l_fwd = bsdf_mod.eval_bsdf(mp_l, wo_l_loc, wi_l_loc,
                                                 active=cfg.bsdf_types)
            _, pdf_l_rev = bsdf_mod.eval_bsdf(mp_l, wi_l_loc, wo_l_loc,
                                              active=cfg.bsdf_types)
            cos_lv = jnp.maximum(jnp.abs(wi_l_loc[..., 2]), 1e-6)
            f_lv_raw = f_lv / cos_lv[..., None]

            G = cos_e * cos_lv / dist2_c
            pdf_e_fwd_a = pdf_e_fwd * cos_lv / dist2_c
            pdf_l_fwd_a = pdf_l_fwd * cos_e / dist2_c
            w_light_m = pdf_e_fwd_a * (mis_vm + lv.d_vcm + lv.d_vc * pdf_l_rev)
            w_cam_m = pdf_l_fwd_a * (mis_vm + d_vcm + d_vc * pdf_e_rev)
            mis2 = 1.0 / (w_light_m + 1.0 + w_cam_m)

            sh_o = _offset_ray(it.p, it.n_geo, dir_c, cfg.ray_eps)
            blocked = scene_mod.scene_occluded(
                scene, sh_o, dir_c, cfg.ray_eps, jnp.sqrt(dist2_c) - 2 * cfg.ray_eps)
            contrib = c.w * f_e_raw * f_lv_raw * lv.thr * (G * mis2)[..., None]
            ok = found & lv.valid & ~blocked
            L = L + jnp.where(ok[..., None],
                              jnp.nan_to_num(contrib, nan=0.0, posinf=0.0, neginf=0.0), 0.0)

        # ---- merging (vertex merging / photon gather) ----
        idx, valid_n = hashgrid.query_sphere(grid, it.p, radius, config.max_gather)
        ph = jax.tree.map(lambda a: a[idx], lv_flat)
        d2 = jnp.sum((ph.p - it.p[:, None, :]) ** 2, axis=-1)
        use = (
            valid_n & ph.valid & found[:, None] & (d2 < r2)
            & (jnp.sum(ph.n * it.frame.n[:, None, :], -1) > 0.5)
        )
        wi_ph = jnp.stack([
            jnp.einsum("bkc,bc->bk", ph.wo, it.frame.s,
                       precision=jax.lax.Precision.HIGHEST),
            jnp.einsum("bkc,bc->bk", ph.wo, it.frame.t,
                       precision=jax.lax.Precision.HIGHEST),
            jnp.einsum("bkc,bc->bk", ph.wo, it.frame.n,
                       precision=jax.lax.Precision.HIGHEST),
        ], axis=-1)
        mp_b = jax.tree.map(lambda a: a[:, None] if a.ndim == 1 else a[:, None, :], mp)
        wo_b = jnp.broadcast_to(wo_local[:, None, :], wi_ph.shape)
        f_m, pdf_m_fwd = bsdf_mod.eval_bsdf(mp_b, wo_b, wi_ph, active=cfg.bsdf_types)
        _, pdf_m_rev = bsdf_mod.eval_bsdf(mp_b, wi_ph, wo_b, active=cfg.bsdf_types)
        cos_ph = jnp.maximum(jnp.abs(wi_ph[..., 2]), 1e-6)
        f_m_raw = f_m / cos_ph[..., None]
        w_light_mm = ph.d_vcm * mis_vc + ph.d_vm * pdf_m_fwd
        w_cam_mm = d_vcm[:, None] * mis_vc + d_vm[:, None] * pdf_m_rev
        mis_m = 1.0 / (w_light_mm + 1.0 + w_cam_mm)
        # contribution = thr_cam * sum_k(f_raw * thr_ph * mis) / (pi r^2 N)
        merge = jnp.sum(
            jnp.where(use[..., None], f_m_raw * ph.thr * mis_m[..., None], 0.0),
            axis=1,
        ) / jnp.maximum(PI * r2 * B, 1e-9)
        L = L + c.w * merge

        # continue
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp, bs.wi, wo_local, active=cfg.bsdf_types)
        cos_out = jnp.maximum(jnp.abs(bs.wi[..., 2]), 1e-6)
        is_spec = (bs.sampled_type & (16 | 32 | 64)) > 0
        p_fwd = jnp.maximum(bs.pdf, 1e-20)
        new_d_vc = jnp.where(is_spec, (cos_out / p_fwd) * d_vc * pdf_rev,
                             (cos_out / p_fwd) * (d_vc * pdf_rev + d_vcm + mis_vm))
        new_d_vm = jnp.where(is_spec, (cos_out / p_fwd) * d_vm * pdf_rev,
                             (cos_out / p_fwd) * (d_vm * pdf_rev + d_vcm * mis_vc + 1.0))
        new_d_vcm = jnp.where(is_spec, 0.0, 1.0 / p_fwd)
        cont = found & (bs.pdf > 0)
        return _E(
            o=jnp.where(cont[..., None], _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), c.o),
            d=jnp.where(cont[..., None], wi_world, c.d),
            w=jnp.where(cont[..., None], c.w * bs.weight, c.w),
            L=L, d_vcm=new_d_vcm, d_vc=new_d_vc, d_vm=new_d_vm,
            alive=cont, smp=s,
        ), None

    final, _ = jax.lax.scan(eye_step, init, jnp.arange(cfg.max_depth))

    film = jnp.zeros((n_px, 3))
    film = film.at[pixel_id.astype(jnp.int32)].add(
        jnp.nan_to_num(final.L * w_cam, nan=0.0, posinf=0.0, neginf=0.0))
    return (film / spp + splat_film).reshape(height, width, 3)


def render_vcm(scene: Scene, width: int, height: int, spp: int, seed, pass_idx=0,
               config: VCMConfig = VCMConfig()):
    """One VCM pass (average over passes with increasing pass_idx to converge;
    all strategies included: s>=0 connections, t=1 splats, and merging)."""
    import numpy as np

    base = specialize_config(scene, config.base)
    extent = float(np.min(np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min))) + 2e-3
    res = max(4, min(config.grid_res, int(extent / max(config.radius0, 1e-6))))
    config = config._replace(base=base, grid_res=res)
    radius = progressive_radius(jnp.float32(config.radius0), jnp.float32(pass_idx))
    return _vcm_impl(scene, width, height, spp, jnp.uint32(seed), radius, config)
