"""PrimTracer: single-bounce AOV / debug renderer.

Counterpart of reference ``Integrators/PrimTracer.{h,cu}`` and its 15 draw
modes (PrimTracer.h:7-9 PTDM list: linear_depth, D3D_depth, v_absdot_n_geo,
v_dot_n_geo, v_dot_n_shade, n_geo_colored, n_shade_colored, uv, bary_coords,
first_Le, first_f, first_f_direct, first_non_delta_Le, first_non_delta_f,
first_non_delta_f_direct). One jitted function returns a dict of AOV images —
the analogue of the reference's per-mode kernels (all modes are
computed in one fused pass; XLA dead-code-eliminates unused outputs when the
caller extracts a single channel under jit).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..math import montecarlo as mc
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction

# the reference's D3D depth transform constants (PrimTracer.cu:32-38):
# hyperbolic depth with near/far planes
D3D_NEAR = 1.0
D3D_FAR = 100.0


def _one_sample_direct(scene, it, d, smp):
    """One-sample NEE estimate at the first hit (draw mode *_f_direct)."""
    smp, u_sel = smp.next_1d()
    smp, u_l2 = smp.next_2d()
    if scene.n_lights == 0:
        return jnp.zeros_like(it.p), smp
    lsel, lpmf, _ = mc.sample_discrete(scene.light_cdf, u_sel)
    ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2)
    mp = gather_mat_params(scene, it)
    wo_l = it.frame.to_local(-d)
    wi_l = it.frame.to_local(ds.d)
    f_l, _ = bsdf_mod.eval_bsdf(mp, wo_l, wi_l)
    sh_o = it.p + it.n_geo * jnp.sign(
        jnp.sum(it.n_geo * ds.d, -1, keepdims=True)
    ) * 1e-3
    blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, 1e-3, ds.dist - 2e-3)
    pdf = jnp.where(ds.measure == 2, 1.0, ds.pdf) * lpmf
    direct = f_l * Lrad / jnp.maximum(pdf, 1e-12)[..., None]
    ok = (it.valid & ~blocked & (pdf > 0))[..., None]
    return jnp.where(ok, direct, 0.0), smp


def _first_hit_channels(scene, o, d, it, smp):
    """Le / albedo (f proxy) / one-sample direct at an interaction."""
    v = it.valid[..., None]
    mp = gather_mat_params(scene, it)
    albedo = jnp.where(v, mp.albedo, 0.0)
    mat_light = scene.materials.light_id[it.mat_id]
    lid = jnp.maximum(mat_light, 0)
    Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -d)
    Le = jnp.where((mat_light >= 0)[..., None] & v, Le, 0.0)
    direct, smp = _one_sample_direct(scene, it, d, smp)
    return Le, albedo, direct, smp


@partial(jax.jit, static_argnames=("width", "height", "max_path_length"))
def render_aovs(scene: Scene, width: int, height: int, seed=0,
                max_path_length: int = 7):
    """Render first-hit AOVs at 1 spp (pixel centers). Returns a dict with
    every reference draw mode plus mat_id/prim_id extras."""
    n_px = width * height
    pid = jnp.arange(n_px, dtype=jnp.uint32)
    px = (pid % width).astype(jnp.float32)
    py = (pid // width).astype(jnp.float32)
    uv = jnp.stack([(px + 0.5) / width, (py + 0.5) / height], axis=-1)
    smp = Sampler.create(seed, pid, 0)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)

    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit)
    v = it.valid[..., None]

    # --- geometry modes ---
    depth = jnp.where(it.valid, hit.t, 0.0)
    # D3D (hyperbolic) depth: (f/(f-n)) * (1 - n/z)  (PrimTracer.cu:32-38)
    z = jnp.maximum(depth, 1e-6)
    d3d = jnp.clip(
        (D3D_FAR / (D3D_FAR - D3D_NEAR)) * (1.0 - D3D_NEAR / z), 0.0, 1.0
    )
    d3d = jnp.where(it.valid, d3d, 1.0)
    vdir = -d
    vdng = jnp.sum(vdir * it.n_geo, -1)
    vdns = jnp.sum(vdir * it.frame.n, -1)
    v_absdot_n_geo = jnp.where(it.valid, jnp.abs(vdng), 0.0)
    v_dot_n_geo = jnp.where(it.valid, vdng * 0.5 + 0.5, 0.0)
    v_dot_n_shade = jnp.where(it.valid, vdns * 0.5 + 0.5, 0.0)
    normal_g = jnp.where(v, it.n_geo * 0.5 + 0.5, 0.0)
    normal_s = jnp.where(v, it.frame.n * 0.5 + 0.5, 0.0)
    uv_aov = jnp.where(v, jnp.concatenate([it.uv, jnp.zeros_like(it.uv[..., :1])], -1), 0.0)
    bary = jnp.concatenate([hit.bary, jnp.zeros_like(hit.bary[..., :1])], -1)
    bary = jnp.where(v, bary, 0.0)
    mat = jnp.where(it.valid, it.mat_id.astype(jnp.float32), -1.0)
    prim = jnp.where(it.valid, it.prim.astype(jnp.float32), -1.0)

    # --- first-hit shading modes ---
    Le, albedo, direct, smp = _first_hit_channels(scene, o, d, it, smp)

    # --- first_non_delta_*: walk through delta (specular) chains ----------
    # (PrimTracer.cu:85: follow until the material has a smooth component)
    def step(carry, _):
        o_c, d_c, it_c, active, smp_c = carry
        mp_c = gather_mat_params(scene, it_c)
        is_delta = bsdf_mod.is_delta(mp_c) & it_c.valid
        go = active & is_delta
        smp_c, u2 = smp_c.next_2d()
        smp_c, u1 = smp_c.next_1d()
        bs = bsdf_mod.sample_bsdf(mp_c, it_c.frame.to_local(-d_c), u2, u1)
        wi_w = it_c.frame.to_world(bs.wi)
        new_o = it_c.p + it_c.n_geo * jnp.sign(
            jnp.sum(it_c.n_geo * wi_w, -1, keepdims=True)) * 1e-3
        new_hit = scene_mod.scene_intersect(scene, new_o, wi_w)
        new_it = make_interaction(scene, new_o, wi_w, new_hit)
        sel = go[..., None]
        o_n = jnp.where(sel, new_o, o_c)
        d_n = jnp.where(sel, wi_w, d_c)
        it_n = jax.tree.map(
            lambda a, b: jnp.where(
                go.reshape(go.shape + (1,) * (a.ndim - go.ndim)), a, b
            ), new_it, it_c)
        active_n = go & new_hit.valid
        return (o_n, d_n, it_n, active_n, smp_c), None

    (o2, d2, it2, _, smp), _ = jax.lax.scan(
        step, (o, d, it, it.valid, smp), None, length=max_path_length)
    Le_nd, albedo_nd, direct_nd, smp = _first_hit_channels(
        scene, o2, d2, it2, smp)

    def img3(x):
        return x.reshape(height, width, 3)

    def img1(x):
        return x.reshape(height, width)

    return {
        # reference PTDM modes, same order
        "depth": img1(depth),                    # linear_depth
        "d3d_depth": img1(d3d),                  # D3D_depth
        "v_absdot_n_geo": img1(v_absdot_n_geo),
        "v_dot_n_geo": img1(v_dot_n_geo),
        "v_dot_n_shade": img1(v_dot_n_shade),
        "normal_geo": img3(normal_g),            # n_geo_colored
        "normal_sh": img3(normal_s),             # n_shade_colored
        "uv": img3(uv_aov),
        "bary": img3(bary),
        "emission": img3(Le),                    # first_Le
        "albedo": img3(albedo),                  # first_f
        "direct": img3(direct),                  # first_f_direct
        "emission_non_delta": img3(Le_nd),       # first_non_delta_Le
        "albedo_non_delta": img3(albedo_nd),     # first_non_delta_f
        "direct_non_delta": img3(direct_nd),     # first_non_delta_f_direct
        # extras (not in the reference's mode list)
        "mat_id": img1(mat),
        "prim_id": img1(prim),
    }
