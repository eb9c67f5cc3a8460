"""The Scene pytree — flat struct-of-arrays scene description.

Counterpart of the reference's `KernelDynamicScene`
(Engine/KernelDynamicScene.h:28): where the CUDA build packs buffer views into
__constant__ memory each pass (Kernel/TraceHelper.cu:211-215), here the whole
scene is an immutable pytree of device arrays closed over by (or passed into)
jitted render functions — XLA keeps it resident in device memory, and under
multi-device sharding it is replicated while rays/tiles shard (SURVEY.md
§2.8).

Per-triangle shading attributes are stored in *BVH leaf order* (permuted by
`bvh.tri_index` at build time) so a hit's `prim` index addresses them directly
— the counterpart of the reference's `TriangleData` (Engine/TriangleData.h:10-55)
without the indirection.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..accel import traversal as traversal_mod
from ..accel.bvh import BVH, build_bvh
from ..math import frame as fr
from ..math.frame import Frame
from ..math.vecmath import dot, normalize, safe_sqrt
from . import bsdf as bsdf_mod
from . import lights as lights_mod
from . import textures as tex_mod
from .lights import Lights, build_lights, light_power
from .sensors import Camera
from .textures import Textures


from ._hostcache import (get_host as _get_host, get_specialization,
                         register_host as _register_host,
                         register_specialization)


def get_registered_specialization(scene: "Scene"):
    """PTConfig field dict computed host-side at build time, or None
    (see _hostcache — avoids device readbacks in specialize_config)."""
    return get_specialization(scene.shading.mat_id)


class Materials(NamedTuple):
    """SoA material table (counterpart of Engine/Material.h:38 + BSDF params)."""

    bsdf_type: jnp.ndarray   # (M,) int32
    dist_type: jnp.ndarray   # (M,) int32
    tex_albedo: jnp.ndarray  # (M,) int32 texture id
    tex_specular: jnp.ndarray    # (M,) int32
    tex_transmittance: jnp.ndarray  # (M,) int32
    eta: jnp.ndarray         # (M,)
    cond_eta: jnp.ndarray    # (M, 3)
    cond_k: jnp.ndarray      # (M, 3)
    alpha_u: jnp.ndarray     # (M,)
    alpha_v: jnp.ndarray     # (M,)
    exponent: jnp.ndarray    # (M,)
    nonlinear: jnp.ndarray   # (M,)
    emission: jnp.ndarray    # (M, 3) — area-light materials carry Le
    light_id: jnp.ndarray    # (M,) int32 — light index if emissive else -1
    nested_id: jnp.ndarray   # (M,) int32 — inner material for coating/blend
    blend_weight: jnp.ndarray  # (M,)
    # material maps (Engine/Material.h:38-70): -1 = unused texture slots
    tex_normal: jnp.ndarray  # (M,) int32 normal map (tangent-space RGB)
    tex_height: jnp.ndarray  # (M,) int32 height/bump map
    height_scale: jnp.ndarray  # (M,) HeightScale
    parallax: jnp.ndarray    # (M,) int32 enableParallaxOcclusion
    alpha_mode: jnp.ndarray  # (M,) int32 AlphaBlendState (0=off,1=lum,2=alpha,3=color)
    tex_alpha: jnp.ndarray   # (M,) int32 alpha-test texture
    alpha_ref: jnp.ndarray   # (M,) test_val_scalar
    alpha_ref_color: jnp.ndarray  # (M, 3) test_val_color
    # Cauchy dispersion coefficient C (um^2): n(lambda) = eta + C*(1/l^2 -
    # 1/l_d^2), l_d = 589.3 nm; 0 = achromatic (render/spectral.py)
    cauchy_c: jnp.ndarray    # (M,)
    # Sellmeier coefficients (SceneTypes/Dispersion.h): n^2 = 1 + sum B_i
    # l^2/(l^2 - C_i); any B > 0 selects Sellmeier over Cauchy for the
    # material (render/spectral.py dispersive_eta)
    sellmeier_b: jnp.ndarray  # (M, 3)
    sellmeier_c: jnp.ndarray  # (M, 3)
    # BSSRDF subsurface medium attached to the material (Engine/Material.h:66
    # GetBSSRDF): on refraction into an sss>0 surface the path random-walks
    # the homogeneous interior (render/path_tracer.py _sss_walk)
    sss: jnp.ndarray         # (M,) int32 0/1
    sss_sigma_s: jnp.ndarray  # (M, 3) interior scattering (1/scene unit)
    sss_sigma_a: jnp.ndarray  # (M, 3) interior absorption
    sss_g: jnp.ndarray       # (M,) interior HG anisotropy

    @staticmethod
    def build(records: list[dict]) -> "Materials":
        m = max(len(records), 1)
        out = dict(
            bsdf_type=np.zeros(m, np.int32),
            dist_type=np.full(m, 1, np.int32),  # GGX
            tex_albedo=np.zeros(m, np.int32),
            tex_specular=np.zeros(m, np.int32),
            tex_transmittance=np.zeros(m, np.int32),
            eta=np.full(m, 1.5, np.float32),
            cond_eta=np.tile(np.array([0.2, 0.92, 1.1], np.float32), (m, 1)),
            cond_k=np.tile(np.array([3.9, 2.45, 2.14], np.float32), (m, 1)),
            alpha_u=np.full(m, 0.1, np.float32),
            alpha_v=np.full(m, 0.1, np.float32),
            exponent=np.full(m, 30.0, np.float32),
            nonlinear=np.zeros(m, np.float32),
            emission=np.zeros((m, 3), np.float32),
            light_id=np.full(m, -1, np.int32),
            nested_id=np.zeros(m, np.int32),
            blend_weight=np.full(m, 0.5, np.float32),
            tex_normal=np.full(m, -1, np.int32),
            tex_height=np.full(m, -1, np.int32),
            height_scale=np.ones(m, np.float32),
            parallax=np.zeros(m, np.int32),
            alpha_mode=np.zeros(m, np.int32),
            tex_alpha=np.full(m, -1, np.int32),
            alpha_ref=np.full(m, 0.5, np.float32),
            alpha_ref_color=np.zeros((m, 3), np.float32),
            cauchy_c=np.zeros(m, np.float32),
            sellmeier_b=np.zeros((m, 3), np.float32),
            sellmeier_c=np.ones((m, 3), np.float32) * 1e6,  # far poles
            sss=np.zeros(m, np.int32),
            sss_sigma_s=np.zeros((m, 3), np.float32),
            sss_sigma_a=np.zeros((m, 3), np.float32),
            sss_g=np.zeros(m, np.float32),
        )
        for i, r in enumerate(records):
            for k, v in r.items():
                if k in out:
                    out[k][i] = v
        mats = Materials(**{k: jnp.asarray(v) for k, v in out.items()})
        _register_host(mats.bsdf_type, out)
        return mats


class ShadingData(NamedTuple):
    """Per-(padded/leaf-ordered)-triangle shading attributes."""

    verts: jnp.ndarray     # (T, 3, 3)
    normals: jnp.ndarray   # (T, 3, 3) vertex shading normals
    uvs: jnp.ndarray       # (T, 3, 2)
    mat_id: jnp.ndarray    # (T,) int32
    n_face: jnp.ndarray    # (T, 3) unit geometric normals (precomputed)
    uv_density: jnp.ndarray  # (T,) sqrt(uv area / world area) — ray-cone->mip LOD


class Scene(NamedTuple):
    bvh: BVH
    shading: ShadingData
    materials: Materials
    textures: Textures
    lights: Lights
    light_cdf: jnp.ndarray   # (NL,) normalized power CDF for light selection
    camera: Camera
    env_light_id: jnp.ndarray  # () int32, -1 if no environment light
    # instance-level TLAS (scene/instances.py): per-mesh BLAS tuple + aligned
    # per-mesh InstanceGroup tuple; empty tuples = flattened single-level
    # scene (the default). With instances, `bvh` holds mesh 0's BLAS (its
    # world_min/max are the instance-union world bounds) and `shading` holds
    # the meshes' OBJECT-space tables concatenated in prim_base order.
    blas: tuple = ()
    instances: tuple = ()

    @property
    def n_lights(self) -> int:
        return self.lights.count


def scene_intersect(scene: "Scene", o, d, t_min=1e-4, t_max=jnp.inf,
                    any_hit: bool = False):
    """Closest- or any-hit query against the scene (the scene-level
    traceRay): two-level for instanced scenes, else the BVH intersector."""
    if scene.instances:
        from . import instances as inst_mod

        return inst_mod.intersect_instances(
            scene.blas, scene.instances, o, d, t_min,
            jnp.minimum(jnp.asarray(t_max, jnp.float32), 1e30),
            any_hit=any_hit)
    return traversal_mod.intersect_auto(scene.bvh, o, d, t_min, t_max,
                                        any_hit=any_hit)


def scene_occluded(scene: "Scene", o, d, t_min=1e-4, t_max=jnp.inf):
    return scene_intersect(scene, o, d, t_min, t_max, any_hit=True).valid


class Interaction(NamedTuple):
    """Surface interaction — counterpart of DifferentialGeometry + fillDG
    (Engine/DifferentialGeometry.h:12-47, Kernel/TraceHelper.cu:274-307)."""

    p: jnp.ndarray        # (..., 3) hit point
    n_geo: jnp.ndarray    # (..., 3) geometric normal
    frame: Frame          # shading frame
    uv: jnp.ndarray       # (..., 2)
    t: jnp.ndarray        # (...,) hit distance
    prim: jnp.ndarray     # (...,) int32 leaf-order triangle id
    mat_id: jnp.ndarray   # (...,) int32
    valid: jnp.ndarray    # (...,) bool


def make_interaction(scene: Scene, o, d, hit, flat: bool = False) -> Interaction:
    """Reconstruct shading data at hit points (vectorized fillDG).

    `flat`: static fast path for scenes whose shading normals equal face
    normals and whose UVs are the default barycentric chart — skips the
    per-corner vertex/normal/uv gathers (one (T,3) gather instead of ~100
    bytes/lane; Cornell-class scenes take this path via specialize_config)."""
    inst_id = None
    if scene.instances:
        # instanced scene: decode (instance, shading row) from the packed
        # prim; geometry below comes out in OBJECT space and is mapped to
        # world per lane at the end
        from . import instances as inst_mod

        tpad = inst_mod.instance_tpad(scene.blas)
        inst_id, _, row = inst_mod.decode_hit(scene.instances, tpad, hit)
        hit = hit._replace(prim=jnp.where(hit.valid, row, 0))
        flat = False
    prim = jnp.maximum(hit.prim, 0)
    if flat:
        t_safe = jnp.where(hit.valid & jnp.isfinite(hit.t), hit.t, 1.0)
        p = o + d * t_safe[..., None]
        n = gather_rows(scene.shading.n_face, prim)
        frame = Frame.from_normal(n)
        uv = hit.bary  # default chart: uv == (b1, b2)
        mat_id = scene.shading.mat_id[prim]
        return Interaction(
            p=p, n_geo=n, frame=frame, uv=uv, t=hit.t, prim=prim,
            mat_id=jnp.where(hit.valid, mat_id, 0), valid=hit.valid,
        )
    v = gather_rows(scene.shading.verts, prim)     # (..., 3, 3)
    vn = gather_rows(scene.shading.normals, prim)  # (..., 3, 3)
    uvs = gather_rows(scene.shading.uvs, prim)     # (..., 3, 2)
    b1 = hit.bary[..., 0:1]
    b2 = hit.bary[..., 1:2]
    b0 = 1.0 - b1 - b2

    # Missed lanes carry t = t_max (possibly inf); clamp so p stays finite —
    # inf coordinates poison the backward pass even under where-masks.
    t_safe = jnp.where(hit.valid & jnp.isfinite(hit.t), hit.t, 1.0)
    p = o + d * t_safe[..., None]
    n_geo = normalize(
        jnp.cross(v[..., 1, :] - v[..., 0, :], v[..., 2, :] - v[..., 0, :])
    )
    n_sh = normalize(vn[..., 0, :] * b0 + vn[..., 1, :] * b1 + vn[..., 2, :] * b2)
    # orient geometric normal to shading normal's side consistency
    uv = uvs[..., 0, :] * b0 + uvs[..., 1, :] * b1 + uvs[..., 2, :] * b2

    # tangent from dpdu when UVs are usable, else arbitrary ONB
    duv1 = uvs[..., 1, :] - uvs[..., 0, :]
    duv2 = uvs[..., 2, :] - uvs[..., 0, :]
    e1 = v[..., 1, :] - v[..., 0, :]
    e2 = v[..., 2, :] - v[..., 0, :]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    dpdu = (
        e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2]
    ) / jnp.where(jnp.abs(det) < 1e-9, 1.0, det)[..., None]
    use_uv = (jnp.abs(det) > 1e-9) & (jnp.sum(dpdu * dpdu, axis=-1) > 1e-12)
    s_fallback, _ = (lambda f: (f.s, f.t))(Frame.from_normal(n_sh))
    s_uv = dpdu - n_sh * dot(n_sh, dpdu, keepdims=True)
    s_len = jnp.sqrt(jnp.maximum(jnp.sum(s_uv * s_uv, axis=-1), 1e-18))
    s = jnp.where((use_uv & (s_len > 1e-9))[..., None], s_uv / s_len[..., None], s_fallback)
    t_vec = jnp.cross(n_sh, s)
    frame = Frame(s=s, t=t_vec, n=n_sh)

    mat_id = scene.shading.mat_id[prim]
    if inst_id is not None:
        # object -> world: directions by the to_world linear part
        # (x_w = L @ x_o), normals by the world->object linear part
        # transposed (n_w = L_obj^T @ n_o); p is world already (computed
        # from the world ray and the affine-invariant t)
        from . import instances as inst_mod

        to_obj_f, to_world_f, imat_f, _ = inst_mod.flat_instance_arrays(
            scene.instances)
        Lw = small_gather(to_world_f, inst_id)[..., :, :3]   # (B, 3, 3)
        Lo = small_gather(to_obj_f, inst_id)[..., :, :3]
        hi = jax.lax.Precision.HIGHEST
        n_geo = normalize(jnp.einsum("...ij,...i->...j", Lo, n_geo,
                                     precision=hi))
        n_w = normalize(jnp.einsum("...ij,...i->...j", Lo, frame.n,
                                   precision=hi))
        s_w = jnp.einsum("...ji,...i->...j", Lw, frame.s, precision=hi)
        s_w = normalize(s_w - n_w * dot(n_w, s_w, keepdims=True))
        frame = Frame(s=s_w, t=jnp.cross(n_w, s_w), n=n_w)
        mat_id = small_gather(imat_f, inst_id)
    return Interaction(
        p=p,
        n_geo=n_geo,
        frame=frame,
        uv=uv,
        t=hit.t,
        prim=prim,
        mat_id=jnp.where(hit.valid, mat_id, 0),
        valid=hit.valid,
    )


def gather_rows(table, idx):
    """Row gather as per-component scalar takes: the column slices are
    loop-invariant and XLA hoists them, so each component is a plain
    vectorized (B,) take."""
    lead = table.shape[0]
    flat = table.reshape(lead, -1)
    cols = [jnp.take(flat[:, k], idx, axis=0) for k in range(flat.shape[1])]
    return jnp.stack(cols, axis=-1).reshape(idx.shape + table.shape[1:])


def small_gather(table, idx):
    """Row lookup specialized for tiny tables (material/texture tables are
    typically < 16 rows): a select chain instead of a dynamic gather."""
    n = table.shape[0]
    if n == 1:
        return jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    if n <= 16:
        out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
        for r in range(1, n):
            m = (idx == r)
            out = jnp.where(
                m.reshape(m.shape + (1,) * (table.ndim - 1)), table[r], out
            )
        return out
    return gather_rows(table, idx)


def gather_mat_params(scene: Scene, it: Interaction, tex_types=None,
                      uv_width=None) -> bsdf_mod.MatParams:
    """Gather per-lane material params + evaluate textures (SampleTextures).

    `uv_width`: optional per-lane isotropic texture footprint (uv units) for
    MIP-mapped image lookups (ray-cone LOD selection)."""
    m = scene.materials
    mid = it.mat_id
    g = lambda t: small_gather(t, mid)
    albedo = tex_mod.eval_texture(scene.textures, g(m.tex_albedo), it.uv,
                                  active=tex_types, uv_width=uv_width)
    spec = tex_mod.eval_texture(scene.textures, g(m.tex_specular), it.uv,
                                active=tex_types, uv_width=uv_width)
    trans = tex_mod.eval_texture(scene.textures, g(m.tex_transmittance), it.uv,
                                 active=tex_types, uv_width=uv_width)
    return bsdf_mod.MatParams(
        bsdf_type=g(m.bsdf_type),
        dist_type=g(m.dist_type),
        albedo=albedo,
        specular=spec,
        transmittance=trans,
        eta=g(m.eta),
        cond_eta=g(m.cond_eta),
        cond_k=g(m.cond_k),
        alpha_u=g(m.alpha_u),
        alpha_v=g(m.alpha_v),
        exponent=g(m.exponent),
        nonlinear=g(m.nonlinear),
        blend_weight=g(m.blend_weight),
    )


PARALLAX_STEPS = 16  # fixed-trip replacement for parallaxMin/MaxSamples


def apply_material_maps(scene: Scene, it: Interaction, wo_world,
                        tex_types=None, use_normal: bool = True,
                        use_height: bool = True,
                        use_parallax: bool = True) -> Interaction:
    """Perturb the shading frame by normal/height maps and apply parallax
    occlusion mapping — counterpart of ``Material::SampleNormalMap`` +
    ``parallaxOcclusion`` (Engine/Material.cu:46-139).

    Translation: the reference's early-exit height march becomes a
    fixed-trip unrolled march whose crossing point is found with a running
    argmin mask; all texture fetches are static-shape atlas gathers. Callers
    gate this statically (specialize_config) so unmapped scenes pay nothing.
    """
    m = scene.materials
    mid = it.mat_id
    nm_id = small_gather(m.tex_normal, mid)
    hm_id = small_gather(m.tex_height, mid)
    h_scale = small_gather(m.height_scale, mid)
    use_par = small_gather(m.parallax, mid) > 0
    frame = it.frame
    uv = it.uv

    # --- parallax occlusion (height-map ray march, Material.cu:46-94) ---
    has_hm = hm_id >= 0
    hm_safe = jnp.maximum(hm_id, 0)
    if use_parallax:
        wi_local = frame.to_local(wo_world)  # view dir, surface->eye
        denom = jnp.maximum(wi_local[..., 2], 1e-3)
        par_len = (
            jnp.sqrt(jnp.maximum(1.0 - wi_local[..., 2] ** 2, 0.0)) / denom
        )
        dir2 = wi_local[..., 0:2]
        dir2 = dir2 / jnp.maximum(
            jnp.sqrt(jnp.sum(dir2 * dir2, -1, keepdims=True)), 1e-9
        )
        offset_full = dir2 * (par_len * h_scale)[..., None]
        step = 1.0 / PARALLAX_STEPS
        # march from the surface towards the viewer; record first crossing
        amount = jnp.zeros(uv.shape[:-1], jnp.float32)
        found_x = jnp.zeros(uv.shape[:-1], bool)
        prev_h = jnp.ones(uv.shape[:-1], jnp.float32)
        for k in range(1, PARALLAX_STEPS + 1):
            bound = 1.0 - k * step
            uv_k = uv - offset_full * (k * step)
            h_k = jnp.mean(
                tex_mod.eval_texture(scene.textures, hm_safe, uv_k,
                                     active=tex_types), -1)
            cross = (h_k > bound) & ~found_x
            # secant intersection of the two line segments (Material.cu:88-91)
            d2 = (bound + step) - prev_h
            d1 = bound - h_k
            den = jnp.where(jnp.abs(d2 - d1) < 1e-9, 1.0, d2 - d1)
            amt = (bound * d2 - (bound + step) * d1) / den
            amount = jnp.where(cross, amt, amount)
            found_x = found_x | cross
            prev_h = h_k
        uv_par = uv - offset_full * (1.0 - amount)[..., None]
        uv = jnp.where((has_hm & use_par)[..., None], uv_par, uv)

    n_new = frame.n
    if use_height:
        # --- height-map bump gradient (Material.cu:118-135) ---
        eps_uv = 1.0 / tex_mod.ATLAS_RES
        h0 = jnp.mean(tex_mod.eval_texture(scene.textures, hm_safe, uv,
                                           active=tex_types), -1)
        hu = jnp.mean(tex_mod.eval_texture(
            scene.textures, hm_safe, uv + jnp.asarray([eps_uv, 0.0]),
            active=tex_types), -1)
        hv = jnp.mean(tex_mod.eval_texture(
            scene.textures, hm_safe, uv + jnp.asarray([0.0, eps_uv]),
            active=tex_types), -1)
        ddu = (hu - h0) / eps_uv * h_scale
        ddv = (hv - h0) / eps_uv * h_scale
        dpdu = frame.s + frame.n * ddu[..., None]
        dpdv = frame.t + frame.n * ddv[..., None]
        n_h = normalize(jnp.cross(dpdu, dpdv))
        n_h = n_h * jnp.sign(dot(n_h, frame.n, keepdims=True))
        n_new = jnp.where(has_hm[..., None], n_h, n_new)

    has_nm = nm_id >= 0
    if use_normal:
        # --- tangent-space normal map (Material.cu:96-107) ---
        c = tex_mod.eval_texture(scene.textures, jnp.maximum(nm_id, 0), uv,
                                 active=tex_types)
        n_t = normalize(c - 0.5)
        n_nm = frame.to_world(n_t)
        n_new = jnp.where(has_nm[..., None], n_nm, n_new)
    # re-orthogonalize keeping s as stable as possible (reference rebuilds
    # t = cross(n, s); s = cross(n, t))
    t_new = normalize(jnp.cross(n_new, frame.s))
    s_new = normalize(jnp.cross(n_new, t_new))
    changed = (has_nm | has_hm)[..., None]
    new_frame = Frame(
        s=jnp.where(changed, s_new, frame.s),
        t=jnp.where(changed, t_new, frame.t),
        n=jnp.where(changed, n_new, frame.n),
    )
    return it._replace(frame=new_frame, uv=uv)


def alpha_test(scene: Scene, it: Interaction, tex_types=None):
    """True where the surface is kept (opaque) — ``Material::AlphaTest``.

    Modes (Engine/Material.h:8-22): 1 luminance >= ref, 2 alpha >= ref
    (RGB atlas: alpha falls back to luminance), 3 max|c - ref_color| <= ref.
    """
    m = scene.materials
    mid = it.mat_id
    mode = small_gather(m.alpha_mode, mid) & 3
    tid = small_gather(m.tex_alpha, mid)
    ref = small_gather(m.alpha_ref, mid)
    ref_c = small_gather(m.alpha_ref_color, mid)
    used = (mode > 0) & (tid >= 0)
    c = tex_mod.eval_texture(scene.textures, jnp.maximum(tid, 0), it.uv,
                             active=tex_types)
    lum = 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]
    keep_lum = lum >= ref
    keep_col = jnp.max(jnp.abs(c - ref_c), -1) <= ref
    keep = jnp.where(mode == 3, keep_col, keep_lum)
    return ~used | keep


def hit_shading(scene: Scene, o, d, hit, tex_types=None, uv_width=None,
                flat: bool = False):
    """(Interaction, MatParams) for a hit batch — the shared entry point for
    every light-transport walker (PPM photon/eye walks, BDPT/VCM subpaths,
    the light tracer, guided PT)."""
    it = make_interaction(scene, o, d, hit, flat=flat)
    return it, gather_mat_params(scene, it, tex_types, uv_width=uv_width)


def gather_nested_params(scene: Scene, it: Interaction, tex_types=None,
                         uv_width=None) -> bsdf_mod.MatParams:
    """MatParams of the *inner* material for coating/blend lanes
    (reference BSDF_Complex nesting, one level)."""
    inner = it._replace(mat_id=scene.materials.nested_id[it.mat_id])
    return gather_mat_params(scene, inner, tex_types, uv_width)


def _scene_cache_path(cache_key: str) -> str:
    import os

    from .. import CACHE_ROOT

    d = os.path.join(CACHE_ROOT, "scenes")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, cache_key + ".npz")


_SCENE_CACHE_VERSION = 4.0  # bump when the cached BVH array layout changes


def _verts_fingerprint(vertices: np.ndarray) -> np.ndarray:
    """Cheap content check for cache validity: shape + strided samples +
    format version."""
    flat = vertices.reshape(-1)
    idx = np.linspace(0, flat.shape[0] - 1, 64).astype(np.int64)
    return np.concatenate([[np.float32(_SCENE_CACHE_VERSION)],
                           [np.float32(flat.shape[0])], flat[idx]])


def build_scene(
    vertices: np.ndarray,
    normals: np.ndarray | None,
    uvs: np.ndarray | None,
    mat_id: np.ndarray,
    materials: Materials,
    textures: Textures,
    light_records: list[dict],
    camera: Camera,
    env_map: np.ndarray | None = None,
    cache_key: str | None = None,
) -> Scene:
    """Host-side scene assembly: builds the BVH, permutes shading data into
    leaf order, derives the light-selection CDF (DynamicScene::UpdateScene
    equivalent, Engine/DynamicScene.cpp:480-556).

    `cache_key`: optional name under which the built BVH arrays are
    npz-cached on disk (counterpart of the reference's compiled-mesh cache,
    Engine/MeshLoader/MeshCompiler.h:9-11). The cache is validated against a
    fingerprint of the vertex data."""
    vertices = np.asarray(vertices, np.float32)
    T = vertices.shape[0]
    if normals is None:
        e1 = vertices[:, 1] - vertices[:, 0]
        e2 = vertices[:, 2] - vertices[:, 0]
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        normals = np.repeat(n[:, None, :], 3, axis=1)
    if uvs is None:
        uvs = np.zeros((T, 3, 2), np.float32)
        uvs[:, 1, 0] = 1.0
        uvs[:, 2, 1] = 1.0
    mat_id = np.asarray(mat_id, np.int32)

    bvh = host = None
    fp = _verts_fingerprint(vertices)
    if cache_key is not None:
        try:
            with np.load(_scene_cache_path(cache_key)) as z:
                if np.array_equal(z["fingerprint"], fp):
                    order = z["order"]
                    bvh = BVH(
                        nodes=jnp.asarray(z["nodes"]),
                        woop=jnp.asarray(z["woop"]),
                        tri_index=jnp.asarray(order),
                        root_code=np.int32(z["root"]),
                        world_min=vertices.reshape(-1, 3).min(axis=0),
                        world_max=vertices.reshape(-1, 3).max(axis=0),
                    )
                    host = {"nodes": z["nodes"], "woop": z["woop"],
                            "root": int(z["root"]), "order": order,
                            "tris": vertices[order]}
        except (OSError, KeyError, ValueError):
            bvh = None
    if bvh is None:
        bvh, host = build_bvh(vertices, with_host=True)
        if cache_key is not None:
            arrs = dict(fingerprint=fp, nodes=host["nodes"],
                        woop=host["woop"], root=np.int32(host["root"]),
                        order=host["order"])
            try:
                np.savez(_scene_cache_path(cache_key), **arrs)
            except OSError:
                pass
    order = host["order"]
    v_ord = vertices[order]
    nf = np.cross(v_ord[:, 1] - v_ord[:, 0], v_ord[:, 2] - v_ord[:, 0])
    nf = nf / np.maximum(np.linalg.norm(nf, axis=-1, keepdims=True), 1e-12)
    uv_ord = np.asarray(uvs, np.float32)[order]
    duv1 = uv_ord[:, 1] - uv_ord[:, 0]
    duv2 = uv_ord[:, 2] - uv_ord[:, 0]
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    w_area = 0.5 * np.linalg.norm(
        np.cross(v_ord[:, 1] - v_ord[:, 0], v_ord[:, 2] - v_ord[:, 0]), axis=-1
    )
    uv_density = np.sqrt(uv_area / np.maximum(w_area, 1e-20))
    shading = ShadingData(
        verts=jnp.asarray(v_ord),
        normals=jnp.asarray(np.asarray(normals, np.float32)[order]),
        uvs=jnp.asarray(uv_ord),
        mat_id=jnp.asarray(mat_id[order]),
        n_face=jnp.asarray(nf.astype(np.float32)),
        uv_density=jnp.asarray(uv_density.astype(np.float32)),
    )

    # host-side bounds: pure host data, so never read them back from the
    # device
    world_min = vertices.reshape(-1, 3).min(axis=0)
    world_max = vertices.reshape(-1, 3).max(axis=0)
    center = 0.5 * (world_min + world_max)
    radius = 0.5 * float(np.linalg.norm(world_max - world_min)) + 1e-4

    lights = build_lights(light_records, center, radius, env_map)
    power = light_power(lights)
    if len(light_records) == 0:
        power = jnp.zeros_like(power)
    cdf = jnp.cumsum(power) / jnp.maximum(jnp.sum(power), 1e-20)

    env_id = -1
    for i, r in enumerate(light_records):
        if r["type"] in (lights_mod.INFINITE, lights_mod.CONSTANT_ENV):
            env_id = i

    # ---- host-side static specialization (specialize_config counterpart,
    # computed here from the numpy inputs so no device readbacks happen) ----
    mat_host = _get_host(materials.bsdf_type)
    tex_host = _get_host(textures.ttype)
    if mat_host is not None and tex_host is not None:
        used = np.unique(mat_id)
        used = np.unique(np.concatenate([used, mat_host["nested_id"][used]]))
        bsdf_types = tuple(sorted(int(x) for x in
                                  np.unique(mat_host["bsdf_type"][used])))
        lt = sorted({int(r["type"]) for r in light_records}) or [0]
        map_ids = np.concatenate([
            mat_host["tex_normal"][used], mat_host["tex_height"][used],
            mat_host["tex_alpha"][used],
        ])
        tex_ids = np.unique(np.concatenate([
            mat_host["tex_albedo"][used], mat_host["tex_specular"][used],
            mat_host["tex_transmittance"][used], map_ids[map_ids >= 0],
        ]))
        tex_types = tuple(sorted(int(x) for x in
                                 np.unique(tex_host["ttype"][tex_ids])))
        flat = bool(
            np.allclose(np.asarray(normals, np.float32)[order],
                        nf[:, None, :], atol=1e-5)
            and np.allclose(uv_ord[:, 0], 0.0)
            and np.allclose(uv_ord[:, 1], [1.0, 0.0])
            and np.allclose(uv_ord[:, 2], [0.0, 1.0])
        )
        register_specialization(shading.mat_id, dict(
            bsdf_types=bsdf_types,
            light_types=tuple(lt),
            tex_types=tex_types,
            flat_shading=flat,
            normal_maps=bool((mat_host["tex_normal"][used] >= 0).any()),
            height_maps=bool((mat_host["tex_height"][used] >= 0).any()),
            parallax=bool((mat_host["tex_height"][used] >= 0).any()
                          and (mat_host["parallax"][used] > 0).any()),
            alpha_test=bool(((mat_host["alpha_mode"][used] > 0)
                             & (mat_host["tex_alpha"][used] >= 0)).any()),
            sss=bool((mat_host["sss"][used] > 0).any()),
        ))
    return Scene(
        bvh=bvh,
        shading=shading,
        materials=materials,
        textures=textures,
        lights=lights,
        light_cdf=cdf,
        camera=camera,
        env_light_id=jnp.asarray(np.int32(env_id)),
    )
