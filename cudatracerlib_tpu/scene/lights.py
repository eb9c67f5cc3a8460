"""Light sources: SoA table, direct sampling, emission eval, ray sampling.

Counterpart of reference ``SceneTypes/Light.h`` (PointLight:34, DiffuseLight
area light over ShapeSet:96, DistantLight:145, SpotLight:226, InfiniteLight
env map:294-369) and the scene-level power-CDF light selection
(Engine/KernelDynamicScene.cu:25-46).

Design: one flat SoA table for all lights; area lights reference a global
pool of emissive triangles with a padded per-light CDF (static shapes). The
environment light importance-samples a 2-D luminance CDF over an equirect map.
All emission quantities are differentiable (the BASELINE "light gradients"
requirement).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..math import montecarlo as mc
from ..math import warp
from ..math.vecmath import (
    INV_FOURPI,
    INV_PI,
    INV_TWOPI,
    PI,
    cross,
    dot,
    length,
    normalize,
    safe_sqrt,
)
from ..sampling.records import AREA, DISCRETE, SOLID_ANGLE, DirectSample

POINT = 0
SPOT = 1
DISTANT = 2
AREA_LIGHT = 3
INFINITE = 4     # environment map
CONSTANT_ENV = 5

MAX_LIGHT_TRIS = 64   # per-light CDF padding (Cornell-style area lights are tiny)
ENV_RES_Y = 64        # environment CDF resolution (theta); phi = 2*ENV_RES_Y


class Lights(NamedTuple):
    ltype: jnp.ndarray        # (NL,) int32
    position: jnp.ndarray     # (NL, 3) point/spot pos; distant/area unused
    direction: jnp.ndarray    # (NL, 3) spot/distant direction (unit)
    radiance: jnp.ndarray     # (NL, 3) area/env radiance, point/spot intensity, distant irradiance
    spot_cos_width: jnp.ndarray   # (NL,)
    spot_cos_falloff: jnp.ndarray # (NL,)
    # area lights: emissive triangle pool
    tri_first: jnp.ndarray    # (NL,) int32 into tri pool
    tri_count: jnp.ndarray    # (NL,) int32
    tri_cdf: jnp.ndarray      # (NL, MAX_LIGHT_TRIS) per-light area CDF
    area: jnp.ndarray         # (NL,) total area
    # shared emissive-triangle pool (NTL >= 1)
    tris: jnp.ndarray         # (NTL, 3, 3) vertices
    tri_n: jnp.ndarray        # (NTL, 3) geometric normals (unit)
    # environment
    env_map: jnp.ndarray      # (H, W, 3) equirect radiance (H=1 dummy if unused)
    # precomputed env importance tables (build_lights; detached sampling
    # densities — recomputing them per sample costs a (B, W) row gather +
    # per-lane cumsum every bounce)
    env_w: jnp.ndarray        # (H, W) luminance * sin(theta) weights
    env_row_cdf: jnp.ndarray  # (H,) marginal row CDF
    env_col_cdf: jnp.ndarray  # (H, W) per-row conditional CDFs
    env_total: jnp.ndarray    # () sum of env_w
    # world bounds for distant/env ray sampling
    world_center: jnp.ndarray # (3,)
    world_radius: jnp.ndarray # ()

    @property
    def count(self) -> int:
        return self.ltype.shape[0]


def _small_gather(table, idx):
    """Row gather specialized for tiny tables: a select chain instead of a
    dynamic gather when the table has <= 8 rows (typical area-light
    triangle pools)."""
    n = table.shape[0]
    if n == 1:
        return jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    if n <= 8:
        out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
        for r in range(1, n):
            m = (idx == r)
            out = jnp.where(m.reshape(m.shape + (1,) * (table.ndim - 1)), table[r], out)
        return out
    from .scene import gather_rows

    return gather_rows(table, idx)


def _tri_areas(tris):
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    return 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)


def build_lights(records: list[dict], world_center, world_radius,
                 env_map: np.ndarray | None = None) -> Lights:
    """Host-side constructor. Each record: {type, position, direction, radiance,
    cos_width, cos_falloff, tris (K,3,3 for area lights)}."""
    nl = max(len(records), 1)
    ltype = np.zeros(nl, np.int32)
    pos = np.zeros((nl, 3), np.float32)
    dirn = np.tile(np.array([0, 0, -1], np.float32), (nl, 1))
    rad = np.zeros((nl, 3), np.float32)
    cw = np.full(nl, np.cos(np.radians(20.0)), np.float32)
    cf = np.full(nl, np.cos(np.radians(15.0)), np.float32)
    tri_first = np.zeros(nl, np.int32)
    tri_count = np.zeros(nl, np.int32)
    max_tris = 4
    for r in records:
        if r["type"] == AREA_LIGHT:
            max_tris = max(max_tris, int(np.asarray(r["tris"]).shape[0]))
    width = 1 << (max_tris - 1).bit_length()  # pad CDF rows to next pow2
    assert width <= MAX_LIGHT_TRIS, "increase MAX_LIGHT_TRIS"
    tri_cdf = np.tile((np.arange(width, dtype=np.float32) + 1) / width, (nl, 1))
    area = np.zeros(nl, np.float32)
    pool: list[np.ndarray] = []

    for i, r in enumerate(records):
        ltype[i] = r["type"]
        pos[i] = np.asarray(r.get("position", [0, 0, 0]), np.float32)
        d = np.asarray(r.get("direction", [0, 0, -1]), np.float32)
        dirn[i] = d / max(np.linalg.norm(d), 1e-12)
        rad[i] = np.asarray(r.get("radiance", [1, 1, 1]), np.float32)
        cw[i] = r.get("cos_width", cw[i])
        cf[i] = r.get("cos_falloff", cf[i])
        if r["type"] == AREA_LIGHT:
            tris = np.asarray(r["tris"], np.float32)
            assert tris.shape[0] <= MAX_LIGHT_TRIS, "increase MAX_LIGHT_TRIS"
            tri_first[i] = sum(p.shape[0] for p in pool)
            tri_count[i] = tris.shape[0]
            pool.append(tris)
            e1 = tris[:, 1] - tris[:, 0]
            e2 = tris[:, 2] - tris[:, 0]
            a = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            area[i] = a.sum()
            cdf = np.cumsum(a) / max(a.sum(), 1e-12)
            tri_cdf[i, : len(cdf)] = cdf
            tri_cdf[i, len(cdf):] = 1.0

    if pool:
        tris_all = np.concatenate(pool, axis=0)
    else:
        tris_all = np.zeros((1, 3, 3), np.float32)
        tris_all[0, 1, 0] = 1e-6
        tris_all[0, 2, 1] = 1e-6
    e1 = tris_all[:, 1] - tris_all[:, 0]
    e2 = tris_all[:, 2] - tris_all[:, 0]
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    env = env_map if env_map is not None else np.zeros((1, 2, 3), np.float32)
    env = np.asarray(env, np.float32)
    eh, ew = env.shape[0], env.shape[1]
    lum = (0.212671 * env[..., 0] + 0.715160 * env[..., 1]
           + 0.072169 * env[..., 2])
    sin_rows = np.sin((np.arange(eh, dtype=np.float32) + 0.5) / eh * np.pi)
    env_w = np.maximum(lum * sin_rows[:, None], 1e-12).astype(np.float32)
    row_w = env_w.sum(axis=1)
    env_row_cdf = (np.cumsum(row_w) / max(row_w.sum(), 1e-12)).astype(np.float32)
    env_col_cdf = (np.cumsum(env_w, axis=1)
                   / np.maximum(env_w.sum(axis=1, keepdims=True), 1e-12)
                   ).astype(np.float32)

    return Lights(
        ltype=jnp.asarray(ltype),
        position=jnp.asarray(pos),
        direction=jnp.asarray(dirn),
        radiance=jnp.asarray(rad),
        spot_cos_width=jnp.asarray(cw),
        spot_cos_falloff=jnp.asarray(cf),
        tri_first=jnp.asarray(tri_first),
        tri_count=jnp.asarray(tri_count),
        tri_cdf=jnp.asarray(tri_cdf),
        area=jnp.asarray(area),
        tris=jnp.asarray(tris_all),
        tri_n=jnp.asarray(n.astype(np.float32)),
        env_map=jnp.asarray(env),
        env_w=jnp.asarray(env_w),
        env_row_cdf=jnp.asarray(env_row_cdf),
        env_col_cdf=jnp.asarray(env_col_cdf),
        env_total=jnp.asarray(np.float32(env_w.sum())),
        world_center=jnp.asarray(np.asarray(world_center, np.float32)),
        world_radius=jnp.asarray(np.float32(world_radius)),
    )


def light_power(lights: Lights):
    """Approximate emitted power per light, for the selection CDF
    (reference uses the same power weighting)."""
    lum = (
        0.212671 * lights.radiance[:, 0]
        + 0.715160 * lights.radiance[:, 1]
        + 0.072169 * lights.radiance[:, 2]
    )
    wr = jnp.maximum(lights.world_radius, 1e-6)
    p_point = 4.0 * PI * lum
    p_spot = 2.0 * PI * (1.0 - lights.spot_cos_width) * lum
    p_dist = PI * wr * wr * lum
    p_area = PI * lights.area * lum
    env_mean = jnp.mean(
        0.212671 * lights.env_map[..., 0]
        + 0.715160 * lights.env_map[..., 1]
        + 0.072169 * lights.env_map[..., 2]
    )
    p_env = 4.0 * PI * PI * wr * wr * jnp.where(lights.ltype == INFINITE, env_mean, lum)
    t = lights.ltype
    p = jnp.where(t == POINT, p_point, 0.0)
    p = jnp.where(t == SPOT, p_spot, p)
    p = jnp.where(t == DISTANT, p_dist, p)
    p = jnp.where(t == AREA_LIGHT, p_area, p)
    p = jnp.where((t == INFINITE) | (t == CONSTANT_ENV), p_env, p)
    return jnp.maximum(p, 0.0)


def _spot_falloff(lights: Lights, lid, w_local):
    """Smooth spot falloff between falloff and width angles (Light.h SpotLight)."""
    cd = -dot(w_local, lights.direction[lid])  # w_local points light->shading pt? see usage
    cw = lights.spot_cos_width[lid]
    cf = lights.spot_cos_falloff[lid]
    t = jnp.clip((cd - cw) / jnp.maximum(cf - cw, 1e-6), 0.0, 1.0)
    return jnp.where(cd < cw, 0.0, jnp.where(cd > cf, 1.0, t * t * (3.0 - 2.0 * t)))


def sample_direct(lights: Lights, lid, ref_p, u2, active=None):
    """Sample a direction from `ref_p` toward light `lid` (batched).

    Returns (DirectSample, radiance (..,3)) with pdf w.r.t. solid angle at ref_p
    (delta lights report their discrete density as pdf=1 per reference
    convention; MIS treats them as non-matchable). Counterpart of
    KernelDynamicScene::sampleEmitterDirect (Engine/KernelDynamicScene.h:59-108).
    """
    t = lights.ltype[lid]
    wr = jnp.maximum(lights.world_radius, 1e-6)

    def on(*types):
        return active is None or any(x in active for x in types)

    zero = jnp.zeros(jnp.shape(t), jnp.float32)
    zero3 = jnp.zeros(jnp.shape(t) + (3,), jnp.float32)

    # ---- point / spot ----
    if on(POINT, SPOT):
        to_l = lights.position[lid] - ref_p
        dist2_p = jnp.maximum(dot(to_l, to_l), 1e-12)
        dist_p = jnp.sqrt(dist2_p)
        d_point = to_l / dist_p[..., None]
        rad_point = lights.radiance[lid] / dist2_p[..., None]
        fall = _spot_falloff(lights, lid, d_point)
        rad_spot = rad_point * fall[..., None]
    else:
        dist_p, d_point, rad_point, rad_spot = zero, zero3, zero3, zero3

    # ---- distant ----
    d_dist = -lights.direction[lid]
    rad_distant = lights.radiance[lid]

    # ---- area: pick a triangle from the per-light CDF, uniform point on it ----
    if on(AREA_LIGHT):
        cdf_rows = lights.tri_cdf[lid]
        tri_sel, pmf, u_re = mc.sample_discrete(cdf_rows, u2[..., 0])
        tri_id = jnp.clip(lights.tri_first[lid] + tri_sel, 0, lights.tris.shape[0] - 1)
        v = _small_gather(lights.tris, tri_id)
        bary = warp.square_to_uniform_triangle(
            jnp.stack([u_re, u2[..., 1]], axis=-1)
        )
        p_area = (
            v[..., 0, :] * (1.0 - bary[..., 0:1] - bary[..., 1:2])
            + v[..., 1, :] * bary[..., 0:1]
            + v[..., 2, :] * bary[..., 1:2]
        )
        n_area = _small_gather(lights.tri_n, tri_id)
        to_a = p_area - ref_p
        dist2_a = jnp.maximum(dot(to_a, to_a), 1e-12)
        dist_a = jnp.sqrt(dist2_a)
        d_area = to_a / dist_a[..., None]
        cos_l = -dot(d_area, n_area)
        # area pdf (1/total area) -> solid angle
        pdf_area = dist2_a / jnp.maximum(jnp.abs(cos_l) * jnp.maximum(lights.area[lid], 1e-12), 1e-12)
        front = cos_l > 0.0
        rad_area = jnp.where(front[..., None], lights.radiance[lid], 0.0)
    else:
        dist_a, d_area, n_area, p_area = zero, zero3, zero3, zero3
        pdf_area, rad_area = zero, zero3

    # ---- environment (importance over the map for INFINITE, uniform for CONSTANT) ----
    if on(INFINITE, CONSTANT_ENV):
        d_env, pdf_env, rad_env = _sample_env(lights, lid, u2)
    else:
        d_env, pdf_env, rad_env = zero3, zero, zero3

    is_delta_t = (t == POINT) | (t == SPOT) | (t == DISTANT)
    d = jnp.where((t == POINT)[..., None] | (t == SPOT)[..., None], d_point, d_dist)
    d = jnp.where((t == AREA_LIGHT)[..., None], d_area, d)
    d = jnp.where(((t == INFINITE) | (t == CONSTANT_ENV))[..., None], d_env, d)

    dist = jnp.where((t == POINT) | (t == SPOT), dist_p, 2.0 * wr)
    dist = jnp.where(t == AREA_LIGHT, dist_a, dist)

    pdf = jnp.where(is_delta_t, 1.0, 0.0)
    pdf = jnp.where(t == AREA_LIGHT, pdf_area, pdf)
    pdf = jnp.where((t == INFINITE) | (t == CONSTANT_ENV), pdf_env, pdf)

    rad = jnp.where((t == POINT)[..., None], rad_point, rad_spot)
    rad = jnp.where((t == DISTANT)[..., None], rad_distant, rad)
    rad = jnp.where((t == AREA_LIGHT)[..., None], rad_area, rad)
    rad = jnp.where(((t == INFINITE) | (t == CONSTANT_ENV))[..., None], rad_env, rad)

    measure = jnp.where(is_delta_t, DISCRETE, SOLID_ANGLE).astype(jnp.int32)
    n_out = jnp.where((t == AREA_LIGHT)[..., None], n_area, -d)
    p_out = jnp.where(
        (t == AREA_LIGHT)[..., None],
        p_area,
        ref_p + d * dist[..., None],
    )
    ds = DirectSample(
        p=p_out, n=n_out, d=d, dist=dist, pdf=pdf, measure=measure,
        uv=jnp.zeros(d.shape[:-1] + (2,), jnp.float32),
    )
    return ds, rad


def _env_uv_from_dir(d):
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * PI, phi)
    return jnp.stack([phi * INV_TWOPI, theta * INV_PI], axis=-1)  # (u, v), v=0 at +z pole


def eval_env(lights: Lights, lid, d):
    """Environment radiance along direction d (reference EvalEnvironment)."""
    t = lights.ltype[lid]
    H, W = lights.env_map.shape[0], lights.env_map.shape[1]
    uv = _env_uv_from_dir(d)
    x = jnp.clip((uv[..., 0] * W).astype(jnp.int32), 0, W - 1)
    y = jnp.clip((uv[..., 1] * H).astype(jnp.int32), 0, H - 1)
    env = _env_fetch_rgb(lights.env_map, y, x) * lights.radiance[lid]
    return jnp.where(
        (t == INFINITE)[..., None], env,
        jnp.where((t == CONSTANT_ENV)[..., None], lights.radiance[lid], 0.0),
    )


def pdf_env_dir(lights: Lights, lid, d):
    """Solid-angle pdf of `_sample_env` for direction d (for MIS)."""
    t = lights.ltype[lid]
    pdf_const = INV_FOURPI * jnp.ones(d.shape[:-1], jnp.float32)
    # INFINITE importance pdf: luminance-weighted over equirect with sin(theta)
    H, W = lights.env_w.shape[0], lights.env_w.shape[1]
    uv = _env_uv_from_dir(d)
    x = jnp.clip((uv[..., 0] * W).astype(jnp.int32), 0, W - 1)
    y = jnp.clip((uv[..., 1] * H).astype(jnp.int32), 0, H - 1)
    w_yx = jnp.take(lights.env_w.reshape(-1), y * W + x)
    total = jnp.maximum(lights.env_total, 1e-12)
    sin_theta = jnp.maximum(jnp.sin(uv[..., 1] * PI), 1e-6)
    # p(dir) = p(u,v) / (2 pi^2 sin(theta)); p(u,v) = w[y,x] * H * W / total
    pdf_inf = w_yx * H * W / total / (2.0 * PI * PI * sin_theta)
    return jnp.where(t == INFINITE, pdf_inf, jnp.where(t == CONSTANT_ENV, pdf_const, 0.0))


def _env_fetch_rgb(env_map, y, x):
    """env_map[y, x] as 3 per-channel flat takes."""
    H, W = env_map.shape[0], env_map.shape[1]
    flat = env_map.reshape(H * W, 3)
    idx = y * W + x
    return jnp.stack([jnp.take(flat[:, c], idx) for c in range(3)], axis=-1)


def _sample_env(lights: Lights, lid, u2):
    """Importance-sample the environment (2-D luminance CDF for INFINITE,
    reference InfiniteLight Light.h:294-369; uniform sphere for CONSTANT).

    Uses the build-time tables (env_row_cdf / env_col_cdf / env_w): the row
    CDF is shared (one searchsorted), the conditional column CDF row is
    materialized per lane by a one-hot contraction at HIGHEST precision, and
    the column index plus its pmf come from (B, W) element-wise comparisons
    — no per-lane row gather, no per-lane cumsum."""
    H, W = lights.env_w.shape[0], lights.env_w.shape[1]
    y, pmf_row, uy = mc.sample_discrete(lights.env_row_cdf, u2[..., 1])
    oh_y = jax.nn.one_hot(y, H, dtype=jnp.float32)          # (B, H)
    # HIGHEST precision makes the one-hot product exact: at DEFAULT a GPU
    # contracts f32 in TF32, which rounds the CDF row to 10 mantissa bits,
    # while pdf_env_dir computes the MIS counter-density from the exact
    # env_w table — a mismatched pair biases BSDF-vs-NEE MIS weights on
    # wide maps.
    row_cdf = jnp.matmul(oh_y, lights.env_col_cdf,
                         precision=jax.lax.Precision.HIGHEST)  # (B, W)
    u0 = u2[..., 0]
    below = (row_cdf < u0[..., None]) & (jnp.arange(W) < W - 1)
    x = jnp.sum(below.astype(jnp.int32), axis=-1)
    hi = jnp.min(jnp.where(below, jnp.inf, row_cdf), axis=-1)
    lo = jnp.max(jnp.where(below, row_cdf, 0.0), axis=-1)
    pmf_col = jnp.maximum(hi - lo, 1e-12)
    ux = jnp.clip((u0 - lo) / pmf_col, 0.0, 1.0 - 1e-6)
    # continuous position within the texel
    u = (x.astype(jnp.float32) + ux) / W
    v = (y.astype(jnp.float32) + uy) / H
    theta = v * PI
    phi = u * 2.0 * PI
    st = jnp.sin(theta)
    d_inf = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)
    pdf_inf = pmf_row * pmf_col * H * W / (
        2.0 * PI * PI * jnp.maximum(st, 1e-6)
    )
    rad_inf = _env_fetch_rgb(lights.env_map, y, x) * lights.radiance[lid]

    d_const = warp.square_to_uniform_sphere(u2)
    t = lights.ltype[lid]
    is_inf = t == INFINITE
    d = jnp.where(is_inf[..., None], d_inf, d_const)
    pdf = jnp.where(is_inf, pdf_inf, INV_FOURPI)
    rad = jnp.where(is_inf[..., None], rad_inf, lights.radiance[lid])
    return d, pdf, rad


def eval_area_emission(lights: Lights, lid, n, wo):
    """Radiance leaving an area light surface toward wo (front side only)."""
    front = dot(n, wo) > 0.0
    return jnp.where(
        ((lights.ltype[lid] == AREA_LIGHT) & front)[..., None],
        lights.radiance[lid],
        0.0,
    )


def pdf_direct_area(lights: Lights, lid, ref_p, p, n):
    """Solid-angle pdf of sample_direct for a point p on area light lid (MIS)."""
    to_p = p - ref_p
    dist2 = jnp.maximum(dot(to_p, to_p), 1e-12)
    d = to_p / jnp.sqrt(dist2)[..., None]
    cos_l = jnp.abs(dot(d, n))
    pdf = dist2 / jnp.maximum(cos_l * jnp.maximum(lights.area[lid], 1e-12), 1e-12)
    return jnp.where(lights.ltype[lid] == AREA_LIGHT, pdf, 0.0)


def sample_emitter_ray(lights: Lights, lid, u_pos, u_dir):
    """Sample an emitted ray (position + direction) with combined pdf and
    initial power weight — the photon/light-tracing entry point
    (reference sampleEmitterRay / AbstractEmitter::sampleRay).

    Returns (origin, direction, power_weight (..,3)) where power_weight =
    Le * cos / (pdf_pos * pdf_dir) so a particle process can just multiply.
    """
    t = lights.ltype[lid]
    wr = jnp.maximum(lights.world_radius, 1e-6)

    # point: uniform sphere
    d_point = warp.square_to_uniform_sphere(u_dir)
    w_point = lights.radiance[lid] * (4.0 * PI)

    # spot: uniform cone
    d_cone_local = warp.square_to_uniform_cone(u_dir, lights.spot_cos_width[lid])
    from ..math.frame import Frame

    f_spot = Frame.from_normal(lights.direction[lid])
    d_spot = f_spot.to_world(d_cone_local)
    fall = _spot_falloff(lights, lid, -d_spot)
    w_spot = (
        lights.radiance[lid]
        * fall[..., None]
        / jnp.maximum(
            warp.square_to_uniform_cone_pdf(lights.spot_cos_width[lid]), 1e-12
        )[..., None]
    )

    # distant: disk perpendicular to direction covering world sphere
    disk = warp.square_to_uniform_disk_concentric(u_pos) * wr
    f_dist = Frame.from_normal(lights.direction[lid])
    o_dist = (
        lights.world_center
        + f_dist.to_world(jnp.stack([disk[..., 0], disk[..., 1], jnp.zeros_like(disk[..., 0])], axis=-1))
        - lights.direction[lid] * wr
    )
    w_dist = lights.radiance[lid] * (PI * wr * wr)

    # area: uniform point + cosine direction
    cdf_rows = lights.tri_cdf[lid]
    tri_sel, _, u_re = mc.sample_discrete(cdf_rows, u_pos[..., 0])
    tri_id = jnp.clip(lights.tri_first[lid] + tri_sel, 0, lights.tris.shape[0] - 1)
    v = lights.tris[tri_id]
    bary = warp.square_to_uniform_triangle(jnp.stack([u_re, u_pos[..., 1]], axis=-1))
    p_area = (
        v[..., 0, :] * (1.0 - bary[..., 0:1] - bary[..., 1:2])
        + v[..., 1, :] * bary[..., 0:1]
        + v[..., 2, :] * bary[..., 1:2]
    )
    n_area = lights.tri_n[tri_id]
    f_area = Frame.from_normal(n_area)
    d_area = f_area.to_world(warp.square_to_cosine_hemisphere(u_dir))
    w_area = lights.radiance[lid] * (PI * lights.area[lid])[..., None]  # Le*A*pi

    # env: sample dir from map, origin on world-sphere disk facing -d
    d_env, pdf_env, rad_env = _sample_env(lights, lid, u_dir)
    d_env = -d_env  # emitted toward the scene
    f_env = Frame.from_normal(d_env)
    disk_e = warp.square_to_uniform_disk_concentric(u_pos) * wr
    o_env = (
        lights.world_center
        + f_env.to_world(jnp.stack([disk_e[..., 0], disk_e[..., 1], jnp.zeros_like(disk_e[..., 0])], axis=-1))
        - d_env * wr
    )
    w_env = rad_env * (PI * wr * wr / jnp.maximum(pdf_env, 1e-12))[..., None]

    is_pt = (t == POINT)[..., None]
    is_sp = (t == SPOT)[..., None]
    is_di = (t == DISTANT)[..., None]
    is_ar = (t == AREA_LIGHT)[..., None]
    is_env = ((t == INFINITE) | (t == CONSTANT_ENV))[..., None]

    o = jnp.where(is_pt | is_sp, lights.position[lid], lights.world_center)
    o = jnp.where(is_di, o_dist, o)
    o = jnp.where(is_ar, p_area + n_area * 1e-4, o)
    o = jnp.where(is_env, o_env, o)

    d = jnp.where(is_pt, d_point, d_spot)
    d = jnp.where(is_di, lights.direction[lid] + jnp.zeros_like(d_point), d)
    d = jnp.where(is_ar, d_area, d)
    d = jnp.where(is_env, d_env, d)

    w = jnp.where(is_pt, w_point, w_spot)
    w = jnp.where(is_di, w_dist, w)
    w = jnp.where(is_ar, w_area, w)
    w = jnp.where(is_env, w_env, w)
    return o, d, w
