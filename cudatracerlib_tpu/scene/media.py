"""Participating media: homogeneous + dense-grid volumes.

Counterpart of reference ``SceneTypes/Volumes.h:289`` (HomogeneousVolumeDensity
:54, VolumeGrid with per-channel sigma_a/sigma_s/Le trilinear dense grids
:116-184, KernelAggregateVolume union of <=16 volumes :339-395):
sigma_a/sigma_s/Le lookups, transmittance `tau`, volume emission `Lve`, and
distance sampling.

Design: one SoA table of <=16 volumes; grid data lives in a single flat
f32 buffer with per-volume (offset, resolution, channel-count) records, so
every volume keeps its LOAD-TIME resolution (no resampling) and each of
sigma_a / sigma_s / Le can carry its own scalar or RGB grid — the reference's
``DenseVolGrid`` trio. Lookups are 8-corner flat gathers (never `grid[vid]`,
which would materialize a full R^3 grid per query). Everything is
differentiable w.r.t. sigma/albedo/Le AND the grid voxels themselves
(BASELINE config 4's "transmittance gradients").
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..math.vecmath import dot, safe_sqrt
from ..sampling.rng import Sampler
from ._hostcache import get_host as _get_host, register_host as _register_host

HOMOGENEOUS = 0
GRID = 1

GRID_RES = 32   # default resolution for procedurally built grids (loaders
                # keep native resolution; nothing is resampled any more)
MAX_VOLUMES = 16  # aggregate capacity (reference KernelAggregateVolume <=16)
TAU_STEPS = 32  # fixed quadrature steps along a segment


class Media(NamedTuple):
    active: jnp.ndarray     # (V,) int32 0/1
    vtype: jnp.ndarray      # (V,) int32
    sigma_a: jnp.ndarray    # (V, 3) base absorption (grid multiplies this)
    sigma_s: jnp.ndarray    # (V, 3) base scattering
    le: jnp.ndarray         # (V, 3) base emission
    phase_type: jnp.ndarray # (V,) int32 (scene/phase.py tags)
    phase_g: jnp.ndarray    # (V,)
    box_min: jnp.ndarray    # (V, 3)
    box_max: jnp.ndarray    # (V, 3)
    # per-channel dense grids, flat-packed at native resolution:
    grid_data: jnp.ndarray  # (TOTAL,) f32; index 0 holds 1.0 (dummy)
    res: jnp.ndarray        # (V, 3) int32 grid resolution (1,1,1) if none
    off_a: jnp.ndarray      # (V,) int32 offset of sigma_a grid, -1 = constant
    off_s: jnp.ndarray      # (V,) int32 offset of sigma_s grid, -1 = constant
    off_le: jnp.ndarray     # (V,) int32 offset of Le grid, -1 = constant
    ch_a: jnp.ndarray       # (V,) int32 channels (1 or 3)
    ch_s: jnp.ndarray       # (V,) int32
    ch_le: jnp.ndarray      # (V,) int32
    maj_a: jnp.ndarray      # (V,) f32 max sigma_a-grid value (1 if constant)
    maj_s: jnp.ndarray      # (V,) f32 max sigma_s-grid value

    @property
    def count(self) -> int:
        return self.active.shape[0]

    @staticmethod
    def build(records: list[dict]) -> "Media":
        """Records: {type, sigma_a, sigma_s, le, phase_type, phase_g,
        box_min, box_max} plus, for GRID volumes, any of
          density        — legacy single scalar grid applied to sigma_a AND
                           sigma_s (reference VolumeGrid single-grid mode)
          sigma_a_grid / sigma_s_grid / le_grid
                         — (rx, ry, rz) scalar or (rx, ry, rz, 3) RGB arrays
                           at arbitrary (native) resolution.
        All grids of one volume must share a resolution.

        The SoA tables are sized by the ACTUAL record count (shape
        specialization: a 1-volume scene compiles 1-volume programs), with
        MAX_VOLUMES as the aggregate capacity cap."""
        assert len(records) <= MAX_VOLUMES, "aggregate capacity is 16 volumes"
        v = max(len(records), 1)
        out = dict(
            active=np.zeros(v, np.int32),
            vtype=np.zeros(v, np.int32),
            sigma_a=np.zeros((v, 3), np.float32),
            sigma_s=np.zeros((v, 3), np.float32),
            le=np.zeros((v, 3), np.float32),
            phase_type=np.zeros(v, np.int32),
            phase_g=np.zeros(v, np.float32),
            box_min=np.zeros((v, 3), np.float32),
            box_max=np.ones((v, 3), np.float32),
        )
        res = np.ones((v, 3), np.int32)
        off = {k: np.full(v, -1, np.int32) for k in ("a", "s", "le")}
        ch = {k: np.ones(v, np.int32) for k in ("a", "s", "le")}
        maj_a = np.ones(v, np.float32)
        maj_s = np.ones(v, np.float32)
        pool: list[np.ndarray] = [np.ones(1, np.float32)]  # dummy slot 0
        total = 1

        def push(arr) -> tuple[int, int, tuple[int, int, int], float]:
            nonlocal total
            a = np.asarray(arr, np.float32)
            if a.ndim == 3:
                nch, rshape = 1, a.shape
                flat = a.reshape(-1)
            else:
                assert a.ndim == 4 and a.shape[-1] == 3, "grid must be 3-D or 3-D RGB"
                nch, rshape = 3, a.shape[:3]
                # channel-major layout: [c][x][y][z]
                flat = np.moveaxis(a, -1, 0).reshape(-1)
            o = total
            pool.append(flat)
            total += flat.size
            return o, nch, rshape, float(a.max(initial=0.0))

        for i, r in enumerate(records):
            out["active"][i] = 1
            out["vtype"][i] = r.get("type", HOMOGENEOUS)
            out["sigma_a"][i] = r.get("sigma_a", [0.1] * 3)
            out["sigma_s"][i] = r.get("sigma_s", [0.1] * 3)
            out["le"][i] = r.get("le", [0.0] * 3)
            out["phase_type"][i] = r.get("phase_type", 0)
            out["phase_g"][i] = r.get("phase_g", 0.0)
            out["box_min"][i] = r.get("box_min", [0, 0, 0])
            out["box_max"][i] = r.get("box_max", [1, 1, 1])
            rres = None
            if "density" in r:  # legacy: one grid drives both sigma_a and sigma_s
                o, nch, rres, mx = push(r["density"])
                off["a"][i] = off["s"][i] = o
                ch["a"][i] = ch["s"][i] = nch
                maj_a[i] = maj_s[i] = mx
            if "sigma_a_grid" in r:
                o, nch, rres2, mx = push(r["sigma_a_grid"])
                assert rres is None or rres == rres2
                rres = rres2
                off["a"][i], ch["a"][i], maj_a[i] = o, nch, mx
            if "sigma_s_grid" in r:
                o, nch, rres2, mx = push(r["sigma_s_grid"])
                assert rres is None or rres == rres2
                rres = rres2
                off["s"][i], ch["s"][i], maj_s[i] = o, nch, mx
            if "le_grid" in r:
                o, nch, rres2, _ = push(r["le_grid"])
                assert rres is None or rres == rres2
                rres = rres2
                off["le"][i], ch["le"][i] = o, nch
            if rres is not None:
                res[i] = rres

        media = Media(
            **{k: jnp.asarray(x) for k, x in out.items()},
            grid_data=jnp.asarray(np.concatenate(pool)),
            res=jnp.asarray(res),
            off_a=jnp.asarray(off["a"]), off_s=jnp.asarray(off["s"]),
            off_le=jnp.asarray(off["le"]),
            ch_a=jnp.asarray(ch["a"]), ch_s=jnp.asarray(ch["s"]),
            ch_le=jnp.asarray(ch["le"]),
            maj_a=jnp.asarray(maj_a), maj_s=jnp.asarray(maj_s),
        )
        # host-side static per-volume structure (see media_static): lets the
        # sampling/transmittance code compile per-volume fast paths with NO
        # device readbacks (same pattern as scene._hostcache specialization)
        _register_host(media.grid_data, dict(
            vtype=out["vtype"].copy(),
            off_a=off["a"].copy(), off_s=off["s"].copy(),
            off_le=off["le"].copy(),
            ch_a=ch["a"].copy(), ch_s=ch["s"].copy(), ch_le=ch["le"].copy(),
            res=res.copy(),
        ))
        return media

    @staticmethod
    def empty() -> "Media":
        return Media.build([])


def _ray_box(box_min, box_max, o, d, t_min, t_max):
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t0 = (box_min - o) * inv
    t1 = (box_max - o) * inv
    near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
    far = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), t_max)
    return near, far, near < far


def _grid_lookup(media: Media, vid, p, off, nch):
    """Trilinear (..., 3) lookup of one per-volume grid channel set.

    `off`/`nch` are the per-ray gathered offset/channel arrays. The 8 corner
    fetches (x3 channels) index the FLAT grid_data buffer with scalar ids —
    never `grid[vid]`, which would materialize a full R^3 grid per query
    point (a (B, R, R, R) temp: tens of GB at bench batch sizes). Grids with
    off < 0 return 1.0. Scalar grids (nch==1) broadcast via a 0 channel
    stride."""
    lo = media.box_min[vid]
    hi = media.box_max[vid]
    r = media.res[vid]  # (..., 3) int32
    rf = r.astype(jnp.float32)
    q = (p - lo) / jnp.maximum(hi - lo, 1e-9) * (rf - 1)
    q = jnp.clip(q, 0.0, jnp.maximum(rf - 1, 0.0) * (1 - 1e-6))
    i0 = jnp.floor(q).astype(jnp.int32)
    f = q - i0
    i1 = jnp.minimum(i0 + 1, r - 1)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    r3 = rx * ry * rz
    has = off >= 0
    base = jnp.where(has, off, 0)
    cstride = jnp.where(nch == 3, r3, 0)  # scalar grids broadcast
    flat = media.grid_data

    def corner(ax, ay, az):
        # per-channel (B,) flat gathers. Scalar grids (cstride == 0) still
        # issue 3 gathers, each a plain vectorized take.
        sp = (ax * ry + ay) * rz + az
        return jnp.stack(
            [jnp.take(flat, base + cstride * c + sp) for c in range(3)],
            axis=-1,
        )  # (..., 3)

    c000 = corner(i0[..., 0], i0[..., 1], i0[..., 2])
    c100 = corner(i1[..., 0], i0[..., 1], i0[..., 2])
    c010 = corner(i0[..., 0], i1[..., 1], i0[..., 2])
    c110 = corner(i1[..., 0], i1[..., 1], i0[..., 2])
    c001 = corner(i0[..., 0], i0[..., 1], i1[..., 2])
    c101 = corner(i1[..., 0], i0[..., 1], i1[..., 2])
    c011 = corner(i0[..., 0], i1[..., 1], i1[..., 2])
    c111 = corner(i1[..., 0], i1[..., 1], i1[..., 2])
    fx = f[..., 0:1]
    fy = f[..., 1:2]
    fz = f[..., 2:3]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return jnp.where(has[..., None], val, 1.0)


def _inside(media: Media, vid, p):
    ins = jnp.all((p >= media.box_min[vid]) & (p <= media.box_max[vid]), axis=-1)
    return ins & (media.active[vid] > 0)


# ---------------------------------------------------------------------------
# Static per-volume fast paths (round 4).
#
# Media.build registers the host-side structure (vtype / grid offsets /
# channel counts) in scene._hostcache keyed by the grid_data array. The hot
# paths below use it to compile per-volume specializations:
#   * HOMOGENEOUS / constant fields: no gathers at all (the generic path
#     issued 24 gathers per lookup that a jnp.where then discarded);
#   * "density" grids (one shared scalar grid for sigma_a and sigma_s — the
#     reference VolumeGrid single-grid mode): ONE 8-gather scalar trilinear
#     lookup per point instead of 2 fields x 3 channels x 8 corners.
# Delta-tracking iterations and the 32-step tau quadrature are both
# per-point-lookup bound, so these lookups are the volume path's hot spot.
# ---------------------------------------------------------------------------


def media_static(media: Media):
    """Host-registered static structure, or None for hand-built pytrees /
    traced values (inside jit the leaves are tracers, so this returns None —
    use `static_modes` host-side and thread the result in as a static arg)."""
    try:
        return _get_host(media.grid_data)
    except TypeError:
        return None


def static_modes(media: Media):
    """Hashable per-volume mode tuple for static specialization, or None.

    Entry: (kind, off, le_off) with kind in
      'const'  — homogeneous or constant-field volume (zero gathers)
      'scalar' — one shared scalar grid drives sigma_a AND sigma_s at `off`
      'gen'    — distinct / RGB grids (generic gather path)
    le_off: -1 = constant emission, else the Le grid offset (generic path).
    MUST be called host-side on a concrete Media (it keys on array identity)
    and passed into jitted code as a STATIC argument (PTConfig.media_modes).
    """
    info = media_static(media)
    if info is None:
        return None
    out = []
    for v in range(media.count):
        le_off = int(info["off_le"][v])
        if info["vtype"][v] != GRID or (
                info["off_a"][v] < 0 and info["off_s"][v] < 0):
            out.append(("const", -1, le_off))
        elif (info["off_a"][v] == info["off_s"][v] and info["ch_a"][v] == 1
              and info["ch_s"][v] == 1):
            out.append(("scalar", int(info["off_a"][v]), le_off))
        else:
            out.append(("gen", -1, le_off))
    return tuple(out)


def _inside_v(media: Media, v: int, p):
    ins = jnp.all((p >= media.box_min[v]) & (p <= media.box_max[v]), axis=-1)
    return ins & (media.active[v] > 0)


def _grid_lookup1(media: Media, v: int, off: int, p):
    """(B,) scalar trilinear lookup of volume v's grid at offset `off`: 8
    corner gathers (on an H100 58x faster than a separable one-hot
    contraction at HIGHEST precision, PERF.md)."""
    lo = media.box_min[v]
    hi = media.box_max[v]
    r = media.res[v]
    rf = r.astype(jnp.float32)
    q = (p - lo) / jnp.maximum(hi - lo, 1e-9) * (rf - 1)
    q = jnp.clip(q, 0.0, jnp.maximum(rf - 1, 0.0) * (1 - 1e-6))
    i0 = jnp.floor(q).astype(jnp.int32)
    f = q - i0
    i1 = jnp.minimum(i0 + 1, r - 1)
    ry, rz = r[1], r[2]
    flat = media.grid_data

    def corner(ax, ay, az):
        return jnp.take(flat, off + (ax * ry + ay) * rz + az)

    c000 = corner(i0[..., 0], i0[..., 1], i0[..., 2])
    c100 = corner(i1[..., 0], i0[..., 1], i0[..., 2])
    c010 = corner(i0[..., 0], i1[..., 1], i0[..., 2])
    c110 = corner(i1[..., 0], i1[..., 1], i0[..., 2])
    c001 = corner(i0[..., 0], i0[..., 1], i1[..., 2])
    c101 = corner(i1[..., 0], i0[..., 1], i1[..., 2])
    c011 = corner(i0[..., 0], i1[..., 1], i1[..., 2])
    c111 = corner(i1[..., 0], i1[..., 1], i1[..., 2])
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _sigma_pair_v(media: Media, v: int, p, mode):
    """(sigma_s, sigma_t) (..., 3) contribution of volume v at p, using the
    statically-known mode entry. Falls back to the generic gather path only
    for distinct / RGB grids."""
    ins = _inside_v(media, v, p)[..., None]
    zero3 = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    base_s = media.sigma_s[v]
    base_t = media.sigma_s[v] + media.sigma_a[v]
    kind = mode[0]
    if kind == "const":
        s_s = jnp.where(ins, base_s, 0.0) + zero3
        s_t = jnp.where(ins, base_t, 0.0) + zero3
        return s_s, s_t
    if kind == "scalar":
        D = _grid_lookup1(media, v, mode[1], p)[..., None]
        s_s = jnp.where(ins, base_s * D, 0.0)
        s_t = jnp.where(ins, base_t * D, 0.0)
        return s_s, s_t
    vid = jnp.full(p.shape[:-1], v, jnp.int32)
    s_s = sigma_s_at(media, vid, p)
    s_t = s_s + sigma_a_at(media, vid, p)
    return s_s, s_t


def _le_v(media: Media, v: int, p, mode):
    """Volume emission contribution of volume v at p (static fast path)."""
    if mode is None or mode[2] >= 0:
        vid = jnp.full(p.shape[:-1], v, jnp.int32)
        return le_at(media, vid, p)
    ins = _inside_v(media, v, p)[..., None]
    return jnp.where(ins, media.le[v], 0.0) + jnp.zeros(
        p.shape[:-1] + (3,), jnp.float32)


def _mult(media: Media, vid, p, off_field, ch_field):
    """(..., 3) grid multiplier for one quantity; 1 outside GRID volumes."""
    is_grid = media.vtype[vid] == GRID
    m = _grid_lookup(media, vid, p, off_field[vid], ch_field[vid])
    return jnp.where(is_grid[..., None], m, 1.0)


def density_at(media: Media, vid, p):
    """Scalar (channel-mean sigma_a-grid) density multiplier at p — legacy
    single-grid semantics used by photon-beam estimators."""
    m = jnp.mean(_mult(media, vid, p, media.off_a, media.ch_a), axis=-1)
    return jnp.where(_inside(media, vid, p), m, 0.0)


def sigma_a_at(media: Media, vid, p):
    ins = _inside(media, vid, p)[..., None]
    return jnp.where(ins, media.sigma_a[vid] * _mult(media, vid, p, media.off_a, media.ch_a), 0.0)


def sigma_s_at(media: Media, vid, p):
    ins = _inside(media, vid, p)[..., None]
    return jnp.where(ins, media.sigma_s[vid] * _mult(media, vid, p, media.off_s, media.ch_s), 0.0)


def sigma_t_at(media: Media, vid, p):
    return sigma_a_at(media, vid, p) + sigma_s_at(media, vid, p)


def le_at(media: Media, vid, p):
    """Volume emission Lve (reference VolumeRegion::Lve, Volumes.h)."""
    ins = _inside(media, vid, p)[..., None]
    return jnp.where(ins, media.le[vid] * _mult(media, vid, p, media.off_le, media.ch_le), 0.0)


def tau_segment(media: Media, vid, o, d, t0, t1):
    """Per-channel optical depth along [t0, t1] — closed form for homogeneous,
    fixed-step midpoint quadrature for grids (reference VolumeRegion::tau;
    here a static step count, differentiable).

    The quadrature is a lax.scan over steps so every grid lookup stays at
    (B, 3) instead of materializing a (B, STEPS, 3) batch."""
    seg = jnp.maximum(t1 - t0, 0.0)
    st = media.sigma_a[vid] + media.sigma_s[vid]
    tau_h = st * seg[..., None]
    dt = seg / TAU_STEPS

    def step(acc, i):
        t = t0 + (i + 0.5) * dt
        p = o + d * t[..., None]
        st_p = media.sigma_a[vid] * _mult(media, vid, p, media.off_a, media.ch_a) \
            + media.sigma_s[vid] * _mult(media, vid, p, media.off_s, media.ch_s)
        return acc + st_p, None

    tau_g, _ = jax.lax.scan(
        step, jnp.zeros(seg.shape + (3,), jnp.float32),
        jnp.arange(TAU_STEPS, dtype=jnp.float32))
    tau_g = tau_g * dt[..., None]
    return jnp.where((media.vtype[vid] == GRID)[..., None], tau_g, tau_h)


def segment_in_media(media: Media, o, d, t_min, t_max):
    """True where the ray segment overlaps any active volume's box."""
    inside = jnp.zeros(o.shape[:-1], bool)
    for v in range(media.count):
        near, far, hit = _ray_box(media.box_min[v], media.box_max[v], o, d,
                                  t_min, t_max)
        inside = inside | (hit & (media.active[v] > 0))
    return inside


def sigma_at(media: Media, p, modes=None):
    """(sigma_s (..., 3), sigma_t (..., 3)) summed over all active volumes
    at world point p (aggregate-volume union semantics). `modes`: static
    per-volume specialization from `static_modes` (threaded through
    PTConfig.media_modes — see that docstring)."""
    ss = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    st = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    for v in range(media.count):
        if modes is not None:
            s_s, s_t = _sigma_pair_v(media, v, p, modes[v])
        else:
            vid = jnp.full(p.shape[:-1], v, jnp.int32)
            s_s = sigma_s_at(media, vid, p)
            s_t = s_s + sigma_a_at(media, vid, p)
        ss = ss + s_s
        st = st + s_t
    return ss, st


def transmittance(media: Media, o, d, t_min, t_max, modes=None):
    """Total transmittance over all active volumes along [t_min, t_max]
    (KernelAggregateVolume union semantics, Volumes.h:339-395). `modes`:
    static per-volume specialization from `static_modes`."""
    tr = jnp.ones(o.shape[:-1] + (3,), jnp.float32)
    for v in range(media.count):
        near, far, hit = _ray_box(media.box_min[v], media.box_max[v], o, d, t_min, t_max)
        seg = jnp.maximum(far - near, 0.0)
        if modes is not None and modes[v][0] == "const":
            # homogeneous / constant: closed form, zero gathers
            tau = (media.sigma_a[v] + media.sigma_s[v]) * seg[..., None]
        elif modes is not None and modes[v][0] == "scalar":
            # shared scalar density grid: quadrature of the SCALAR field,
            # then scale by the per-channel base sigma_t (8 gathers per
            # step instead of 48)
            dt = seg / TAU_STEPS
            off = modes[v][1]

            def step(acc, i):
                t = near + (i + 0.5) * dt
                pt = o + d * t[..., None]
                return acc + _grid_lookup1(media, v, off, pt), None

            acc, _ = jax.lax.scan(
                step, jnp.zeros(seg.shape, jnp.float32),
                jnp.arange(TAU_STEPS, dtype=jnp.float32))
            tau = (media.sigma_a[v] + media.sigma_s[v]) \
                * (acc * dt)[..., None]
        else:
            vid = jnp.full(o.shape[:-1], v, jnp.int32)
            tau = tau_segment(media, vid, o, d, near, jnp.maximum(far, near))
        act = hit & (media.active[v] > 0)
        tr = tr * jnp.where(act[..., None], jnp.exp(-tau), 1.0)
    return tr


def sample_distance(media: Media, o, d, t_min, t_max, sampler: Sampler,
                    modes=None):
    """Sample a scattering distance against the UNION of all volumes
    (KernelAggregateVolume::sampleDistance semantics, Volumes.h:339-395).

    Null-collision (delta/Woodcock) tracking under a per-ray union majorant:
    candidates are drawn from Exp(majorant) over the union extent; each is a
    REAL collision with probability sigma_t(p)/majorant, else a null
    collision and tracking continues — so disjoint stacked volumes, gaps
    between boxes, overlaps, and arbitrary-resolution grids are all sampled
    without bias. Homogeneous single-volume rays accept the first candidate
    (ratio == 1), reproducing the closed form exactly.

    Returns (sampler, t, scatter, weight (..,3), vid, p_scatter, emit):
    weight = sigma_s * Tr / pdf for medium events, Tr / pdf(pass) for
    pass-through; `emit` = Tr * sigma_a * Le / pdf at the collision — an
    unbiased single-sample estimator of the emitted radiance integral Lve.
    The realized decision sequence's pdf is DETACHED while Tr and the sigmas
    stay attached, so autodiff of the fixed-noise estimator matches finite
    differences (the BASELINE transmittance-gradient gate).

    Tracking runs under a while_loop until every lane terminates (hard cap
    HARD_TRACK_CAP = 256 candidate events): round 2 used a fixed 8/16-step
    scan whose exhausted lanes were silently weighted as pass-through —
    for majorant-dominated grids (one hot voxel: majorant 50, extent 2)
    that produced a measured background of 0.992 vs true transmittance
    0.905 and scattered 0.8% of rays instead of ~9.5% (round-2 advisor
    finding). The while_loop pays only the steps the slowest live lane
    needs; the cap would require majorant * extent > ~128 to bite.
    """
    B = o.shape[:-1]
    V = media.count

    # union extent + summed majorant over active volumes hit by the segment
    u_near = jnp.full(B, jnp.inf)
    u_far = jnp.zeros(B)
    maj = jnp.zeros(B)
    any_hit = jnp.zeros(B, bool)
    for v in range(V):
        near, far, hitb = _ray_box(media.box_min[v], media.box_max[v], o, d, t_min, t_max)
        act = hitb & (media.active[v] > 0)
        u_near = jnp.where(act, jnp.minimum(u_near, near), u_near)
        u_far = jnp.where(act, jnp.maximum(u_far, far), u_far)
        is_grid = media.vtype[v] == GRID
        bound_v = jnp.mean(media.sigma_a[v]) * jnp.where(is_grid, media.maj_a[v], 1.0) \
            + jnp.mean(media.sigma_s[v]) * jnp.where(is_grid, media.maj_s[v], 1.0)
        maj = maj + jnp.where(act, bound_v, 0.0)
        any_hit = any_hit | act

    in_vol = any_hit
    # sanitize inf sentinels before they enter differentiable math (inf * 0
    # becomes NaN in the backward pass even under where-masks)
    u_near = jnp.where(in_vol, u_near, 0.0)
    u_far = jnp.where(in_vol, u_far, 0.0)
    maj = jax.lax.stop_gradient(jnp.maximum(maj, 1e-6))

    class _T(NamedTuple):
        t: jnp.ndarray        # current tracking position
        tracking: jnp.ndarray # still marching
        real: jnp.ndarray     # terminated with a real collision
        smp: Sampler

    class _TW(NamedTuple):
        t: jnp.ndarray
        tracking: jnp.ndarray
        real: jnp.ndarray
        smp: Sampler
        steps: jnp.ndarray

    HARD_TRACK_CAP = 256
    o_det = jax.lax.stop_gradient(o)
    d_det = jax.lax.stop_gradient(d)
    init = _TW(t=jax.lax.stop_gradient(u_near), tracking=in_vol,
               real=jnp.zeros(B, bool), smp=sampler, steps=jnp.int32(0))

    def track_cond(c: _TW):
        return jnp.any(c.tracking) & (c.steps < HARD_TRACK_CAP)

    def track(c: _TW):
        s, u = c.smp.next_1d()
        dt = -jnp.log(jnp.maximum(1.0 - u, 1e-12)) / maj
        t_new = c.t + dt
        esc_now = c.tracking & (t_new >= jax.lax.stop_gradient(u_far))
        p = o_det + d_det * jnp.where(c.tracking, t_new, c.t)[..., None]
        _, st = sigma_at(media, p, modes)
        ratio = jax.lax.stop_gradient(
            jnp.clip(jnp.mean(st, axis=-1) / maj, 0.0, 1.0))
        s, u2 = s.next_1d()
        real_now = c.tracking & ~esc_now & (u2 < ratio)
        null_now = c.tracking & ~esc_now & ~real_now
        return _TW(
            t=jnp.where(c.tracking & ~esc_now, t_new, c.t),
            tracking=null_now,
            real=c.real | real_now,
            smp=s,
            steps=c.steps + 1,
        )

    fin = jax.lax.while_loop(track_cond, track, init)
    sampler = fin.smp

    scatter = in_vol & fin.real
    t_s = jnp.where(scatter, jax.lax.stop_gradient(fin.t),
                    jnp.minimum(jax.lax.stop_gradient(t_max), 1e7))
    p_s = jax.lax.stop_gradient(o) + jax.lax.stop_gradient(d) * t_s[..., None]

    # Delta tracking draws the real collision from the EXACT marginal
    # density mean_sigma_t(t) * exp(-tau_mean(t)) and passes with probability
    # exp(-tau_mean(full span)) — where mean is over channels, the field the
    # accept decisions used. So weight with attached per-channel
    # transmittance over DETACHED marginal pdfs (tau_mean = channel-mean of
    # -log Tr): value ~1, gradients flow through Tr and the sigmas.
    t_end = jnp.where(scatter, t_s, jnp.minimum(t_max, 1e7))
    tr = transmittance(media, o, d, t_min, t_end, modes)
    tr = jnp.where(in_vol[..., None], tr, 1.0)
    log_tr_det = jax.lax.stop_gradient(jnp.log(jnp.maximum(tr, 1e-30)))
    tr_det_mean = jnp.exp(jnp.mean(log_tr_det, axis=-1))

    # scattering coefficient + emission, summed over overlapping volumes at
    # p. Lve is an emission coefficient per unit length — the reference adds
    # vol.Lve(x,w)*d with no sigma_a factor (PointStorage.h:185), so scenes
    # port over with identical emitted radiance.
    ss_p, st_p = sigma_at(media, p_s, modes)
    emit_p = jnp.zeros(p_s.shape[:-1] + (3,), jnp.float32)
    for v in range(V):
        emit_p = emit_p + _le_v(media, v, p_s,
                                None if modes is None else modes[v])

    st_mean_det = jax.lax.stop_gradient(jnp.maximum(jnp.mean(st_p, -1), 1e-9))
    pdf = jnp.where(scatter, st_mean_det * tr_det_mean, tr_det_mean)
    inv_pdf = 1.0 / jnp.maximum(pdf, 1e-12)
    w_scatter = ss_p * tr * inv_pdf[..., None]
    w_pass = tr * inv_pdf[..., None]
    weight = jnp.where(scatter[..., None], w_scatter, w_pass)
    weight = jnp.where(in_vol[..., None], weight, 1.0)
    emit = jnp.where(scatter[..., None], emit_p * tr * inv_pdf[..., None], 0.0)

    # representative volume at the collision point (phase-function params):
    # where volumes overlap, pick one stochastically in proportion to its
    # sigma_s at p (the scatter weight sums sigma_s over all containing
    # volumes, so the aggregate phase function must be the sigma_s-weighted
    # mixture — reference KernelAggregateVolume::Sample per-volume records)
    sampler, u_vid = sampler.next_1d()
    ss_total = jnp.maximum(jnp.mean(ss_p, axis=-1), 1e-20)
    acc = jnp.zeros(B, jnp.float32)
    vid = jnp.zeros(B, jnp.int32)
    chosen = jnp.zeros(B, bool)
    for v in range(V):
        if modes is not None:
            w_v = jnp.mean(_sigma_pair_v(media, v, p_s, modes[v])[0], axis=-1)
        else:
            vv = jnp.full(B, v, jnp.int32)
            w_v = jnp.where(_inside(media, vv, p_s),
                            jnp.mean(sigma_s_at(media, vv, p_s), axis=-1), 0.0)
        acc = acc + jax.lax.stop_gradient(w_v) / ss_total
        take = ~chosen & (u_vid < acc + 1e-7) & (w_v > 0)
        vid = jnp.where(take, v, vid)
        chosen = chosen | take
    return sampler, t_s, scatter, weight, vid, p_s, emit
