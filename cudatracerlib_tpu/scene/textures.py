"""Texture system: SoA texture table + MIP-mapped evaluation.

Counterpart of reference ``SceneTypes/Texture.h:247`` (ConstantTexture:107,
CheckerboardTexture:127, BilerpTexture:77, ImageTexture:159, UVTexture:185,
WireframeTexture:209) and the MIPMap sampler (``Engine/MIPMap_device.h``:
wrap modes :10-17, filter modes :19-25, ``Sample(uv, width)`` trilinear and
``eval(uv, d0, d1)`` EWA).

Design: all textures of a scene live in one SoA table indexed by texture
id; image data lives in a fixed-size *mip pyramid atlas* — every layer is
resampled to ATLAS_RES² at load, downsampled to a full pyramid, and the
pyramid levels are flattened into one (L, TOTAL, 3) array so any
(layer, level, x, y) fetch is a static-shape flat gather (dynamic mip level
becomes address arithmetic, not a ragged lookup). The reference's EWA loop
has a data-dependent trip count (hostile to XLA); anisotropic filtering here
is the fixed-tap probe scheme GPUs use in hardware: N trilinear probes along
the major footprint axis at the LOD of the minor axis. Evaluation is
differentiable w.r.t. colors and the atlas texels.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

CONSTANT = 0
CHECKERBOARD = 1
IMAGE = 2
UV = 3
WIREFRAME = 4
BILERP = 5

# wrap modes (MIPMap_device.h:10-17)
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
WRAP_BLACK = 3

# filter modes (MIPMap_device.h:19-25)
FILTER_POINT = 0
FILTER_BILINEAR = 1
FILTER_ANISOTROPIC = 2
FILTER_TRILINEAR = 3

ATLAS_RES = 256  # each image layer is resampled to ATLAS_RES^2 at load time
N_LEVELS = ATLAS_RES.bit_length()  # 256 -> 9 levels (256..1)
_LEVEL_RES = [ATLAS_RES >> m for m in range(N_LEVELS)]
_LEVEL_OFFSETS = np.cumsum([0] + [r * r for r in _LEVEL_RES[:-1]]).astype(np.int32)
ATLAS_TOTAL = int(_LEVEL_OFFSETS[-1] + _LEVEL_RES[-1] ** 2)
N_ANISO_PROBES = 4  # fixed-tap anisotropic filtering (replaces the EWA loop)


class Textures(NamedTuple):
    ttype: jnp.ndarray       # (NT,) int32
    color_a: jnp.ndarray     # (NT, 3) — constant value / checker color 0 / scale for image
    color_b: jnp.ndarray     # (NT, 3) — checker color 1
    uv_xform: jnp.ndarray    # (NT, 4): (su, sv, du, dv) TextureMapping2D (Texture.h:15)
    image_id: jnp.ndarray    # (NT,) int32 into atlas layers
    wrap_mode: jnp.ndarray   # (NT,) int32 ImageWrap
    filter_mode: jnp.ndarray # (NT,) int32 ImageFilter
    atlas: jnp.ndarray       # (L, ATLAS_TOTAL, 3) flattened mip pyramids

    @staticmethod
    def build(records: list[dict], images: list[np.ndarray] | None = None) -> "Textures":
        """Host-side constructor from a list of texture dicts."""
        nt = max(len(records), 1)
        ttype = np.zeros(nt, np.int32)
        ca = np.ones((nt, 3), np.float32)
        cb = np.zeros((nt, 3), np.float32)
        uvx = np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (nt, 1))
        iid = np.zeros(nt, np.int32)
        wrap = np.zeros(nt, np.int32)
        filt = np.full(nt, FILTER_TRILINEAR, np.int32)
        for i, r in enumerate(records):
            ttype[i] = r.get("type", CONSTANT)
            ca[i] = np.asarray(r.get("color_a", [1, 1, 1]), np.float32)
            cb[i] = np.asarray(r.get("color_b", [0, 0, 0]), np.float32)
            uvx[i] = np.asarray(r.get("uv_xform", [1, 1, 0, 0]), np.float32)
            iid[i] = r.get("image_id", 0)
            wrap[i] = r.get("wrap_mode", WRAP_REPEAT)
            filt[i] = r.get("filter_mode", FILTER_TRILINEAR)
        if images:
            layers = [
                build_pyramid(_resample(np.asarray(img, np.float32), ATLAS_RES))
                for img in images
            ]
            atlas = np.stack(layers)
        else:
            atlas = np.ones((1, ATLAS_TOTAL, 3), np.float32)
        tex = Textures(
            ttype=jnp.asarray(ttype),
            color_a=jnp.asarray(ca),
            color_b=jnp.asarray(cb),
            uv_xform=jnp.asarray(uvx),
            image_id=jnp.asarray(iid),
            wrap_mode=jnp.asarray(wrap),
            filter_mode=jnp.asarray(filt),
            atlas=jnp.asarray(atlas),
        )
        from ._hostcache import register_host

        register_host(tex.ttype, {"ttype": ttype})
        return tex


def _resample(img: np.ndarray, res: int) -> np.ndarray:
    """Nearest-neighbour resample to the atlas resolution (host side)."""
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w = img.shape[:2]
    yi = (np.arange(res) * h // res).clip(0, h - 1)
    xi = (np.arange(res) * w // res).clip(0, w - 1)
    return img[np.ix_(yi, xi)][..., :3].astype(np.float32)


def build_pyramid(level0: np.ndarray) -> np.ndarray:
    """Box-filter mip pyramid of a (R, R, 3) image, flattened to (TOTAL, 3).

    Counterpart of the reference's mip generation in MIPMap compilation
    (Engine/MIPMap.cpp); 2x2 averaging per level like its box downsample.
    """
    levels = [level0]
    cur = level0
    for _ in range(N_LEVELS - 1):
        r = cur.shape[0] // 2
        cur = cur.reshape(r, 2, r, 2, 3).mean(axis=(1, 3))
        levels.append(cur)
    return np.concatenate([lv.reshape(-1, 3) for lv in levels], axis=0)


def _wrap_float(u, mode):
    """Wrap a float texture coordinate into [0,1) per ImageWrap mode
    (MIPMap_device.h WrapCoordinates). BLACK is handled by the caller mask."""
    rep = u - jnp.floor(u)
    cla = jnp.clip(u, 0.0, 1.0)
    period = u - 2.0 * jnp.floor(u * 0.5)      # in [0, 2)
    mir = 1.0 - jnp.abs(period - 1.0)
    out = rep
    out = jnp.where(mode == WRAP_CLAMP, cla, out)
    out = jnp.where(mode == WRAP_MIRROR, mir, out)
    out = jnp.where(mode == WRAP_BLACK, cla, out)
    return out


def _fetch_texels(atlas, layer, level, xi, yi):
    """Fetch texels at integer coords of a dynamic mip level.

    addr = level_offset + y * res + x in the flattened pyramid; moved as
    per-component scalar takes.
    """
    offs = jnp.asarray(_LEVEL_OFFSETS)
    res = jnp.int32(ATLAS_RES) >> level
    addr = offs[level] + yi * res + xi
    gaddr = layer * ATLAS_TOTAL + addr
    flat = atlas.reshape(-1, 3)
    cols = [jnp.take(flat[:, k], gaddr, axis=0) for k in range(3)]
    return jnp.stack(cols, axis=-1)


def _bilinear_level(atlas, layer, uv, level, wrap):
    """Bilinear fetch at a dynamic mip level. uv in [0,1]^2 pre-wrapped floats
    are derived here from the raw uv + wrap mode; v is flipped (image rows
    top-down, like the reference's WrapCoordinates)."""
    res = jnp.int32(ATLAS_RES) >> level
    resf = res.astype(jnp.float32)
    u = _wrap_float(uv[..., 0], wrap)
    v = _wrap_float(1.0 - uv[..., 1], wrap)
    x = u * resf - 0.5
    y = v * resf - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap_i(i):
        # integer texel wrap: repeat by modulo, others clamp (the float wrap
        # already folded mirror/clamp; only the +1 neighbour can step out)
        m = jnp.mod(i, res)
        c = jnp.clip(i, 0, res - 1)
        return jnp.where(wrap == WRAP_REPEAT, m, c)

    x0w, x1w = wrap_i(x0), wrap_i(x0 + 1)
    y0w, y1w = wrap_i(y0), wrap_i(y0 + 1)
    c00 = _fetch_texels(atlas, layer, level, x0w, y0w)
    c01 = _fetch_texels(atlas, layer, level, x1w, y0w)
    c10 = _fetch_texels(atlas, layer, level, x0w, y1w)
    c11 = _fetch_texels(atlas, layer, level, x1w, y1w)
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    outside = ((uv[..., 0] < 0) | (uv[..., 0] > 1)
               | (uv[..., 1] < 0) | (uv[..., 1] > 1))
    return jnp.where((outside & (wrap == WRAP_BLACK))[..., None], 0.0, out)


def sample_trilinear(atlas, layer, uv, lod, wrap):
    """Trilinear (mip-lerped bilinear) sample; counterpart of
    ``KernelMIPMap::Sample(uv, width)`` (MIPMap.cu triangle filter)."""
    lod = jnp.clip(lod, 0.0, float(N_LEVELS - 1))
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, N_LEVELS - 1)
    f = (lod - l0.astype(jnp.float32))[..., None]
    c0 = _bilinear_level(atlas, layer, uv, l0, wrap)
    c1 = _bilinear_level(atlas, layer, uv, l1, wrap)
    return c0 * (1 - f) + c1 * f


def sample_aniso(atlas, layer, uv, duv0, duv1, wrap,
                 n_probes: int = N_ANISO_PROBES, max_aniso: float = 8.0):
    """Anisotropic filtering: N trilinear probes along the major footprint
    axis at the minor axis' LOD — the fixed-trip-count replacement for
    the reference's EWA loop (``KernelMIPMap::eval``/``evalEWA``)."""
    l0 = jnp.sqrt(jnp.sum(duv0 * duv0, -1) + 1e-20)
    l1 = jnp.sqrt(jnp.sum(duv1 * duv1, -1) + 1e-20)
    major_len = jnp.maximum(l0, l1)
    minor_len = jnp.minimum(l0, l1)
    major = jnp.where((l0 >= l1)[..., None], duv0, duv1)
    # clamp anisotropy (inflate minor axis) like the reference's maxAnisotropy
    minor_len = jnp.maximum(minor_len, major_len / max_aniso)
    lod = jnp.log2(jnp.maximum(minor_len * ATLAS_RES, 1e-6))
    acc = 0.0
    for k in range(n_probes):
        t = (k + 0.5) / n_probes - 0.5
        acc = acc + sample_trilinear(atlas, layer, uv + major * t, lod, wrap)
    return acc / n_probes


def _image_lookup(tex, tid, uv_t, uv_width=None, duv0=None, duv1=None):
    layer = tex.image_id[tid]
    wrap = tex.wrap_mode[tid]
    filt = tex.filter_mode[tid]
    if duv0 is not None and duv1 is not None:
        smooth = sample_aniso(tex.atlas, layer, uv_t, duv0, duv1, wrap)
    elif uv_width is not None:
        lod = jnp.log2(jnp.maximum(uv_width * ATLAS_RES, 1e-6))
        smooth = sample_trilinear(tex.atlas, layer, uv_t, lod, wrap)
    else:
        smooth = None
    base = _bilinear_level(tex.atlas, layer, uv_t, jnp.zeros_like(layer), wrap)
    if smooth is None:
        return base
    # per-texture filter mode: POINT/BILINEAR stay at level 0
    use_smooth = (filt == FILTER_TRILINEAR) | (filt == FILTER_ANISOTROPIC)
    return jnp.where(use_smooth[..., None], smooth, base)


def eval_texture(tex: Textures, tid, uv, bary=None, active=None,
                 uv_width=None, duv0=None, duv1=None):
    """Evaluate texture `tid` (batched int32) at uv (..., 2). Returns (..., 3).

    `active`: optional static tuple of texture types present — when only
    CONSTANT textures exist this collapses to a single gather.
    `uv_width`: optional isotropic footprint (uv units) -> trilinear mip
    lookup; `duv0`/`duv1`: optional footprint ellipse axes -> anisotropic.
    """
    tid = jnp.clip(tid, 0, tex.ttype.shape[0] - 1)
    if active is not None and set(active) <= {CONSTANT}:
        from .scene import small_gather

        return small_gather(tex.color_a, tid)
    tt = tex.ttype[tid]
    ca = tex.color_a[tid]
    cb = tex.color_b[tid]
    xf = tex.uv_xform[tid]
    uv_t = uv * xf[..., 0:2] + xf[..., 2:4]
    scale = xf[..., 0:2]

    # checkerboard (Texture.h:127): parity of floor(u)+floor(v) at 2x scale
    iu = jnp.floor(uv_t[..., 0] * 2.0).astype(jnp.int32)
    iv = jnp.floor(uv_t[..., 1] * 2.0).astype(jnp.int32)
    check = ((iu + iv) & 1) == 0
    checker = jnp.where(check[..., None], ca, cb)

    has_image = active is None or IMAGE in active
    if has_image:
        w_t = None if uv_width is None else uv_width * jnp.max(jnp.abs(scale), -1)
        d0_t = None if duv0 is None else duv0 * scale
        d1_t = None if duv1 is None else duv1 * scale
        image = _image_lookup(tex, tid, uv_t, w_t, d0_t, d1_t) * ca
    else:
        image = ca

    uvcol = jnp.stack(
        [jnp.mod(uv_t[..., 0], 1.0), jnp.mod(uv_t[..., 1], 1.0), jnp.zeros_like(uv_t[..., 0])],
        axis=-1,
    )

    if bary is None:
        wire = jnp.zeros_like(ca)
    else:
        b0 = 1.0 - bary[..., 0] - bary[..., 1]
        edge = jnp.minimum(jnp.minimum(b0, bary[..., 0]), bary[..., 1]) < 0.02
        wire = jnp.where(edge[..., None], jnp.ones_like(ca), jnp.zeros_like(ca))

    out = jnp.where((tt == CHECKERBOARD)[..., None], checker, ca)
    out = jnp.where((tt == IMAGE)[..., None], image, out)
    out = jnp.where((tt == UV)[..., None], uvcol, out)
    out = jnp.where((tt == WIREFRAME)[..., None], wire, out)
    return out
