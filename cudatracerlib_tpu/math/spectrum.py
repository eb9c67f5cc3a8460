"""Spectrum / color math over (..., 3) RGB arrays.

Counterpart of reference ``Math/Spectrum.h`` (TSpectrum with
SPECTRUM_SAMPLES=3, Math/Spectrum.h:10,326). We keep RGB (N=3) as the working
representation; conversions (sRGB, XYZ, luminance) and the compressed RGBE /
RGBCOL formats used by the reference's photon storage and film stages
(Math/Spectrum.h:323-418) are provided as pure functions so photon buffers can
use the same 32-bit packed encodings (uint32 arrays).
"""
from __future__ import annotations

import jax.numpy as jnp


def luminance(rgb):
    """ITU-R Rec. BT.709 luminance, as reference Spectrum::getLuminance."""
    return (
        0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    )


def average(rgb):
    return jnp.mean(rgb, axis=-1)


def max_component(rgb):
    return jnp.max(rgb, axis=-1)


def is_black(rgb, eps: float = 0.0):
    return jnp.max(jnp.abs(rgb), axis=-1) <= eps


# ---- color space conversions (Math/Spectrum.h toXYZ/toSRGB) ----

_RGB2XYZ = jnp.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=jnp.float32,
)
_XYZ2RGB = jnp.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=jnp.float32,
)


def rgb_to_xyz(rgb):
    return jnp.einsum("ij,...j->...i", _RGB2XYZ, rgb, precision="highest")


def xyz_to_rgb(xyz):
    return jnp.einsum("ij,...j->...i", _XYZ2RGB, xyz, precision="highest")


def linear_to_srgb(x):
    x = jnp.maximum(x, 0.0)
    return jnp.where(
        x <= 0.0031308, 12.92 * x, 1.055 * jnp.power(jnp.maximum(x, 1e-12), 1.0 / 2.4) - 0.055
    )


def srgb_to_linear(x):
    return jnp.where(
        x <= 0.04045, x / 12.92, jnp.power(jnp.maximum((x + 0.055) / 1.055, 0.0), 2.4)
    )


# ---- packed formats (Math/Spectrum.h:323-418) ----

def to_rgbcol(rgb):
    """Pack linear RGB -> uint32 0xAABBGGRR after sRGB transfer (reference toRGBCOL)."""
    q = jnp.clip(jnp.round(linear_to_srgb(rgb) * 255.0), 0, 255).astype(jnp.uint32)
    return (
        jnp.uint32(0xFF) << 24
        | q[..., 2] << 16
        | q[..., 1] << 8
        | q[..., 0]
    )


def from_rgbcol(packed):
    packed = packed.astype(jnp.uint32)
    r = (packed & 0xFF).astype(jnp.float32) / 255.0
    g = ((packed >> 8) & 0xFF).astype(jnp.float32) / 255.0
    b = ((packed >> 16) & 0xFF).astype(jnp.float32) / 255.0
    return srgb_to_linear(jnp.stack([r, g, b], axis=-1))


def to_rgbe(rgb):
    """Ward RGBE shared-exponent packing -> uint32 (reference toRGBE).

    Layout: byte0=R, byte1=G, byte2=B mantissas, byte3=exponent+128.
    """
    v = jnp.max(rgb, axis=-1)
    # frexp: v = f * 2^e with f in [0.5, 1)
    f, e = jnp.frexp(jnp.maximum(v, 1e-38))
    scale = f * 256.0 / jnp.maximum(v, 1e-38)
    m = jnp.clip(rgb * scale[..., None], 0.0, 255.0).astype(jnp.uint32)
    exp_byte = jnp.clip(e + 128, 0, 255).astype(jnp.uint32)
    packed = m[..., 0] | (m[..., 1] << 8) | (m[..., 2] << 16) | (exp_byte << 24)
    return jnp.where(v < 1e-32, jnp.uint32(0), packed)


def from_rgbe(packed):
    packed = packed.astype(jnp.uint32)
    e = (packed >> 24).astype(jnp.int32)
    scale = jnp.where(e == 0, 0.0, jnp.exp2((e - 128 - 8).astype(jnp.float32)))
    r = (packed & 0xFF).astype(jnp.float32)
    g = ((packed >> 8) & 0xFF).astype(jnp.float32)
    b = ((packed >> 16) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b], axis=-1) * scale[..., None]
