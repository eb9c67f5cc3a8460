"""Spectral (generic-N) rendering machinery: CIE curves, wavelength
sampling, RGB <-> spectrum uplift.

Counterpart of reference ``Math/Spectrum.h:10-15`` (TSpectrum<T,N> over the
360-830 nm range) and the CIE machinery in ``Math/Spectrum.cu`` (the tables
``SpectrumHelper::StaticInitialize`` loads, Engine/Core.cpp:18). Design
decisions:

* the color-matching functions are the multi-lobe Gaussian fits of
  Wyman, Sloan & Shirley, "Simple Analytic Approximations to the CIE XYZ
  Color Matching Functions" (JCGT 2013) — closed-form, differentiable, and
  accurate to ~1% of peak, instead of a 471-row table gather;
* wavelength integration is HERO SAMPLING (Wilkie et al., "Hero Wavelength
  Spectral Sampling", EGSR 2014): each path draws one uniform hero
  wavelength plus N_WAVES-1 equally rotated companions, so a single traced
  path estimates N_WAVES spectral radiance samples;
* RGB reflectance/emission uplift uses a 3-band box basis calibrated at
  import time so that box-spectrum inputs ROUND-TRIP exactly through the
  render -> XYZ -> sRGB pipeline: white stays white (the spectral furnace
  gate) and the sRGB primaries reproduce themselves.

Everything is pure jnp and differentiable (the BASELINE "gradients flow
w.r.t. a spectral parameter" gate differentiates through cauchy_ior +
these conversions).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

LAMBDA_MIN = 380.0   # nm — visible band (CIE fits are defined here)
LAMBDA_MAX = 720.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN
N_WAVES = 4          # spectral samples per path (hero + 3 rotations)
_HIGHEST = jax.lax.Precision.HIGHEST  # f32 contractions: no TF32 on a GPU

# 3-band box-basis edges for RGB uplift (nm): blue / green / red
_BAND_EDGES = (LAMBDA_MIN, 490.0, 580.0, LAMBDA_MAX)


def _g(x, alpha, mu, s1, s2):
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * jnp.exp(-0.5 * t * t)


def cie_xyz(lam):
    """CIE 1931 2-deg color matching functions at lam (nm) -> (..., 3).

    Wyman-Sloan-Shirley analytic fits (JCGT 2013, eq. 2)."""
    x = (_g(lam, 0.362, 442.0, 16.0, 26.7)
         + _g(lam, 1.056, 599.8, 37.9, 31.0)
         + _g(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_g(lam, 0.821, 568.8, 46.9, 40.5)
         + _g(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_g(lam, 1.217, 437.0, 11.8, 36.0)
         + _g(lam, 0.681, 459.0, 26.0, 13.8))
    return jnp.stack([x, y, z], axis=-1)


_XYZ2RGB = jnp.asarray([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
], jnp.float32)


def sample_wavelengths(u, n: int = N_WAVES):
    """Hero wavelength sampling: u (...,) uniform -> (lam (..., n), pdf ()).

    lam_0 is the hero; lam_j are rotations by j/n of the band (wrapped), so
    one path carries n stratified spectral samples. pdf per sample is
    uniform 1/LAMBDA_RANGE."""
    u = jnp.asarray(u)
    hero = LAMBDA_MIN + u[..., None] * LAMBDA_RANGE
    j = jnp.arange(n, dtype=jnp.float32)
    lam = LAMBDA_MIN + jnp.mod(hero - LAMBDA_MIN + j * (LAMBDA_RANGE / n),
                               LAMBDA_RANGE)
    return lam, 1.0 / LAMBDA_RANGE


def band_responses(lam):
    """(..., 3) indicator of the (blue, green, red) box bands at lam."""
    b = (lam >= _BAND_EDGES[0]) & (lam < _BAND_EDGES[1])
    g = (lam >= _BAND_EDGES[1]) & (lam < _BAND_EDGES[2])
    r = (lam >= _BAND_EDGES[2]) & (lam <= _BAND_EDGES[3])
    return jnp.stack([b, g, r], axis=-1).astype(jnp.float32)


def _calibration():
    """White balance + band calibration for the uplift.

    The pipeline is calibrated so that (a) a FLAT spectrum renders to RGB
    white exactly — a per-channel von-Kries balance mapping illuminant E to
    the sRGB white (multi-bounce products of flat spectra stay flat, so
    grays round-trip exactly at EVERY path depth); and (b) a 3x3 matrix A
    with A[c, band] = balanced sRGB response of a unit box-band emitter,
    whose inverse uplifts the non-gray residual so any RGB round-trips
    exactly through ONE spectral event."""
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 4096, dtype=np.float64)
    xyz = np.asarray(cie_xyz(jnp.asarray(lam)), np.float64)      # (K, 3)
    bands = np.asarray(band_responses(jnp.asarray(lam)), np.float64)
    y_int = np.trapezoid(xyz[:, 1], lam)
    M = np.asarray(_XYZ2RGB, np.float64)
    rgb_flat = M @ (np.trapezoid(xyz, lam, axis=0) / y_int)
    balance = 1.0 / rgb_flat                               # E -> sRGB white
    A = np.zeros((3, 3))
    for b in range(3):
        xyz_b = np.trapezoid(xyz * bands[:, b:b + 1], lam, axis=0) / y_int
        A[:, b] = balance * (M @ xyz_b)
    return (jnp.asarray(np.linalg.inv(A), jnp.float32),
            jnp.asarray(np.float32(y_int)),
            jnp.asarray(balance.astype(np.float32)))


_UPLIFT_M, _Y_INT, _BALANCE = _calibration()


def rgb_to_spectrum(rgb, lam):
    """Uplift an (..., 3) linear-sRGB value to spectral samples at lam
    (..., N): Smits-style gray + residual decomposition over the calibrated
    3-band box basis. Grays map to FLAT spectra (exact at every path
    depth); any RGB round-trips exactly through one spectral event;
    emitters of any scale work (the basis is linear)."""
    w = jnp.min(rgb, axis=-1, keepdims=True)               # gray part
    res = rgb - w
    coeffs = jnp.einsum("bc,...c->...b", _UPLIFT_M, res,
                        precision=_HIGHEST)                # (..., 3 bands)
    resp = band_responses(lam)                             # (..., N, 3)
    return w + jnp.einsum("...nb,...b->...n", resp, coeffs,
                          precision=_HIGHEST)


def spectral_to_rgb(L, lam, pdf):
    """Monte-Carlo estimate of the (white-balanced) sRGB tristimulus of
    spectral radiance samples L (..., N) at wavelengths lam (..., N) drawn
    with density pdf (scalar): mean over samples of L * cmf / pdf,
    normalized by int(ybar), balanced so flat spectra are exactly white."""
    cmf = cie_xyz(lam)                                    # (..., N, 3)
    xyz = jnp.mean(L[..., None] * cmf, axis=-2) / (pdf * _Y_INT)
    return _BALANCE * jnp.einsum("cx,...x->...c", _XYZ2RGB, xyz,
                                 precision=_HIGHEST)
