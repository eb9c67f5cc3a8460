"""Catmull-Rom cubic spline interpolation, integration, and sampling.

Counterpart of reference ``Math/Spline.h`` / ``Spline.cu`` (Mitsuba-derived
``evalCubicInterp1D/2D/3D``, ``integrateCubicInterp1D``,
``sampleCubicInterp1D``). Uniform-grid variants only (the *N non-uniform
variants in the reference are used nowhere in its integrators).

Design: all functions are batched pure jnp — positions may have any batch
shape; the value table is a fixed-size array, lookups are static-shape
gathers, and importance sampling inverts the spline CDF with a fixed number
of Newton iterations (data-independent control flow).
"""
from __future__ import annotations

import jax.numpy as jnp


def _catmull_rom_weights(t):
    """Hermite basis weights for value pairs + derivative pairs at local t."""
    t2 = t * t
    t3 = t2 * t
    w_v0 = 2.0 * t3 - 3.0 * t2 + 1.0
    w_v1 = -2.0 * t3 + 3.0 * t2
    w_d0 = t3 - 2.0 * t2 + t
    w_d1 = t3 - t2
    return w_v0, w_v1, w_d0, w_d1


def _segment(x, size, lo, hi):
    """Map x in [lo,hi] to (segment index i, local parameter t in [0,1])."""
    u = (x - lo) / (hi - lo) * (size - 1)
    i = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, size - 2)
    t = u - i.astype(u.dtype)
    return i, jnp.clip(t, 0.0, 1.0)


def _gather_last(values, i):
    """Element-wise gather along the last axis; `values` may carry batch dims
    that broadcast against i's shape (needed by the 2D/3D tensor-product
    paths, where plain fancy indexing would do an outer gather)."""
    size = values.shape[-1]
    i = jnp.clip(i, 0, size - 1)
    if values.ndim == 1:
        return values[i]
    v = jnp.broadcast_to(values, i.shape + (size,))
    return jnp.take_along_axis(v, i[..., None], axis=-1)[..., 0]


def _derivs(values, i):
    """One-sided/central Catmull-Rom derivatives at nodes i and i+1.

    Matches the reference's boundary handling (Spline.cu evalCubicInterp1D):
    central differences inside, one-sided at the ends, in units of segments.
    """
    size = values.shape[-1]
    v_m1 = _gather_last(values, i - 1)
    v_0 = _gather_last(values, i)
    v_1 = _gather_last(values, i + 1)
    v_2 = _gather_last(values, i + 2)
    d0 = jnp.where(i > 0, 0.5 * (v_1 - v_m1), v_1 - v_0)
    d1 = jnp.where(i + 2 < size, 0.5 * (v_2 - v_0), v_1 - v_0)
    return v_0, v_1, d0, d1


def eval_1d(x, values, lo=0.0, hi=1.0, extrapolate: bool = False):
    """Catmull-Rom interpolation of `values` (uniform grid on [lo,hi]) at x.

    Reference ``Spline::evalCubicInterp1D``. Batched over x; differentiable
    w.r.t. x and values.
    """
    values = jnp.asarray(values)
    size = values.shape[-1]
    i, t = _segment(x, size, lo, hi)
    v0, v1, d0, d1 = _derivs(values, i)
    w_v0, w_v1, w_d0, w_d1 = _catmull_rom_weights(t)
    y = w_v0 * v0 + w_v1 * v1 + w_d0 * d0 + w_d1 * d1
    if not extrapolate:
        inside = (x >= lo) & (x <= hi)
        y = jnp.where(inside, y, 0.0)
    return y


def integrate_1d(values, lo=0.0, hi=1.0):
    """Per-node cumulative integral of the Catmull-Rom interpolant.

    Reference ``Spline::integrateCubicInterp1D``. Returns an array of the
    same length as `values` with cdf[0] = 0 and cdf[-1] = total integral.
    Analytic per segment: ∫₀¹ hermite = (v0+v1)/2 + (d0-d1)/12, scaled by the
    segment width.
    """
    values = jnp.asarray(values)
    size = values.shape[-1]
    i = jnp.arange(size - 1)
    v0, v1, d0, d1 = _derivs(values, i)
    width = (hi - lo) / (size - 1)
    seg = (0.5 * (v0 + v1) + (d0 - d1) / 12.0) * width
    cdf = jnp.concatenate([jnp.zeros_like(seg[..., :1]), jnp.cumsum(seg, -1)], -1)
    return cdf


def sample_1d(u, values, lo=0.0, hi=1.0, n_newton: int = 6):
    """Importance-sample x ∝ the Catmull-Rom interpolant of `values`.

    Reference ``Spline::sampleCubicInterp1D``. Returns (x, pdf(x)). Inverts
    the spline CDF with a searchsorted segment lookup plus `n_newton`
    bisection-safeguarded Newton steps (fixed trip count — XLA-friendly).
    Batched over u.
    """
    values = jnp.asarray(values)
    size = values.shape[-1]
    cdf = integrate_1d(values, lo, hi)
    total = cdf[..., -1]
    target = u * total
    i = jnp.clip(jnp.searchsorted(cdf, target, side="right") - 1, 0, size - 2)
    v0, v1, d0, d1 = _derivs(values, i)
    width = (hi - lo) / (size - 1)
    c0 = cdf[i]

    def seg_cdf(t):
        # ∫₀ᵗ hermite(s) ds * width
        t2 = t * t
        t3 = t2 * t
        t4 = t2 * t2
        iv0 = 0.5 * t4 - t3 + t
        iv1 = -0.5 * t4 + t3
        id0 = 0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2
        id1 = 0.25 * t4 - t3 / 3.0
        return (iv0 * v0 + iv1 * v1 + id0 * d0 + id1 * d1) * width

    def seg_pdf(t):
        w_v0, w_v1, w_d0, w_d1 = _catmull_rom_weights(t)
        return w_v0 * v0 + w_v1 * v1 + w_d0 * d0 + w_d1 * d1

    t = jnp.full_like(target, 0.5)
    t_lo = jnp.zeros_like(t)
    t_hi = jnp.ones_like(t)
    for _ in range(n_newton):
        err = c0 + seg_cdf(t) - target
        t_lo = jnp.where(err < 0, t, t_lo)
        t_hi = jnp.where(err > 0, t, t_hi)
        step = err / jnp.maximum(seg_pdf(t) * width, 1e-12)
        t_new = t - step
        bad = (t_new <= t_lo) | (t_new >= t_hi)
        t = jnp.where(bad, 0.5 * (t_lo + t_hi), t_new)
    x = lo + (i.astype(jnp.float32) + t) * width
    pdf = seg_pdf(t) / jnp.maximum(total, 1e-12)
    return x, pdf


def eval_2d(p, values, lo=(0.0, 0.0), hi=(1.0, 1.0), extrapolate: bool = False):
    """Tensor-product Catmull-Rom on a (H, W) grid at p = (..., 2) (x, y).

    Reference ``Spline::evalCubicInterp2D``: interpolate along x for the two
    bracketing derivative stencils in y, then along y.
    """
    values = jnp.asarray(values)
    h, w = values.shape[-2], values.shape[-1]
    x, y = p[..., 0], p[..., 1]
    iy, ty = _segment(y, h, lo[1], hi[1])

    def row(r):
        r = jnp.clip(r, 0, h - 1)
        if values.ndim == 2:
            rows = values[r]
        else:  # batched planes from eval_3d: gather along the H axis
            v = jnp.broadcast_to(values, r.shape + values.shape[-2:])
            rows = jnp.take_along_axis(v, r[..., None, None], axis=-2)[..., 0, :]
        return eval_1d(x, rows, lo[0], hi[0], True)

    r_m1, r_0, r_1, r_2 = row(iy - 1), row(iy), row(iy + 1), row(iy + 2)
    d0 = jnp.where(iy > 0, 0.5 * (r_1 - r_m1), r_1 - r_0)
    d1 = jnp.where(iy + 2 < h, 0.5 * (r_2 - r_0), r_1 - r_0)
    w_v0, w_v1, w_d0, w_d1 = _catmull_rom_weights(ty)
    out = w_v0 * r_0 + w_v1 * r_1 + w_d0 * d0 + w_d1 * d1
    if not extrapolate:
        inside = (x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
        out = jnp.where(inside, out, 0.0)
    return out


def eval_3d(p, values, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0),
            extrapolate: bool = False):
    """Tensor-product Catmull-Rom on a (D, H, W) grid at p = (..., 3) (x,y,z).

    Reference ``Spline::evalCubicInterp3D``.
    """
    values = jnp.asarray(values)
    d = values.shape[-3]
    z = p[..., 2]
    iz, tz = _segment(z, d, lo[2], hi[2])

    def plane(s):
        return eval_2d(p[..., :2], values[jnp.clip(s, 0, d - 1)],
                       lo[:2], hi[:2], True)

    p_m1, p_0, p_1, p_2 = plane(iz - 1), plane(iz), plane(iz + 1), plane(iz + 2)
    d0 = jnp.where(iz > 0, 0.5 * (p_1 - p_m1), p_1 - p_0)
    d1 = jnp.where(iz + 2 < d, 0.5 * (p_2 - p_0), p_1 - p_0)
    w_v0, w_v1, w_d0, w_d1 = _catmull_rom_weights(tz)
    out = w_v0 * p_0 + w_v1 * p_1 + w_d0 * d0 + w_d1 * d1
    if not extrapolate:
        inside = ((p[..., 0] >= lo[0]) & (p[..., 0] <= hi[0])
                  & (p[..., 1] >= lo[1]) & (p[..., 1] <= hi[1])
                  & (z >= lo[2]) & (z <= hi[2]))
        out = jnp.where(inside, out, 0.0)
    return out
