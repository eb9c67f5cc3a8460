"""Adaptive 1-D function approximation by knot merging.

Counterpart of reference ``Math/FunctionModel.h`` (239 LoC ``MergingModel``):
an on-line piecewise-linear approximation of a 1-D function that keeps a fixed
number of knots by merging the adjacent pair whose removal changes the curve
least. Translation: the knot table is a fixed-size sorted SoA array; an
insert is a masked shift, a merge collapses the cheapest pair — both are pure
fixed-shape array ops usable under jit/vmap (e.g. one model per pixel/cell).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MergingModel(NamedTuple):
    xs: jnp.ndarray    # (..., K) knot positions, ascending among valid
    ys: jnp.ndarray    # (..., K) knot values
    n: jnp.ndarray     # (...,) int32 number of valid knots


def merging_init(n_knots: int, batch_shape=()) -> MergingModel:
    """Capacity n_knots; one spare physical slot holds the transient K+1-th
    entry between insert and merge (static shapes under jit)."""
    K = n_knots + 1
    return MergingModel(
        xs=jnp.full(batch_shape + (K,), jnp.inf, jnp.float32),
        ys=jnp.zeros(batch_shape + (K,), jnp.float32),
        n=jnp.zeros(batch_shape, jnp.int32),
    )


def _merge_cost(xs, ys, n):
    """Cost of removing interior knot i (replacing by the line through its
    neighbors): |error| * covered width. (..., K) with inf at invalid/edges."""
    K = xs.shape[-1]
    x_prev = jnp.roll(xs, 1, axis=-1)
    x_next = jnp.roll(xs, -1, axis=-1)
    y_prev = jnp.roll(ys, 1, axis=-1)
    y_next = jnp.roll(ys, -1, axis=-1)
    t = (xs - x_prev) / jnp.maximum(x_next - x_prev, 1e-12)
    y_lin = y_prev + t * (y_next - y_prev)
    cost = jnp.abs(ys - y_lin) * (x_next - x_prev)
    idx = jnp.arange(K)
    interior = (idx >= 1) & (idx < (n[..., None] - 1))
    return jnp.where(interior, cost, jnp.inf)


def merging_insert(m: MergingModel, x, y) -> MergingModel:
    """Insert (x, y); if the table is full, merge the cheapest interior knot.

    x, y: scalars broadcast over the batch shape (one insert per model)."""
    K = m.xs.shape[-1]          # physical slots = capacity + 1
    cap = K - 1
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)

    # 1. shift-insert keeping xs sorted (invalid slots hold +inf so they sort last)
    pos = jnp.sum((m.xs < x[..., None]).astype(jnp.int32), axis=-1)  # (...,)
    idx = jnp.arange(K)
    after = idx >= pos[..., None]
    xs2 = jnp.where(after, jnp.roll(m.xs, 1, axis=-1), m.xs)
    ys2 = jnp.where(after, jnp.roll(m.ys, 1, axis=-1), m.ys)
    at = idx == pos[..., None]
    xs2 = jnp.where(at, x[..., None], xs2)
    ys2 = jnp.where(at, y[..., None], ys2)
    n2 = m.n + 1                # <= K physically

    # 2. if we exceeded capacity, merge the cheapest interior knot
    overfull = n2 > cap
    cost = _merge_cost(xs2, ys2, n2)
    kill = jnp.argmin(cost, axis=-1)
    keep_shift = idx >= kill[..., None]
    xs3 = jnp.where(keep_shift, jnp.roll(xs2, -1, axis=-1), xs2)
    ys3 = jnp.where(keep_shift, jnp.roll(ys2, -1, axis=-1), ys2)
    last = idx == (K - 1)
    xs3 = jnp.where(last, jnp.inf, xs3)
    ys3 = jnp.where(last, 0.0, ys3)

    ov = overfull[..., None]
    return MergingModel(
        xs=jnp.where(ov, xs3, xs2),
        ys=jnp.where(ov, ys3, ys2),
        n=jnp.where(overfull, cap, n2).astype(jnp.int32),
    )


def merging_eval(m: MergingModel, x):
    """Piecewise-linear evaluation at x (scalar per model), clamped to the
    knot range."""
    K = m.xs.shape[-1]
    x = jnp.asarray(x, jnp.float32)
    valid = jnp.arange(K) < m.n[..., None]
    xs = jnp.where(valid, m.xs, jnp.inf)
    hi = jnp.sum((xs <= x[..., None]).astype(jnp.int32), axis=-1)
    hi = jnp.clip(hi, 1, jnp.maximum(m.n - 1, 1))
    lo = hi - 1
    x0 = jnp.take_along_axis(m.xs, lo[..., None], -1)[..., 0]
    x1 = jnp.take_along_axis(m.xs, hi[..., None], -1)[..., 0]
    y0 = jnp.take_along_axis(m.ys, lo[..., None], -1)[..., 0]
    y1 = jnp.take_along_axis(m.ys, hi[..., None], -1)[..., 0]
    t = jnp.clip((x - x0) / jnp.maximum(x1 - x0, 1e-12), 0.0, 1.0)
    single = m.n <= 1
    return jnp.where(single, y0, y0 + t * (y1 - y0))
