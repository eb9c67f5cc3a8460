"""Spatial hash grid as sorted cell-id arrays + segment queries.

Counterpart of reference ``Engine/SpatialStructures/Grid/``
(HashGrid.h:28-62 position quantization, SpatialGridList.h:43-60 linked-list
multimap built with device atomics). Design translation (SURVEY.md §7): the
atomic linked lists become a *sort*: quantize points to cell ids, sort points
by cell id, and store per-cell [start, end) ranges built with
searchsorted — O(N log N) deterministic, no atomics, and range queries become
contiguous slices.

Used by photon mapping (PPPM), VCM's photon exchange, and the path-space
filtering buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class HashGrid(NamedTuple):
    """Regular grid over an AABB with sorted payload."""

    box_min: jnp.ndarray     # (3,)
    inv_cell: jnp.ndarray    # (3,) 1/cell_size
    res: int                 # static grid resolution per axis
    order: jnp.ndarray       # (N,) permutation sorting points by cell id
    cell_start: jnp.ndarray  # (res^3 + 1,) CSR offsets into the sorted order
    cell_of: jnp.ndarray     # (N,) sorted cell ids


def cell_index(grid_box_min, inv_cell, res: int, p):
    """Quantize world position -> flat cell id (HashGrid.h:8-25)."""
    q = jnp.floor((p - grid_box_min) * inv_cell).astype(jnp.int32)
    q = jnp.clip(q, 0, res - 1)
    return (q[..., 0] * res + q[..., 1]) * res + q[..., 2]


def build_grid(points, box_min, box_max, res: int, valid=None) -> HashGrid:
    """Sort-based grid build over (N, 3) points (replaces atomic insertion).

    `valid`: optional (N,) mask — invalid points sort past the last cell and
    are never returned by queries (replaces the reference's 'don't insert'
    branch in the atomic grid build)."""
    box_min = jnp.asarray(box_min, jnp.float32)
    box_max = jnp.asarray(box_max, jnp.float32)
    inv_cell = res / jnp.maximum(box_max - box_min, 1e-9)
    cid = cell_index(box_min, inv_cell, res, points)
    if valid is not None:
        cid = jnp.where(valid, cid, res**3)
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    # CSR offsets: start[c] = first index with cell >= c
    cells = jnp.arange(res**3 + 1, dtype=cid_sorted.dtype)
    cell_start = jnp.searchsorted(cid_sorted, cells)
    return HashGrid(
        box_min=box_min, inv_cell=inv_cell, res=res,
        order=order, cell_start=cell_start, cell_of=cid_sorted,
    )


def query_sphere(grid: HashGrid, centers, radius, max_neighbors: int):
    """Gather up to `max_neighbors` payload indices within `radius` cells of
    each center (the 3x3x3 cell neighborhood — cell size should be >= radius,
    as the reference's photon grids guarantee, PhotonMapHelper.h).

    Returns (idx (B, K) int32 into the ORIGINAL point array, valid (B, K)).
    Fixed K keeps shapes static; overflow drops farthest-cell entries (the
    reference's fixed-capacity grids drop photons on overflow too).
    """
    res = grid.res
    B = centers.shape[0]
    K = max_neighbors
    q = jnp.floor((centers - grid.box_min) * grid.inv_cell).astype(jnp.int32)

    # 27 candidate cells per center, deduplicated at the domain boundary
    offs = jnp.asarray(
        [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        jnp.int32,
    )  # (27, 3)
    qq_raw = q[:, None, :] + offs[None, :, :]          # (B, 27, 3)
    qq = jnp.clip(qq_raw, 0, res - 1)
    is_center = jnp.all(offs == 0, axis=-1)[None, :]
    is_dup = jnp.any(qq != qq_raw, axis=-1) & ~is_center
    cid = (qq[..., 0] * res + qq[..., 1]) * res + qq[..., 2]   # (B, 27)
    start = grid.cell_start[cid]
    end = grid.cell_start[cid + 1]
    count = jnp.where(is_dup, 0, end - start)          # (B, 27)

    # slot k belongs to the cell whose cumulative count first exceeds k
    cum = jnp.cumsum(count, axis=1)                    # (B, 27) inclusive
    k = jnp.arange(K, dtype=count.dtype)[None, :]      # (1, K)
    cell_sel = jnp.sum((cum[:, :, None] <= k[:, None, :]).astype(jnp.int32), axis=1)
    cell_sel = jnp.minimum(cell_sel, 26)               # (B, K)
    cum_before = jnp.take_along_axis(cum, cell_sel, axis=1) - jnp.take_along_axis(
        count, cell_sel, axis=1
    )
    src = jnp.take_along_axis(start, cell_sel, axis=1) + (k - cum_before)
    valid = k < cum[:, -1:]
    src_c = jnp.clip(src, 0, grid.order.shape[0] - 1)
    return grid.order[src_c], valid


def query_sphere_sampled(grid: HashGrid, centers, max_neighbors: int):
    """Neighborhood query with *systematic subsampling*: when the 3x3x3-cell
    candidate count N exceeds `max_neighbors` (K), returns every
    ceil(N/K)-th candidate and a per-query weight N/K that makes weighted
    sums over the returned set unbiased. A plain first-K truncation (what
    fixed-capacity photon grids, including the reference's, effectively do)
    is biased low as soon as cells saturate; systematic sampling trades that
    bias for variance.

    Returns (idx (B, K) int32 into the original point array, valid (B, K),
    weight (B,) float32)."""
    res = grid.res
    B = centers.shape[0]
    K = max_neighbors
    q = jnp.floor((centers - grid.box_min) * grid.inv_cell).astype(jnp.int32)
    offs = jnp.asarray(
        [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        jnp.int32,
    )
    qq_raw = q[:, None, :] + offs[None, :, :]
    qq = jnp.clip(qq_raw, 0, res - 1)
    is_center = jnp.all(offs == 0, axis=-1)[None, :]
    is_dup = jnp.any(qq != qq_raw, axis=-1) & ~is_center
    cid = (qq[..., 0] * res + qq[..., 1]) * res + qq[..., 2]
    start = grid.cell_start[cid]
    end = grid.cell_start[cid + 1]
    count = jnp.where(is_dup, 0, end - start)

    cum = jnp.cumsum(count, axis=1)
    n_total = cum[:, -1]                                          # (B,)
    stride = jnp.maximum(n_total.astype(jnp.float32) / K, 1.0)    # (B,)
    k = jnp.arange(K, dtype=jnp.float32)[None, :]
    g = jnp.floor(k * stride[:, None]).astype(count.dtype)        # (B, K)
    valid = g < n_total[:, None]

    cell_sel = jnp.sum((cum[:, :, None] <= g[:, None, :]).astype(jnp.int32), axis=1)
    cell_sel = jnp.minimum(cell_sel, 26)
    cum_before = jnp.take_along_axis(cum, cell_sel, axis=1) - jnp.take_along_axis(
        count, cell_sel, axis=1
    )
    src = jnp.take_along_axis(start, cell_sel, axis=1) + (g - cum_before)
    src_c = jnp.clip(src, 0, grid.order.shape[0] - 1)
    return grid.order[src_c], valid, stride


def query_reduce(grid: HashGrid, points_sorted_payload, centers, radius,
                 max_neighbors: int, reduce_fn, init):
    """Convenience: gather neighbors and fold `reduce_fn(acc, payload, valid)`."""
    idx, valid = query_sphere(grid, centers, radius, max_neighbors)
    payload = jax.tree.map(lambda a: a[idx], points_sorted_payload)
    return reduce_fn(init, payload, valid)
