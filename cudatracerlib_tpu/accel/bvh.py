"""CPU BVH construction producing flat traversal arrays.

Counterpart of the reference's SBVH builder + node layout
(Engine/SpatialStructures/BVH/SplitBVHBuilder.cpp — SAH binned builder — and
Engine/TriIntersectorData.h:42-60 — 4-wide-float node layout holding *both*
child AABBs per inner node, Aila-Laine style).

Design decisions:
  * Build happens on host (the reference builds on CPU too); the result is a
    pytree of flat arrays uploaded once per scene update.
  * Inner node = 16 floats: [c0.min, c0.max, c1.min, c1.max, c0_code, c1_code,
    pad, pad]. One 64-byte row per traversal step fetches both child boxes,
    so the XLA oracle and the CUDA kernel both do distance-ordered descent
    with a single memory access per step.
  * Child codes (bitcast int32 in lanes 12/13): >= 0 -> inner node index;
    < 0 -> leaf with first-triangle index = -(code+1). Every leaf holds
    exactly LEAF_SIZE triangles: triangles are reordered into leaf order at
    build time and leaves are padded by *duplicating* their first triangle
    (duplicates are harmless for both closest-hit and any-hit and avoid NaN
    paths a degenerate padding tri would create).
  * Woop triangle transform (reference TriIntersectorData.h:30-40,
    TriIntersectorData.cu setData): 12 floats/tri so the intersection test is
    9 FMAs + 2 divides, identical math to the CUDA kernel
    (Kernel/TraceHelper.cu:638-685) but vectorized over SoA lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

LEAF_SIZE = 4
N_BINS = 16
MAX_DEPTH = 60


class BVH(NamedTuple):
    """Flat BVH pytree (device arrays)."""

    nodes: jnp.ndarray        # (M, 16) float32, child codes bitcast in lanes 12/13
    woop: jnp.ndarray         # (T_padded, 12) float32 Woop triangle transforms
    tri_index: jnp.ndarray    # (T_padded,) int32 -> original triangle id
    root_code: jnp.ndarray    # () int32: inner index 0, or leaf code if tiny scene
    world_min: jnp.ndarray    # (3,) — numpy at build time (host-side metadata;
    world_max: jnp.ndarray    # (3,)   avoids device readbacks on build paths)


def woop_transform(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Per-triangle Woop matrices, vectorized. Returns (T, 12).

    Rows r0, r1, r2 (4 floats each) such that for a point p:
      w = r2 . (p,1)   (zero on the triangle plane, 1 at unit normal offset)
      u = r0 . (p,1),  v = r1 . (p,1)  (barycentric coords)
    Ray test: t = -(r2.o + r2w)/(r2.d); u,v evaluated at the hit point.
    """
    T = v0.shape[0]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    A = np.zeros((T, 4, 4), dtype=np.float64)
    A[:, :3, 0] = e1
    A[:, :3, 1] = e2
    A[:, :3, 2] = n
    A[:, :3, 3] = v0
    A[:, 3, 3] = 1.0
    # Guard degenerate triangles (zero-area): fall back to identity-ish.
    det = np.einsum("tij,tij->t", A[:, :3, :3], A[:, :3, :3])
    bad = ~np.isfinite(det) | (np.linalg.norm(n, axis=1) < 1e-20)
    A[bad] = np.eye(4)
    inv = np.linalg.inv(A)
    # rows: u=row0, v=row1, w=row2 of inv
    out = np.concatenate([inv[:, 0, :], inv[:, 1, :], inv[:, 2, :]], axis=1)
    out[bad] = 0.0
    return out.astype(np.float32)


def _leaf_code(first: int) -> int:
    return -(first + 1)


def tree_depth(nodes: np.ndarray, root: int) -> int:
    """Inner nodes on the longest root-to-leaf path (0 for a leaf root)."""
    codes = np.ascontiguousarray(nodes[:, 12:14]).view(np.int32)
    level = np.asarray([root], np.int64)
    level = level[level >= 0]
    depth = 0
    while level.size:
        depth += 1
        nxt = codes[level].reshape(-1)
        level = nxt[nxt >= 0]
    return depth


def check_depth(nodes: np.ndarray, root: int) -> None:
    """Refuse a tree whose traversal could overflow the per-ray stack.

    A traversal stack holds at most one far child per inner ancestor of the
    current node, so a tree of depth <= STACK_DEPTH never overflows it. The
    SAH recursion stops at MAX_DEPTH, but oversized leaves become balanced
    leaf subtrees below that, so the bound is checked on the built tree."""
    from .traversal import STACK_DEPTH

    depth = tree_depth(nodes, root)
    if depth > STACK_DEPTH:
        raise ValueError(f"BVH depth {depth} exceeds the traversal stack "
                         f"({STACK_DEPTH} entries)")


def build_bvh(vertices: np.ndarray, use_native: bool = True,
              with_host: bool = False):
    """Build a binned-SAH BVH over triangles given as (T, 3, 3) vertices.

    Uses the C++ builder (native/bvh_builder.cpp, the counterpart of the
    reference's CPU SplitBVHBuilder) when the toolchain is available; the
    numpy implementation below is the fallback/reference."""
    tris = np.asarray(vertices, dtype=np.float32)
    T = tris.shape[0]
    assert T > 0
    lo = tris.min(axis=1)  # (T,3)
    hi = tris.max(axis=1)

    if use_native:
        from ..native import build_bvh_native

        res = build_bvh_native(tris, LEAF_SIZE, N_BINS, MAX_DEPTH)
        if res is not None:
            node_arr, order, root = res
            check_depth(node_arr, root)
            woop = woop_transform(
                tris[np.clip(order, 0, T - 1), 0],
                tris[np.clip(order, 0, T - 1), 1],
                tris[np.clip(order, 0, T - 1), 2],
            )
            bvh = BVH(
                nodes=jnp.asarray(node_arr),
                woop=jnp.asarray(woop),
                tri_index=jnp.asarray(np.clip(order, 0, T - 1).astype(np.int32)),
                root_code=np.int32(root),
                world_min=lo.min(axis=0),
                world_max=hi.max(axis=0),
            )
            if with_host:
                return bvh, {"nodes": node_arr, "woop": woop, "root": root,
                             "order": np.clip(order, 0, T - 1).astype(np.int32),
                             "tris": tris[np.clip(order, 0, T - 1)]}
            return bvh

    centroid = 0.5 * (lo + hi)

    order_out: list[np.ndarray] = []   # triangle ids in leaf order (padded)
    nodes: list[np.ndarray] = []       # rows of 16 floats (codes patched later)

    tri_cursor = [0]

    def make_leaf(ids: np.ndarray) -> int:
        """Emit one leaf of exactly LEAF_SIZE tris (pad by duplicating)."""
        assert 0 < len(ids) <= LEAF_SIZE
        first = tri_cursor[0]
        padded = ids
        if len(ids) < LEAF_SIZE:
            padded = np.concatenate([ids, np.repeat(ids[:1], LEAF_SIZE - len(ids))])
        order_out.append(padded.astype(np.int64))
        tri_cursor[0] += LEAF_SIZE
        return _leaf_code(first)

    def make_leaf_subtree(ids: np.ndarray) -> int:
        """Leaves hold exactly LEAF_SIZE tris; oversized forced leaves (depth
        cap / unsplittable) become a small balanced subtree of leaf chunks."""
        if len(ids) <= LEAF_SIZE:
            return make_leaf(ids)
        half = (len(ids) // (2 * LEAF_SIZE)) * LEAF_SIZE or LEAF_SIZE
        left, right = ids[:half], ids[half:]
        my_idx = len(nodes)
        nodes.append(np.zeros(16, dtype=np.float32))
        c0 = make_leaf_subtree(left)
        c1 = make_leaf_subtree(right)
        row = np.zeros(16, dtype=np.float32)
        row[0:3] = lo[left].min(axis=0)
        row[3:6] = hi[left].max(axis=0)
        row[6:9] = lo[right].min(axis=0)
        row[9:12] = hi[right].max(axis=0)
        row[12:14] = np.array([c0, c1], dtype=np.int32).view(np.float32)
        nodes[my_idx] = row
        return my_idx

    def sah_split(ids: np.ndarray):
        """Return (axis, left_ids, right_ids) or None if no good split."""
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            return None
        # binned SAH
        scale = N_BINS * (1.0 - 1e-6) / ext[axis]
        bins = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int32), N_BINS - 1)
        bin_lo = np.full((N_BINS, 3), np.inf, dtype=np.float32)
        bin_hi = np.full((N_BINS, 3), -np.inf, dtype=np.float32)
        bin_n = np.zeros(N_BINS, dtype=np.int64)
        for b in range(N_BINS):
            m = bins == b
            if m.any():
                bin_lo[b] = lo[ids[m]].min(axis=0)
                bin_hi[b] = hi[ids[m]].max(axis=0)
                bin_n[b] = m.sum()
        # sweep
        l_lo = np.minimum.accumulate(bin_lo, axis=0)
        l_hi = np.maximum.accumulate(bin_hi, axis=0)
        l_n = np.cumsum(bin_n)
        r_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
        r_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
        r_n = np.cumsum(bin_n[::-1])[::-1]

        def area(a, b):
            d = np.maximum(b - a, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = area(l_lo[:-1], l_hi[:-1]) * l_n[:-1] + area(r_lo[1:], r_hi[1:]) * r_n[1:]
        cost = np.where((l_n[:-1] == 0) | (r_n[1:] == 0), np.inf, cost)
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            # median fallback
            med = np.argsort(c[:, axis])
            half = len(ids) // 2
            return axis, ids[med[:half]], ids[med[half:]]
        mask = bins <= best
        return axis, ids[mask], ids[~mask]

    def build(ids: np.ndarray, depth: int) -> int:
        if len(ids) <= LEAF_SIZE or depth >= MAX_DEPTH:
            return make_leaf_subtree(ids)
        split = sah_split(ids)
        if split is None:
            return make_leaf_subtree(ids)
        _, left, right = split
        if len(left) == 0 or len(right) == 0:
            return make_leaf_subtree(ids)
        my_idx = len(nodes)
        nodes.append(np.zeros(16, dtype=np.float32))
        c0 = build(left, depth + 1)
        c1 = build(right, depth + 1)
        row = np.zeros(16, dtype=np.float32)
        row[0:3] = lo[left].min(axis=0)
        row[3:6] = hi[left].max(axis=0)
        row[6:9] = lo[right].min(axis=0)
        row[9:12] = hi[right].max(axis=0)
        row[12:14] = np.array([c0, c1], dtype=np.int32).view(np.float32)
        nodes[my_idx] = row
        return my_idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10 * MAX_DEPTH + 1000))
    try:
        root = build(np.arange(T, dtype=np.int64), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    if not nodes:  # single-leaf scene: add a dummy inner node pointing at it twice
        row = np.zeros(16, dtype=np.float32)
        row[0:3] = lo.min(axis=0)
        row[3:6] = hi.max(axis=0)
        row[6:9] = row[0:3]
        row[9:12] = row[3:6]
        row[12:14] = np.array([root, _leaf_code(10**9)], dtype=np.int32).view(np.float32)
        nodes.append(row)
        root = 0

    check_depth(np.stack(nodes), root)
    order = np.concatenate(order_out)
    woop = woop_transform(tris[order, 0], tris[order, 1], tris[order, 2])
    node_arr = np.stack(nodes).astype(np.float32)

    bvh = BVH(
        nodes=jnp.asarray(node_arr),
        woop=jnp.asarray(woop),
        tri_index=jnp.asarray(order.astype(np.int32)),
        root_code=np.int32(root),
        world_min=lo.min(axis=0),
        world_max=hi.max(axis=0),
    )
    if with_host:
        return bvh, {"nodes": node_arr, "woop": woop, "root": root,
                     "order": order.astype(np.int32),
                     "tris": tris[order]}
    return bvh
