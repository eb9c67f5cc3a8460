"""BVH refit for deformable geometry.

Counterpart of reference ``Engine/SpatialStructures/BVH/BVHRebuilder.{h,cpp}``
(refit AABBs after animation, BVHRebuilder.h:30-82) and the device Woop-data
recompute in ``Engine/AnimatedMesh.cu``.

Design: the tree topology is static after build; a host-side RefitPlan
groups nodes by depth, and the jitted refit walks levels bottom-up with dense
gathers — O(depth) kernels, no pointer chasing. Woop matrices are recomputed
on device with the closed-form inverse (det = |n|^2 for the [e1 e2 n v0]
frame), so the whole animate->refit->trace step stays on-chip and
differentiable w.r.t. vertex positions.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .bvh import BVH, LEAF_SIZE


def woop_transform_device(tri_verts):
    """Device Woop rows from (T, 3, 3) vertices (closed-form inverse)."""
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n = jnp.cross(e1, e2)
    det = jnp.maximum(jnp.sum(n * n, -1, keepdims=True), 1e-20)
    r0 = jnp.cross(e2, n) / det
    r1 = jnp.cross(n, e1) / det
    r2 = n / det
    row = lambda r: jnp.concatenate(
        [r, -jnp.sum(r * v0, -1, keepdims=True)], axis=-1
    )
    return jnp.concatenate([row(r0), row(r1), row(r2)], axis=-1)  # (T, 12)


class RefitPlan(NamedTuple):
    """Host-derived per-level node lists (device int32 arrays)."""

    level_nodes: tuple          # tuple of (K_l,) node-id arrays, deepest first
    c0: jnp.ndarray             # (M,) child-0 codes
    c1: jnp.ndarray             # (M,) child-1 codes


def build_refit_plan(nodes_host: np.ndarray, root: int) -> RefitPlan:
    codes = nodes_host[:, 12:14].view(np.int32)
    M = nodes_host.shape[0]
    depth = np.zeros(M, np.int32)
    # parent emitted before children -> forward pass assigns depths
    order = [max(root, 0)]
    seen = np.zeros(M, bool)
    seen[max(root, 0)] = True
    qi = 0
    while qi < len(order):
        i = order[qi]
        qi += 1
        for c in codes[i]:
            if c >= 0 and not seen[c]:
                seen[c] = True
                depth[c] = depth[i] + 1
                order.append(c)
    max_d = int(depth[seen].max()) if seen.any() else 0
    levels = tuple(
        jnp.asarray(np.nonzero(seen & (depth == dl))[0].astype(np.int32))
        for dl in range(max_d, -1, -1)
    )
    return RefitPlan(level_nodes=levels,
                     c0=jnp.asarray(codes[:, 0].copy()),
                     c1=jnp.asarray(codes[:, 1].copy()))


def refit_bvh(bvh: BVH, plan: RefitPlan, tri_verts) -> BVH:
    """Recompute Woop data + node boxes for deformed vertices.

    tri_verts: (T_padded, 3, 3) — already in BVH leaf order (use
    shading.verts, which build_scene stores permuted)."""
    woop = woop_transform_device(tri_verts)

    lo_t = jnp.min(tri_verts, axis=1)  # (T, 3)
    hi_t = jnp.max(tri_verts, axis=1)

    # leaf box over its LEAF_SIZE range
    T = tri_verts.shape[0]
    n_leaf_slots = T // LEAF_SIZE
    leaf_lo = lo_t.reshape(n_leaf_slots, LEAF_SIZE, 3).min(1)
    leaf_hi = hi_t.reshape(n_leaf_slots, LEAF_SIZE, 3).max(1)

    nodes = bvh.nodes

    def child_box(codes, nodes):
        """(K,) child codes -> (K, 3) lo, (K, 3) hi."""
        is_leaf = codes < 0
        first = jnp.where(is_leaf, -(codes + 1), 0)
        slot = jnp.clip(first // LEAF_SIZE, 0, n_leaf_slots - 1)
        l_lo = leaf_lo[slot]
        l_hi = leaf_hi[slot]
        ni = jnp.clip(codes, 0, nodes.shape[0] - 1)
        n_lo = jnp.minimum(nodes[ni, 0:3], nodes[ni, 6:9])
        n_hi = jnp.maximum(nodes[ni, 3:6], nodes[ni, 9:12])
        lo = jnp.where(is_leaf[:, None], l_lo, n_lo)
        hi = jnp.where(is_leaf[:, None], l_hi, n_hi)
        return lo, hi

    for lvl in plan.level_nodes:
        c0 = plan.c0[lvl]
        c1 = plan.c1[lvl]
        lo0, hi0 = child_box(c0, nodes)
        lo1, hi1 = child_box(c1, nodes)
        row = jnp.concatenate([lo0, hi0, lo1, hi1, nodes[lvl, 12:16]], axis=-1)
        nodes = nodes.at[lvl].set(row)

    lo_all = jnp.min(lo_t, axis=0)
    hi_all = jnp.max(hi_t, axis=0)
    return bvh._replace(nodes=nodes, woop=woop, world_min=lo_all, world_max=hi_all)
