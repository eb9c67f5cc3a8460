"""Instance-level TLAS: per-instance transforms at traversal time.

Counterpart of the reference's two-level scene BVH
(Engine/SceneBVH_device.h:9-16 — per-node transform + inverse arrays;
Engine/DynamicScene.cpp:480-556 — update cycle; SceneTypes/Node.h:13), which
transforms the ray into each instance's object space at the TLAS leaf
(Kernel/TraceHelper.cu:528-712) instead of duplicating geometry.

Design: the instance list is STRUCTURAL — a tuple of per-mesh
`InstanceGroup`s aligned with a tuple of per-mesh `BlasEntry`s, so the
instance loop unrolls at trace time (static shapes everywhere; no dynamic
TLAS walk). Each instance intersects the full ray batch against its mesh's
BLAS with the ray mapped by the instance's world->object affine transform —
an affine map preserves the ray parameter, so object-space t IS world-space
t and best-hit merging needs no rescaling. The running best t feeds each
subsequent BLAS call's t_max, so the traversal prunes across instances
(nearest-first would prune best; instances are swept in creation order).

Memory is O(meshes), not O(instances x mesh): the win the reference's TLAS
exists for. Compile/trace time is O(total instances); this path is built
for moderate instance counts (tens), the flattening path (scene/dynamic.py)
remains the default for few-instance scenes where duplication is cheap.

The winning instance rides the hit record without changing `Hit`:
`prim_global = inst_index * T_pad + prim_local`, with T_pad the largest
BLAS padded-triangle count (static). `make_interaction` decodes it and maps
normals/tangents object->world per lane.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..accel import traversal as traversal_mod
from ..accel.bvh import BVH
from ..accel.traversal import Hit


class BlasEntry(NamedTuple):
    """One unique mesh's bottom-level acceleration structure."""

    bvh: BVH


class InstanceGroup(NamedTuple):
    """All instances of one mesh (aligned index-wise with the blas tuple).

    Arrays are per-instance; `prim_base` is the mesh's row offset into the
    concatenated object-space shading tables (an array so it stays a pytree
    leaf; its value is per-mesh, replicated per instance)."""

    to_object: jnp.ndarray   # (Ik, 3, 4) world->object affine rows
    to_world: jnp.ndarray    # (Ik, 3, 4) object->world affine rows
    mat_id: jnp.ndarray      # (Ik,) int32 per-instance material
    prim_base: jnp.ndarray   # (Ik,) int32 shading-row offset of this mesh
    world_lo: jnp.ndarray    # (Ik, 3) per-instance world AABB (top-level
    world_hi: jnp.ndarray    # (Ik, 3)  cull; +-inf disables)


def instance_tpad(blas: tuple) -> int:
    """Static per-instance prim stride (largest padded BLAS tri count)."""
    return max(int(e.bvh.woop.shape[0]) for e in blas)


# The object-space rays feed intersection, so the transforms run at full
# f32 precision (a GPU would otherwise take TF32 for an f32 matmul).
def _xform_point(M, p):
    return jnp.matmul(p, M[:, :3].T, precision=jax.lax.Precision.HIGHEST) \
        + M[:, 3]


def _xform_dir(M, d):
    return jnp.matmul(d, M[:, :3].T, precision=jax.lax.Precision.HIGHEST)


def intersect_instances(blas: tuple, groups: tuple, o, d, t_min, t_max,
                        any_hit: bool = False) -> Hit:
    """Two-level intersect: per-mesh `lax.scan` over that mesh's instances
    against the SHARED BLAS (a Python-unrolled loop would compile one BLAS
    program per INSTANCE; the scan keeps the compiled size O(meshes)).

    Top-level cull: each instance's world AABB is slab-tested per lane
    against the running best_t before its BLAS trace; lanes that miss get
    a degenerate t_max, so their traversal stops at the root — the batch
    analogue of the reference TLAS pruning instances per ray
    (TraceHelper.cu:528-712).

    Returns a Hit whose `prim` packs (instance index, local prim) as
    `inst * T_pad + prim_local` (decode with `instance_tpad`)."""
    B = o.shape[0]
    tpad = instance_tpad(blas)
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)

    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (B,)) + 0.0
    best_prim = jnp.full((B,), -1, jnp.int32)
    best_bary = jnp.zeros((B, 2), jnp.float32)
    found = jnp.zeros((B,), bool)
    base = 0
    for entry, grp in zip(blas, groups):
        Ik = grp.to_object.shape[0]

        def body(carry, xs, entry=entry):
            bt, bp, bb, fnd = carry
            M, wlo, whi, inst_id = xs
            # per-lane top-level AABB cull against the running best_t
            t0 = (wlo - o) * inv_d
            t1 = (whi - o) * inv_d
            near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), -1), t_min_b)
            far = jnp.minimum(jnp.min(jnp.maximum(t0, t1), -1),
                              t_max if any_hit else bt)
            overlap = near <= far
            oo = _xform_point(M, o)
            od = _xform_dir(M, d)
            cap = jnp.where(overlap, t_max if any_hit else bt, t_min_b)
            h = traversal_mod.intersect_auto(entry.bvh, oo, od, t_min, cap,
                                             any_hit=any_hit)
            if any_hit:
                return (bt, bp, bb, fnd | (h.valid & overlap)), None
            better = h.valid & overlap & (h.t < bt)
            return (
                jnp.where(better, h.t, bt),
                jnp.where(better, inst_id * tpad + h.prim, bp),
                jnp.where(better[:, None], h.bary, bb),
                fnd | better,
            ), None

        xs = (grp.to_object, grp.world_lo, grp.world_hi,
              base + jnp.arange(Ik, dtype=jnp.int32))
        (best_t, best_prim, best_bary, found), _ = jax.lax.scan(
            body, (best_t, best_prim, best_bary, found), xs)
        base += Ik
    if any_hit:
        return Hit(t=jnp.where(found, t_min, t_max),
                   prim=jnp.where(found, 0, -1),
                   bary=jnp.zeros((B, 2), jnp.float32), valid=found)
    return Hit(t=best_t, prim=best_prim, bary=best_bary, valid=found)


def flat_instance_arrays(groups: tuple):
    """(to_object (I,3,4), to_world (I,3,4), mat_id (I,), prim_base (I,))
    concatenated in the packed-inst-index order."""
    cat = lambda f: jnp.concatenate([getattr(g, f) for g in groups], axis=0)
    return cat("to_object"), cat("to_world"), cat("mat_id"), cat("prim_base")


def decode_hit(groups: tuple, tpad: int, hit: Hit):
    """(inst_id, local_prim, shading_row) from a packed instanced Hit."""
    prim = jnp.maximum(hit.prim, 0)
    inst = prim // tpad
    local = prim - inst * tpad
    _, _, _, prim_base = flat_instance_arrays(groups)
    from .scene import small_gather

    row = small_gather(prim_base, inst) + local
    return inst, local, row


def build_instance_groups(records, prim_bases, obj_bounds=None):
    """Host-side constructor. `records`: per mesh, a list of
    (to_world (4,4) float64, mat_id int); `prim_bases`: per mesh int row
    offset into the concatenated shading tables; `obj_bounds`: per mesh
    optional (lo (3,), hi (3,)) object-space AABB — transformed corners
    give each instance's world AABB for the top-level cull (omitted ->
    +-inf, cull disabled)."""
    groups = []
    for mi, (recs, base) in enumerate(zip(records, prim_bases)):
        tw = np.stack([np.asarray(m, np.float64)[:3, :4] for m, _ in recs])
        to_obj = []
        wlo, whi = [], []
        for m, _ in recs:
            m4 = np.asarray(m, np.float64)
            inv = np.linalg.inv(m4)
            to_obj.append(inv[:3, :4])
            if obj_bounds is not None:
                lo, hi = obj_bounds[mi]
                corners = np.array([[x, y, z]
                                    for x in (lo[0], hi[0])
                                    for y in (lo[1], hi[1])
                                    for z in (lo[2], hi[2])])
                wc = corners @ m4[:3, :3].T + m4[:3, 3]
                eps = 1e-4 * (np.abs(wc).max() + 1.0)
                wlo.append(wc.min(0) - eps)
                whi.append(wc.max(0) + eps)
            else:
                wlo.append(np.full(3, -np.inf))
                whi.append(np.full(3, np.inf))
        groups.append(InstanceGroup(
            to_object=jnp.asarray(np.stack(to_obj), jnp.float32),
            to_world=jnp.asarray(tw, jnp.float32),
            mat_id=jnp.asarray(np.asarray([mid for _, mid in recs], np.int32)),
            prim_base=jnp.asarray(
                np.full(len(recs), base, np.int32)),
            world_lo=jnp.asarray(np.stack(wlo), jnp.float32),
            world_hi=jnp.asarray(np.stack(whi), jnp.float32),
        ))
    return tuple(groups)
