"""Batched BVH traversal and ray-triangle intersection in pure XLA.

Counterpart of the reference's Aila-Laine persistent-threads traversal
kernel (Kernel/TraceHelper.cu:326-746). `intersect` runs a *lockstep*
`lax.while_loop` over a SoA ray batch where every lane keeps its own
traversal stack in a (B, STACK_DEPTH) array. Each step gathers one 16-float
"fat" node (both child AABBs — the same layout as the reference's
4-wide-float nodes, Engine/TriIntersectorData.h:42-60), does a
distance-ordered descent, and intersects LEAF_SIZE Woop triangles when a
lane sits on a leaf (Woop test math as Kernel/TraceHelper.cu:638-685).

It is the CPU intersector and the reference for the CUDA kernel in
ops/bvh_trace.cu, which walks the same arrays one thread per ray;
`intersect_auto` picks between them through backend.by_platform.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .bvh import BVH, LEAF_SIZE

# Entries of the per-lane stack. It never overflows: a lane's stack holds at
# most one far child per inner ancestor, and build_bvh refuses a tree deeper
# than this (bvh.check_depth).
STACK_DEPTH = 64
DONE = jnp.int32(-(2**30))


class Hit(NamedTuple):
    """SoA hit record, counterpart of reference `traversalResult`
    (Kernel/TraceHelper.h:55-69)."""

    t: jnp.ndarray        # (B,) hit distance (= tmax if miss)
    prim: jnp.ndarray     # (B,) padded-triangle index into bvh.woop order, -1 if miss
    bary: jnp.ndarray     # (B, 2) barycentric (u, v) of hit
    valid: jnp.ndarray    # (B,) bool


def intersect_woop(woop_rows, o, d, t_min, t_max):
    """Woop ray/triangle test, vectorized.

    woop_rows: (..., 12); o, d: (..., 3). Returns (t, u, v, hit_mask).
    """
    r0 = woop_rows[..., 0:4]
    r1 = woop_rows[..., 4:8]
    r2 = woop_rows[..., 8:12]
    oz = jnp.sum(r2[..., :3] * o, axis=-1) + r2[..., 3]
    dz = jnp.sum(r2[..., :3] * d, axis=-1)
    inv_dz = 1.0 / jnp.where(jnp.abs(dz) < 1e-20, 1e-20, dz)
    t = -oz * inv_dz
    u = jnp.sum(r0[..., :3] * o, axis=-1) + r0[..., 3] + t * jnp.sum(r0[..., :3] * d, axis=-1)
    v = jnp.sum(r1[..., :3] * o, axis=-1) + r1[..., 3] + t * jnp.sum(r1[..., :3] * d, axis=-1)
    hit = (
        (t > t_min)
        & (t < t_max)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & jnp.isfinite(t)
    )
    return t, u, v, hit


def _slab_test(lo, hi, o, inv_d, t_min, t_max):
    """AABB slab test. lo/hi: (..., 3). Returns (hit, t_near)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    near_c = jnp.maximum(near, t_min)
    far_c = jnp.minimum(far, t_max)
    return near_c <= far_c, near


class _State(NamedTuple):
    node: jnp.ndarray      # (B,) current child code (DONE when finished)
    stack: jnp.ndarray     # (B, STACK_DEPTH)
    sp: jnp.ndarray        # (B,)
    t_hit: jnp.ndarray     # (B,)
    prim: jnp.ndarray      # (B,)
    bary: jnp.ndarray      # (B, 2)
    steps: jnp.ndarray     # () iteration counter (safety bound)


def intersect(bvh: BVH, o, d, t_min=1e-4, t_max=jnp.inf, any_hit: bool = False,
              max_steps: int = 100_000):
    """Trace a batch of rays against the BVH.

    Args:
      o, d: (B, 3) ray origins/directions (d need not be normalized).
      t_min/t_max: scalars or (B,).
      any_hit: stop a lane at its first intersection (shadow rays, reference
        `intersectKernel<ANY_HIT>` Kernel/TraceHelper.cu:675-679).

    Returns: Hit.
    """
    B = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (B,))
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)

    nodes = bvh.nodes
    woop = bvh.woop

    init = _State(
        node=jnp.broadcast_to(bvh.root_code, (B,)).astype(jnp.int32),
        stack=jnp.zeros((B, STACK_DEPTH), jnp.int32),
        sp=jnp.zeros((B,), jnp.int32),
        t_hit=t_max,
        prim=jnp.full((B,), -1, jnp.int32),
        bary=jnp.zeros((B, 2), jnp.float32),
        steps=jnp.int32(0),
    )

    def cond(s: _State):
        return jnp.any(s.node != DONE) & (s.steps < max_steps)

    def body(s: _State) -> _State:
        active = s.node != DONE
        is_inner = active & (s.node >= 0)
        is_leaf = active & (s.node < 0)

        # ---- inner-node phase (computed for all lanes, masked) ----
        n_idx = jnp.where(is_inner, s.node, 0)
        rows = jnp.take(nodes, n_idx, axis=0)  # (B, 16)
        c0_hit, c0_near = _slab_test(rows[:, 0:3], rows[:, 3:6], o, inv_d, t_min, s.t_hit)
        c1_hit, c1_near = _slab_test(rows[:, 6:9], rows[:, 9:12], o, inv_d, t_min, s.t_hit)
        c0 = jax.lax.bitcast_convert_type(rows[:, 12], jnp.int32)
        c1 = jax.lax.bitcast_convert_type(rows[:, 13], jnp.int32)
        swap = c1_hit & (~c0_hit | (c1_near < c0_near))
        near_code = jnp.where(swap, c1, c0)
        far_code = jnp.where(swap, c0, c1)
        both = c0_hit & c1_hit
        any_child = c0_hit | c1_hit

        # push far child when both children hit: one masked scatter of B lanes
        # (a full-array where would rewrite the whole (B, STACK_DEPTH) stack
        # every step — STACK_DEPTH x the memory traffic)
        push = is_inner & both
        sp_clamped = jnp.minimum(s.sp, STACK_DEPTH - 1)
        col = jnp.where(push, sp_clamped, STACK_DEPTH)  # OOB -> dropped
        stack = s.stack.at[jnp.arange(s.stack.shape[0]), col].set(
            far_code, mode="drop"
        )
        sp_after_push = jnp.where(push, jnp.minimum(s.sp + 1, STACK_DEPTH), s.sp)

        # ---- leaf phase (masked) ----
        first = jnp.where(is_leaf, -(s.node + 1), 0)
        tri_ids = first[:, None] + jnp.arange(LEAF_SIZE)[None, :]  # (B, L)
        tri_ids = jnp.clip(tri_ids, 0, woop.shape[0] - 1)
        rows_w = jnp.take(woop, tri_ids.reshape(-1), axis=0).reshape(B, LEAF_SIZE, 12)
        t, u, v, h = intersect_woop(
            rows_w, o[:, None, :], d[:, None, :], t_min[:, None], s.t_hit[:, None]
        )
        h = h & is_leaf[:, None]
        t_masked = jnp.where(h, t, jnp.inf)
        best = jnp.argmin(t_masked, axis=-1)
        best_t = jnp.take_along_axis(t_masked, best[:, None], axis=-1)[:, 0]
        leaf_hit = jnp.any(h, axis=-1)
        new_t = jnp.where(leaf_hit, best_t, s.t_hit)
        new_prim = jnp.where(
            leaf_hit, jnp.take_along_axis(tri_ids, best[:, None], axis=-1)[:, 0], s.prim
        )
        bu = jnp.take_along_axis(u, best[:, None], axis=-1)[:, 0]
        bv = jnp.take_along_axis(v, best[:, None], axis=-1)[:, 0]
        new_bary = jnp.where(leaf_hit[:, None], jnp.stack([bu, bv], axis=-1), s.bary)

        # ---- next node ----
        # inner lane: near child if any child hit else pop; leaf lane: pop.
        descend = is_inner & any_child
        need_pop = active & ~descend
        can_pop = sp_after_push > 0
        sp_idx = jnp.maximum(sp_after_push - 1, 0)
        popped = jnp.take_along_axis(stack, sp_idx[:, None], axis=-1)[:, 0]
        next_node = jnp.where(
            descend,
            near_code,
            jnp.where(need_pop & can_pop, popped, DONE),
        )
        new_sp = jnp.where(need_pop & can_pop, sp_idx, sp_after_push)
        if any_hit:
            finished = leaf_hit  # first hit terminates the lane
            next_node = jnp.where(finished, DONE, next_node)
        next_node = jnp.where(active, next_node, DONE)

        return _State(
            node=next_node,
            stack=stack,
            sp=new_sp,
            t_hit=new_t,
            prim=new_prim,
            bary=new_bary,
            steps=s.steps + 1,
        )

    final = jax.lax.while_loop(cond, body, init)
    valid = final.prim >= 0
    return Hit(t=final.t_hit, prim=final.prim, bary=final.bary, valid=valid)


@jax.custom_jvp
def _refine_passthrough(woop, o, d, t, u, v, prim, valid):
    """Forward: the intersector's own (exact) t/u/v pass through untouched —
    no gather, no recompute. Only the tangent rule (below) pays for the
    closed-form Woop re-evaluation, so autodiff sees the hit as a function of
    (woop rows, o, d) while the forward render costs nothing extra. This is
    what makes the CUDA kernel differentiable without a custom backward
    kernel (SURVEY.md §7 "differentiable hit refinement")."""
    return t, u, v


@_refine_passthrough.defjvp
def _refine_passthrough_jvp(primals, tangents):
    woop, o, d, t, u, v, prim, valid = primals
    dwoop, do, dd = tangents[0], tangents[1], tangents[2]

    def closed(woop, o, d):
        rows = jnp.take(woop, jnp.maximum(prim, 0), axis=0)
        tt, uu, vv, _ = intersect_woop(rows, o, d, -jnp.inf, jnp.inf)
        return (jnp.where(valid, tt, t), jnp.where(valid, uu, u),
                jnp.where(valid, vv, v))

    zeros = lambda x, dx: (jnp.zeros_like(x)
                           if isinstance(dx, jax.custom_derivatives.SymbolicZero)
                           else dx)
    _, tangent_out = jax.jvp(
        closed, (woop, o, d), (zeros(woop, dwoop), zeros(o, do), zeros(d, dd))
    )
    return (t, u, v), tangent_out


def refine_hit(bvh: BVH, o, d, hit: Hit) -> Hit:
    """Differentiable hit refinement: given the (detached) hit triangle id,
    gradients w.r.t. ray origin/direction and vertex positions flow through a
    closed-form Woop re-evaluation — while the forward values are the
    intersector's own outputs, passed through at zero cost (a recompute
    would gather every lane's Woop rows a second time)."""
    sg = jax.lax.stop_gradient
    t, u, v = _refine_passthrough(
        bvh.woop, o, d, sg(hit.t), sg(hit.bary[..., 0]), sg(hit.bary[..., 1]),
        sg(hit.prim), sg(hit.valid),
    )
    return Hit(
        t=t,
        prim=sg(hit.prim),
        bary=jnp.stack([u, v], axis=-1),
        valid=sg(hit.valid),
    )


# Padded-triangle count at or below which the CPU path tests all triangles
# instead of traversing. The GPU always traverses: on an H100 the kernel
# beat brute force on Cornell (60 tris) end to end (PERF.md).
BRUTE_MAX_TRIS_CPU = 512


def _detached(raw_fn, bvh: BVH, o, d, t_min, t_max, any_hit: bool) -> Hit:
    """The raw intersector runs fully detached (the CUDA kernel has no AD
    rule, and differentiating a traversal would be wasted work anyway); all
    hit-value tangents flow through `refine_hit`'s custom_jvp instead."""
    sg = jax.lax.stop_gradient
    raw = raw_fn(sg(bvh), sg(o), sg(d), sg(t_min), sg(t_max), any_hit=any_hit)
    if any_hit:  # occlusion queries only consume .valid — skip refinement
        return raw
    return refine_hit(bvh, o, d, raw)


def _intersect_cpu(bvh: BVH, o, d, t_min, t_max, any_hit: bool) -> Hit:
    if bvh.woop.shape[0] <= BRUTE_MAX_TRIS_CPU:
        return intersect_brute_force(bvh, o, d, t_min, t_max)
    return _detached(intersect, bvh, o, d, t_min, t_max, any_hit)


def intersect_auto(bvh: BVH, o, d, t_min=1e-4, t_max=jnp.inf,
                   any_hit: bool = False) -> Hit:
    """Closest- or any-hit query through the intersector of the platform the
    program is lowered for: the CUDA kernel on a GPU, the XLA oracle on the
    CPU (brute force there for tiny scenes)."""
    from .. import backend
    from ..ops import bvh_trace

    B = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (B,))
    with jax.named_scope("intersect"):
        return backend.by_platform(
            gpu=lambda: _detached(bvh_trace.intersect_kernel, bvh, o, d,
                                  t_min, t_max, any_hit),
            cpu=lambda: _intersect_cpu(bvh, o, d, t_min, t_max, any_hit))


def occluded(bvh: BVH, o, d, t_min=1e-4, t_max=jnp.inf):
    """Any-hit query: True where the segment is blocked
    (reference KernelDynamicScene::Occluded, Engine/KernelDynamicScene.cu)."""
    return intersect_auto(bvh, o, d, t_min, t_max, any_hit=True).valid


def intersect_brute_force(bvh: BVH, o, d, t_min=1e-4, t_max=jnp.inf):
    """O(B*T) all-triangles oracle for correctness tests."""
    B = o.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (B,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (B,))
    t, u, v, h = intersect_woop(
        bvh.woop[None, :, :], o[:, None, :], d[:, None, :], t_min_b[:, None], t_max_b[:, None]
    )
    t_masked = jnp.where(h, t, jnp.inf)
    best = jnp.argmin(t_masked, axis=-1)
    best_t = jnp.take_along_axis(t_masked, best[:, None], axis=-1)[:, 0]
    hit_any = jnp.any(h, axis=-1)
    bu = jnp.take_along_axis(u, best[:, None], axis=-1)[:, 0]
    bv = jnp.take_along_axis(v, best[:, None], axis=-1)[:, 0]
    return Hit(
        t=jnp.where(hit_any, best_t, t_max_b),
        prim=jnp.where(hit_any, best.astype(jnp.int32), -1),
        bary=jnp.stack([bu, bv], axis=-1),
        valid=hit_any,
    )
