"""Skeletal animation: bone-weighted skinning + per-frame scene update.

Counterpart of reference ``Engine/AnimatedMesh.{h,cpp,cu}`` (MD5 skeletal
animation: <=8 bone weights per vertex AnimatedMesh.h:10-20, per-frame matrix
palettes, GPU skinning kernel k_ComputeState + BVH refit). Design: the
skinning is one jitted einsum over the bone palette; Woop data + BVH boxes
refit on-device (accel/refit.py), so animation never leaves the chip and is
differentiable w.r.t. bone transforms (novel vs the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.refit import RefitPlan, build_refit_plan, refit_bvh
from .scene import Scene

MAX_WEIGHTS = 4  # reference uses up to g_uMaxWeights=8; 4 covers MD5 rigs


class SkinnedMesh(NamedTuple):
    """Rig data in BVH leaf order (per padded triangle corner)."""

    rest: jnp.ndarray       # (T, 3, 3) rest-pose vertices
    bone_ids: jnp.ndarray   # (T, 3, MAX_WEIGHTS) int32
    weights: jnp.ndarray    # (T, 3, MAX_WEIGHTS)
    inv_bind: jnp.ndarray   # (n_bones, 4, 4) inverse bind matrices
    plan: RefitPlan


def make_skinned(scene: Scene, host_nodes: np.ndarray, root: int,
                 bone_ids: np.ndarray, weights: np.ndarray,
                 inv_bind: np.ndarray) -> SkinnedMesh:
    """bone_ids/weights are per padded-triangle-corner (leaf order, same
    permutation as scene.shading)."""
    return SkinnedMesh(
        rest=scene.shading.verts,
        bone_ids=jnp.asarray(bone_ids.astype(np.int32)),
        weights=jnp.asarray(weights.astype(np.float32)),
        inv_bind=jnp.asarray(inv_bind.astype(np.float32)),
        plan=build_refit_plan(host_nodes, root),
    )


def skin_vertices(mesh: SkinnedMesh, pose: jnp.ndarray) -> jnp.ndarray:
    """Linear-blend skinning: pose (n_bones, 4, 4) world transforms.

    Returns deformed (T, 3, 3) vertices (the reference's k_ComputeState)."""
    palette = jnp.einsum("bij,bjk->bik", pose, mesh.inv_bind,
                         precision=jax.lax.Precision.HIGHEST)  # (B, 4, 4)
    M = palette[mesh.bone_ids]                # (T, 3, W, 4, 4)
    rest_h = jnp.concatenate(
        [mesh.rest, jnp.ones(mesh.rest.shape[:-1] + (1,))], axis=-1
    )                                          # (T, 3, 4)
    moved = jnp.einsum("tcwij,tcj->tcwi", M, rest_h,
                       precision=jax.lax.Precision.HIGHEST)[..., :3]
    return jnp.sum(moved * mesh.weights[..., None], axis=2)


def animate_scene(scene: Scene, mesh: SkinnedMesh, pose) -> Scene:
    """One animation step: skin -> refit -> updated Scene (all on device,
    the counterpart of DynamicScene::AnimateMesh + UpdateScene)."""
    verts = skin_vertices(mesh, pose)
    bvh = refit_bvh(scene.bvh, mesh.plan, verts)
    # refresh geometric shading data; vertex normals re-derived per face
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = jnp.cross(e1, e2)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = jnp.repeat(n[:, None, :], 3, axis=1)
    shading = scene.shading._replace(verts=verts, normals=normals)
    return scene._replace(bvh=bvh, shading=shading)


def rigid_pose(n_bones: int, transforms: list) -> jnp.ndarray:
    """Helper: list of (4,4) numpy transforms -> pose array."""
    out = np.stack([np.asarray(t, np.float32) for t in transforms])
    assert out.shape == (n_bones, 4, 4)
    return jnp.asarray(out)
