"""DynamicScene: the mutable host-side scene database.

Counterpart of reference ``Engine/DynamicScene.{h,cpp}`` (DynamicScene.h:40 —
owns all streams; CreateNode/CreateLight/CreateVolume/setEnvironementMap;
UpdateScene flushes dirty ranges + rebuilds the scene BVH,
DynamicScene.cpp:480-556) and the instance `Node` concept
(SceneTypes/Node.h:13).

Design: mutation happens host-side on numpy staging arrays; `update()` is
the single host->device boundary — it rebuilds the BVH (native C++ builder),
re-derives the light CDF and emits a fresh immutable Scene pytree (the
KernelDynamicScene analogue). Instances are flattened at update time
(transform baked into vertices) unless the scene asks for the two-level
path (scene/instances.py): replication costs memory but keeps traversal
single-level.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import bsdf as B
from . import lights as L
from .scene import Materials, Scene, build_scene
from .sensors import Camera
from .textures import Textures


@dataclass
class MeshHandle:
    mesh_id: int
    vertices: np.ndarray          # (T, 3, 3)
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]


@dataclass
class NodeHandle:
    """An instanced mesh placement (reference Node: mesh idx + material set)."""

    node_id: int
    mesh_id: int
    to_world: np.ndarray          # (4, 4)
    mat_record: dict
    light_radiance: Optional[np.ndarray] = None  # area emitter on this node


class DynamicScene:
    def __init__(self):
        self._meshes: dict[int, MeshHandle] = {}
        self._nodes: dict[int, NodeHandle] = {}
        self._lights: list[dict] = []
        self._env_map: Optional[np.ndarray] = None
        self._camera = Camera.look_at([0, -5, 1], [0, 0, 1])
        self._tex_records: list[dict] = [{"type": 0, "color_a": [0.7] * 3}]
        self._next_id = 0
        self._dirty = True
        self._scene: Optional[Scene] = None

    # ---- creation API (reference CreateNode/CreateLight/...) ----

    def create_mesh(self, vertices, normals=None, uvs=None) -> MeshHandle:
        self._next_id += 1
        h = MeshHandle(self._next_id, np.asarray(vertices, np.float32), normals, uvs)
        self._meshes[h.mesh_id] = h
        self._dirty = True
        return h

    def create_node(self, mesh: MeshHandle, to_world=None,
                    mat_record: Optional[dict] = None) -> NodeHandle:
        self._next_id += 1
        h = NodeHandle(
            self._next_id, mesh.mesh_id,
            np.asarray(to_world if to_world is not None else np.eye(4), np.float64),
            dict(mat_record or {"bsdf_type": B.DIFFUSE, "tex_albedo": 0}),
        )
        self._nodes[h.node_id] = h
        self._dirty = True
        return h

    def remove_node(self, node: NodeHandle) -> None:
        self._nodes.pop(node.node_id, None)
        self._dirty = True

    def set_node_transform(self, node: NodeHandle, to_world) -> None:
        node.to_world = np.asarray(to_world, np.float64)
        self._dirty = True

    def create_light(self, record: dict) -> int:
        self._lights.append(dict(record))
        self._dirty = True
        return len(self._lights) - 1

    def make_node_emissive(self, node: NodeHandle, radiance) -> None:
        """Attach an area emitter to a node (reference createShape+emitter)."""
        node.light_radiance = np.asarray(radiance, np.float32)
        self._dirty = True

    def set_environment_map(self, env: np.ndarray, radiance=(1.0, 1.0, 1.0)) -> None:
        self._env_map = np.asarray(env, np.float32)
        self.create_light({"type": L.INFINITE, "radiance": radiance})

    def set_camera(self, camera: Camera) -> None:
        self._camera = camera
        self._dirty = True

    def add_texture(self, record: dict) -> int:
        self._tex_records.append(dict(record))
        self._dirty = True
        return len(self._tex_records) - 1

    # ---- update cycle (reference UpdateScene) ----

    def update(self, instancing: bool = False) -> Scene:
        """Flush all mutations into a fresh device Scene pytree.

        `instancing=True` builds an instance-level TLAS scene
        (scene/instances.py): per-mesh BLAS built ONCE and cached
        (`self._blas_cache`), per-instance transforms applied at traversal —
        O(mesh) memory, and transform-only updates skip every BVH/cluster
        build (the reference BVHRebuilder's invalidate/refit cycle,
        Engine/SpatialStructures/BVH/BVHRebuilder.h:30-82). The default
        flattening path bakes transforms into vertices (best for few
        instances: single-level traversal)."""
        if instancing:
            return self._update_instanced()
        if not self._dirty and self._scene is not None:
            return self._scene
        parts, norms, uvs, mids = [], [], [], []
        mat_records: list[dict] = []
        light_records = [dict(r) for r in self._lights]
        for node in self._nodes.values():
            mesh = self._meshes[node.mesh_id]
            m = node.to_world
            v = (mesh.vertices.reshape(-1, 3) @ m[:3, :3].T + m[:3, 3]).reshape(
                -1, 3, 3).astype(np.float32)
            n = mesh.normals
            if n is not None:
                nm = np.linalg.inv(m[:3, :3]).T
                n = (np.asarray(n).reshape(-1, 3) @ nm.T).reshape(-1, 3, 3)
                n = (n / np.maximum(np.linalg.norm(n, -1, keepdims=True), 1e-12)
                     ).astype(np.float32)
            rec = dict(node.mat_record)
            if node.light_radiance is not None:
                rec["emission"] = node.light_radiance
                rec["light_id"] = len(light_records)
                light_records.append({
                    "type": L.AREA_LIGHT, "radiance": node.light_radiance,
                    "tris": v,
                })
            mid = len(mat_records)
            mat_records.append(rec)
            parts.append(v)
            norms.append(n)
            uvs.append(mesh.uvs)
            mids.extend([mid] * len(v))

        if not parts:
            raise ValueError("DynamicScene has no nodes")
        vertices = np.concatenate(parts)
        normals = (np.concatenate([n if n is not None else _face_n(p)
                                   for n, p in zip(norms, parts)]))
        all_uvs = np.concatenate([u if u is not None else _default_uv(len(p))
                                  for u, p in zip(uvs, parts)])
        self._scene = build_scene(
            vertices, normals, all_uvs, np.asarray(mids, np.int32),
            Materials.build(mat_records), Textures.build(self._tex_records),
            light_records, self._camera, env_map=self._env_map,
        )
        self._dirty = False
        return self._scene


    def _update_instanced(self) -> Scene:
        import jax.numpy as jnp

        from ..accel.bvh import build_bvh
        from ._hostcache import register_specialization
        from .instances import build_instance_groups
        from .lights import build_lights, light_power
        from .scene import ShadingData
        from .instances import BlasEntry

        if not hasattr(self, "_blas_cache"):
            self._blas_cache = {}

        # group nodes by mesh (insertion order)
        by_mesh: dict[int, list[NodeHandle]] = {}
        for node in self._nodes.values():
            by_mesh.setdefault(node.mesh_id, []).append(node)
        if not by_mesh:
            raise ValueError("DynamicScene has no nodes")

        blas_entries = []
        shading_parts = []
        prim_bases = []
        base = 0
        for mesh_id in by_mesh:
            mesh = self._meshes[mesh_id]
            cached = self._blas_cache.get(mesh_id)
            if cached is None:
                v = mesh.vertices
                bvh, host = build_bvh(v, with_host=True)
                order = host["order"]
                v_ord = v[order]
                n = mesh.normals
                n_ord = (np.asarray(n, np.float32)[order] if n is not None
                         else _face_n(v_ord))
                uv = mesh.uvs
                uv_ord = (np.asarray(uv, np.float32)[order] if uv is not None
                          else _default_uv(len(v_ord)))
                nf = np.cross(v_ord[:, 1] - v_ord[:, 0],
                              v_ord[:, 2] - v_ord[:, 0])
                nf = (nf / np.maximum(
                    np.linalg.norm(nf, axis=-1, keepdims=True), 1e-12)
                ).astype(np.float32)
                duv1 = uv_ord[:, 1] - uv_ord[:, 0]
                duv2 = uv_ord[:, 2] - uv_ord[:, 0]
                uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1]
                                       - duv1[:, 1] * duv2[:, 0])
                w_area = 0.5 * np.linalg.norm(
                    np.cross(v_ord[:, 1] - v_ord[:, 0],
                             v_ord[:, 2] - v_ord[:, 0]), axis=-1)
                uvd = np.sqrt(uv_area / np.maximum(w_area, 1e-20)
                              ).astype(np.float32)
                cached = dict(bvh=bvh, verts=v_ord,
                              normals=n_ord, uvs=uv_ord, n_face=nf,
                              uv_density=uvd)
                self._blas_cache[mesh_id] = cached
            blas_entries.append(BlasEntry(bvh=cached["bvh"]))
            shading_parts.append(cached)
            prim_bases.append(base)
            base += cached["verts"].shape[0]

        # per-node materials (+ area emitters with world-space light tris)
        mat_records: list[dict] = []
        light_records = [dict(r) for r in self._lights]
        inst_records = []
        for mesh_id, nodes in by_mesh.items():
            recs = []
            mesh = self._meshes[mesh_id]
            for node in nodes:
                rec = dict(node.mat_record)
                if node.light_radiance is not None:
                    m = node.to_world
                    v_w = (mesh.vertices.reshape(-1, 3) @ m[:3, :3].T
                           + m[:3, 3]).reshape(-1, 3, 3).astype(np.float32)
                    rec["emission"] = node.light_radiance
                    rec["light_id"] = len(light_records)
                    light_records.append({
                        "type": L.AREA_LIGHT,
                        "radiance": node.light_radiance, "tris": v_w,
                    })
                mid = len(mat_records)
                mat_records.append(rec)
                recs.append((node.to_world, mid))
            inst_records.append(recs)
        obj_bounds = []
        for mesh_id in by_mesh:
            v = self._meshes[mesh_id].vertices.reshape(-1, 3)
            obj_bounds.append((v.min(0), v.max(0)))
        groups = build_instance_groups(inst_records, prim_bases, obj_bounds)

        # shading tables: OBJECT space, concatenated in prim_base order;
        # mat_id column holds each mesh's first instance's material (the
        # traversal overrides it per instance)
        cat = lambda k: np.concatenate([p[k] for p in shading_parts])
        mids = np.concatenate([
            np.full(p["verts"].shape[0], recs[0][1], np.int32)
            for p, recs in zip(shading_parts, inst_records)])
        shading = ShadingData(
            verts=jnp.asarray(cat("verts")),
            normals=jnp.asarray(cat("normals")),
            uvs=jnp.asarray(cat("uvs")),
            mat_id=jnp.asarray(mids),
            n_face=jnp.asarray(cat("n_face")),
            uv_density=jnp.asarray(cat("uv_density")),
        )

        # world bounds: union of transformed mesh AABB corners
        wmin = np.full(3, np.inf)
        wmax = np.full(3, -np.inf)
        for mesh_id, nodes in by_mesh.items():
            v = self._meshes[mesh_id].vertices.reshape(-1, 3)
            lo, hi = v.min(0), v.max(0)
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            for node in nodes:
                m = node.to_world
                cw = corners @ m[:3, :3].T + m[:3, 3]
                wmin = np.minimum(wmin, cw.min(0))
                wmax = np.maximum(wmax, cw.max(0))
        center = 0.5 * (wmin + wmax)
        radius = 0.5 * float(np.linalg.norm(wmax - wmin)) + 1e-4

        materials = Materials.build(mat_records)
        textures = Textures.build(self._tex_records)
        lights = build_lights(light_records, center, radius, self._env_map)
        power = light_power(lights)
        if len(light_records) == 0:
            power = jnp.zeros_like(power)
        cdf = jnp.cumsum(power) / jnp.maximum(jnp.sum(power), 1e-20)
        env_id = -1
        for i, r in enumerate(light_records):
            if r["type"] in (L.INFINITE, L.CONSTANT_ENV):
                env_id = i

        register_specialization(shading.mat_id, dict(
            bsdf_types=tuple(sorted({int(r.get("bsdf_type", 0))
                                     for r in mat_records})),
            light_types=tuple(sorted({int(r["type"])
                                      for r in light_records})) or (0,),
            tex_types=tuple(sorted({int(t.get("type", 0))
                                    for t in self._tex_records})),
            flat_shading=False,
            normal_maps=False, height_maps=False, parallax=False,
            alpha_test=False,
        ))

        bvh0 = blas_entries[0].bvh._replace(
            world_min=wmin.astype(np.float32), world_max=wmax.astype(np.float32))
        self._scene = Scene(
            bvh=bvh0,
            shading=shading,
            materials=materials,
            textures=textures,
            lights=lights,
            light_cdf=cdf,
            camera=self._camera,
            env_light_id=jnp.asarray(np.int32(env_id)),
            blas=tuple(blas_entries),
            instances=groups,
        )
        self._dirty = False
        return self._scene


def _face_n(v):
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)


def _default_uv(t):
    uv = np.zeros((t, 3, 2), np.float32)
    uv[:, 1, 0] = 1.0
    uv[:, 2, 1] = 1.0
    return uv
