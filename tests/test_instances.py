"""Instance-level TLAS tests (scene/instances.py).

Reference parity: Engine/SceneBVH_device.h:9-16 (per-node transform +
inverse arrays), BVHRebuilder.h:30-82 (incremental update),
SceneTypes/Node.h:13 (instances)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cudatracerlib_tpu.render.path_tracer import PTConfig, render
from cudatracerlib_tpu.sampling.rng import Sampler
from cudatracerlib_tpu.scene import bsdf as B
from cudatracerlib_tpu.scene import lights as L
from cudatracerlib_tpu.scene.dynamic import DynamicScene
from cudatracerlib_tpu.scene.scene import scene_intersect
from cudatracerlib_tpu.scene.sensors import Camera
from cudatracerlib_tpu.scene.shapes import box, quad


def _translate(x, y, z, s=1.0):
    m = np.eye(4)
    m[:3, :3] *= s
    m[:3, 3] = [x, y, z]
    return m


def _rot_z(deg):
    a = np.radians(deg)
    m = np.eye(4)
    m[0, 0] = np.cos(a)
    m[0, 1] = -np.sin(a)
    m[1, 0] = np.sin(a)
    m[1, 1] = np.cos(a)
    return m


def _build(n=4, instancing=False):
    ds = DynamicScene()
    cube = ds.create_mesh(box([-0.3, -0.3, 0.0], [0.3, 0.3, 0.6]))
    floor = ds.create_mesh(quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
    lightq = ds.create_mesh(
        quad([-0.6, -0.6, 3.2], [-0.6, 0.6, 3.2], [0.6, 0.6, 3.2],
             [0.6, -0.6, 3.2]))
    nodes = []
    for i in range(n):
        ang = 360.0 * i / n
        m = _rot_z(ang) @ _translate(1.2, 0.0, 0.0, s=0.7 + 0.15 * i)
        nodes.append(ds.create_node(
            cube, m, {"bsdf_type": B.DIFFUSE, "tex_albedo": 0}))
    ds.create_node(floor, np.eye(4), {"bsdf_type": B.DIFFUSE, "tex_albedo": 0})
    ln = ds.create_node(lightq, np.eye(4),
                        {"bsdf_type": B.DIFFUSE, "tex_albedo": 0})
    ds.make_node_emissive(ln, [14.0, 13.0, 12.0])
    ds.set_camera(Camera.look_at([0, -5.5, 3.0], [0, 0, 0.4],
                                 up=[0, 0, 1], fov_deg=45.0))
    return ds, nodes, ds.update(instancing=instancing)


class TestInstancedTLAS:
    def test_intersect_matches_flattened(self):
        _, _, flat = _build(4, instancing=False)
        _, _, inst = _build(4, instancing=True)
        B_ = 4096
        pid = jnp.arange(B_, dtype=jnp.uint32)
        s = Sampler.create(jnp.uint32(0), pid, pid * 0)
        s, u = s.next_2d()
        from cudatracerlib_tpu.scene import sensors

        o, d, _ = sensors.sample_ray(flat.camera, u, u)
        hf = scene_intersect(flat, o, d)
        hi = scene_intersect(inst, o, d)
        assert np.mean(np.asarray(hf.valid) == np.asarray(hi.valid)) > 0.999
        both = np.asarray(hf.valid) & np.asarray(hi.valid)
        np.testing.assert_allclose(np.asarray(hf.t)[both],
                                   np.asarray(hi.t)[both], rtol=2e-4,
                                   atol=2e-4)

    def test_render_matches_flattened(self):
        _, _, flat = _build(3, instancing=False)
        _, _, inst = _build(3, instancing=True)
        cfg = PTConfig(max_depth=3)
        a = np.asarray(render(flat, 48, 48, 8, jnp.uint32(1), cfg))
        b = np.asarray(render(inst, 48, 48, 8, jnp.uint32(1), cfg))
        # identical geometry, same sampler streams -> images agree closely
        assert np.mean(np.abs(a - b)) < 0.02 * max(np.mean(a), 1e-3) + 2e-3

    def test_o_mesh_memory(self):
        ds, _, inst = _build(8, instancing=True)
        cube_tris = 12
        # shading rows = unique meshes' tris, NOT n_instances * tris
        n_rows = int(inst.shading.verts.shape[0])
        assert n_rows < 8 * cube_tris  # would be >= 96 if flattened
        assert len(inst.instances) == 3  # cube group, floor, light
        assert int(inst.instances[0].to_object.shape[0]) == 8

    def test_transform_update_skips_blas_rebuild(self):
        ds, nodes, inst = _build(4, instancing=True)
        cache_ids = {k: id(v["bvh"]) for k, v in ds._blas_cache.items()}
        h0 = scene_intersect(inst, jnp.asarray([[2.2, 0.0, 5.0]]),
                             jnp.asarray([[0.0, 0.0, -1.0]]))
        ds.set_node_transform(nodes[0], _translate(2.2, 0.0, 0.0))
        inst2 = ds.update(instancing=True)
        # BLAS untouched (no rebuild), but the moved instance is hit
        assert {k: id(v["bvh"]) for k, v in ds._blas_cache.items()} == cache_ids
        h1 = scene_intersect(inst2, jnp.asarray([[2.2, 0.0, 5.0]]),
                             jnp.asarray([[0.0, 0.0, -1.0]]))
        # before the move the ray over (2.2, 0) hits only the floor (t=5);
        # after, it hits the moved cube top (z=0.6 -> t=4.4)
        assert float(h1.t[0]) < float(h0.t[0]) - 0.3

    def test_many_instances_scan_compiles(self):
        """The lax.scan TLAS (round 5) keeps the compiled program O(meshes),
        not O(instances): a 300-instance forest builds, compiles, and
        traces in one short test — the round-4 Python-unrolled loop
        compiled one BLAS program per instance and was explicitly scoped
        to 'tens'. Correctness is pinned against the flattened scene."""
        import time

        n = 300
        ds = DynamicScene()
        cube = ds.create_mesh(box([-0.1, -0.1, 0.0], [0.1, 0.1, 0.3]))
        rng = np.random.default_rng(3)
        for i in range(n):
            x, y = rng.uniform(-3, 3, 2)
            m = _translate(x, y, 0.0, s=0.5 + rng.uniform(0, 1))
            ds.create_node(cube, m, {"bsdf_type": B.DIFFUSE,
                                     "tex_albedo": 0})
        floor = ds.create_mesh(quad([-4, -4, 0], [4, -4, 0], [4, 4, 0],
                                    [-4, 4, 0]))
        ds.create_node(floor, np.eye(4), {"bsdf_type": B.DIFFUSE,
                                          "tex_albedo": 0})
        ds.set_camera(Camera.look_at([0, -6, 4.0], [0, 0, 0.2],
                                     up=[0, 0, 1], fov_deg=50.0))
        t0 = time.perf_counter()
        inst = ds.update(instancing=True)
        flat = ds.update(instancing=False)
        o = jnp.asarray(np.stack([
            rng.uniform(-3, 3, 64), np.full(64, -6.0),
            np.full(64, 4.0)], -1).astype(np.float32))
        d = jnp.asarray(np.tile([0.0, 0.8, -0.6], (64, 1)).astype(np.float32))
        hi = scene_intersect(inst, o, d)
        hf = scene_intersect(flat, o, d)
        dt = time.perf_counter() - t0
        np.testing.assert_allclose(np.asarray(hi.t), np.asarray(hf.t),
                                   rtol=1e-4, atol=1e-4)
        assert bool(np.all(np.asarray(hi.valid) == np.asarray(hf.valid)))
        # compile-size regression guard: generous bound, but the unrolled
        # 300-program build blew far past it
        assert dt < 180.0, dt
