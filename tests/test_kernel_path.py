"""The traversal path around the CUDA kernel, on the CPU.

The kernel itself (ops/bvh_trace.cu) runs only on a GPU (tests/test_gpu.py).
Everything around it is plain JAX and is checked here: the XLA oracle it is
compared with, the one backend decision, the wrapper's ray packing, padding,
un-padding and Hit decoding (with the oracle standing in for the FFI call),
the BVH depth bound, the compile-cache placement, that no Pallas kernel or
platform-name test is left, and that every f32 contraction states its
precision.
"""
import ast
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cudatracerlib_tpu as ct
from cudatracerlib_tpu import backend
from cudatracerlib_tpu.accel import traversal
from cudatracerlib_tpu.accel.bvh import build_bvh, check_depth, tree_depth
from cudatracerlib_tpu.ops import bvh_trace
from cudatracerlib_tpu.scene.shapes import box, quad, sphere

PKG = pathlib.Path(ct.__file__).parent
REPO = PKG.parent


def _scene_tris(n_spheres=6, seed=0):
    rng = np.random.default_rng(seed)
    parts = [quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0])]
    for i in range(n_spheres):
        c = rng.uniform(-3, 3, 3) * [1, 1, 0] + [0, 0, rng.uniform(0.3, 2.0)]
        if i % 2 == 0:
            parts.append(sphere(c, rng.uniform(0.3, 0.8), n_theta=8, n_phi=12))
        else:
            s = rng.uniform(0.2, 0.6)
            parts.append(box(c - s, c + s))
    return np.concatenate(parts).astype(np.float32)


def _rays(tris, n, seed=1):
    rng = np.random.default_rng(seed)
    lo = tris.reshape(-1, 3).min(0)
    hi = tris.reshape(-1, 3).max(0)
    o = rng.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def scene_bvh():
    tris = _scene_tris()
    return tris, build_bvh(tris)


def _assert_hits_agree(hit, ref, t_tol=1e-4):
    vh, vr = np.asarray(hit.valid), np.asarray(ref.valid)
    assert (vh == vr).all(), f"valid mismatch on {(vh != vr).sum()} rays"
    np.testing.assert_allclose(np.asarray(hit.t)[vh], np.asarray(ref.t)[vh],
                               rtol=t_tol, atol=t_tol)
    # barycentrics at the same prim agree (duplicated padding tris can
    # legitimately differ in prim id at equal t)
    same = vh & (np.asarray(hit.prim) == np.asarray(ref.prim))
    np.testing.assert_allclose(np.asarray(hit.bary)[same],
                               np.asarray(ref.bary)[same], atol=1e-4)


@pytest.mark.parametrize("mode", ["closest", "any_hit", "t_range"])
def test_oracle_matches_brute_force(scene_bvh, mode):
    """The kernel's reference (the XLA oracle) against all-triangles brute
    force on random scenes: closest hit, any hit, finite t range."""
    tris, bvh = scene_bvh
    o, d = _rays(tris, 512, seed={"closest": 1, "any_hit": 3,
                                  "t_range": 5}[mode])
    t_max = 1.5 if mode == "t_range" else jnp.inf
    ref = traversal.intersect_brute_force(bvh, o, d, t_max=t_max)
    hit = traversal.intersect(bvh, o, d, t_max=t_max,
                              any_hit=mode == "any_hit")
    if mode == "any_hit":
        assert (np.asarray(hit.valid) == np.asarray(ref.valid)).all()
        return
    _assert_hits_agree(hit, ref)
    if mode == "t_range":
        assert (np.asarray(hit.t)[np.asarray(hit.valid)] <= 1.5).all()


@pytest.mark.parametrize("platform", ["cpu", "cuda", "rocm"])
def test_backend_decision(scene_bvh, platform):
    """intersect_auto lowers to the XLA oracle for the CPU, to the CUDA FFI
    kernel for a GPU, and fails for any other platform."""
    tris, bvh = scene_bvh
    o, d = _rays(tris, 64)
    traced = jax.jit(lambda o, d: traversal.intersect_auto(bvh, o, d)).trace(
        o, d)
    if platform == "rocm":
        with pytest.raises(Exception, match="platform"):
            traced.lower(lowering_platforms=(platform,))
        return
    text = traced.lower(lowering_platforms=(platform,)).as_text()
    has_kernel = bvh_trace.TARGETS[False] in text
    assert has_kernel == (platform == "cuda")


def test_backend_by_platform_runs_cpu_branch():
    out = backend.by_platform(jnp.float32(2.0), gpu=lambda x: x * 10,
                              cpu=lambda x: x + 1)
    assert float(out) == 3.0


@pytest.mark.parametrize("n_rays", [1, 127, 128, 300])
def test_wrapper_with_oracle_standing_in(scene_bvh, n_rays):
    """Packing, padding to whole blocks, un-padding and Hit decoding give
    exactly the oracle's Hit when the oracle stands in for the kernel."""
    tris, bvh = scene_bvh
    o, d = _rays(tris, n_rays, seed=n_rays)
    t_max = jnp.linspace(0.5, 9.0, n_rays)
    hit = bvh_trace.intersect_kernel(bvh, o, d, 1e-4, t_max,
                                     trace=bvh_trace.oracle_trace)
    ref = traversal.intersect(bvh, o, d, 1e-4, t_max)
    for a, b in zip(hit, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a miss keeps Hit conventions: prim -1 and t = t_max
    miss = ~np.asarray(hit.valid)
    assert (np.asarray(hit.prim)[miss] == -1).all()
    np.testing.assert_array_equal(np.asarray(hit.t)[miss],
                                  np.asarray(t_max)[miss])


def test_pack_rays_layout_and_inert_padding(scene_bvh):
    tris, bvh = scene_bvh
    o = jnp.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    rays = bvh_trace.pack_rays(o, d, 0.5, jnp.asarray([7.0, 8.0]))
    assert rays.shape == (bvh_trace.BLOCK, 8) and rays.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(rays[1]),
                                  [4, 5, 6, 0.5, 0, 1, 0, 8])
    # padding rays have an empty interval: the oracle reports them as misses
    root = jnp.reshape(jnp.asarray(bvh.root_code, jnp.int32), (1,))
    out = bvh_trace.oracle_trace(bvh.nodes, bvh.woop, root, rays, False)
    pad = bvh_trace.unpack_hits(out, rays.shape[0])
    assert not np.asarray(pad.valid)[2:].any()


@pytest.mark.parametrize("shape", [(37, 5), (37, 3, 3)])
def test_gather_rows_matches_take_value_and_grad(shape):
    """The shading gathers that replaced the packed table: per-column takes
    equal a row take, in value and in gradient w.r.t. the table."""
    from cudatracerlib_tpu.scene.scene import gather_rows

    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=shape), jnp.float32)
    idx = jnp.asarray(rng.integers(0, shape[0], 300), jnp.int32)
    w = jnp.asarray(rng.normal(size=(300,) + shape[1:]), jnp.float32)
    np.testing.assert_array_equal(np.asarray(gather_rows(table, idx)),
                                  np.asarray(table[idx]))
    g = jax.grad(lambda t: jnp.sum(gather_rows(t, idx) * w))(table)
    g_ref = jax.grad(lambda t: jnp.sum(t[idx] * w))(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-6,
                               atol=1e-6)


def test_ensure_registered_is_a_noop_without_cuda():
    bvh_trace.ensure_registered()
    assert not bvh_trace._REGISTERED


def test_bvh_depth_fits_the_traversal_stack(scene_bvh):
    tris, bvh = scene_bvh
    depth = tree_depth(np.asarray(bvh.nodes), int(bvh.root_code))
    assert 1 <= depth <= traversal.STACK_DEPTH


def test_check_depth_refuses_a_tree_deeper_than_the_stack():
    # a chain of inner nodes, each with one leaf child and one inner child
    n = traversal.STACK_DEPTH + 1
    nodes = np.zeros((n, 16), np.float32)
    codes = np.stack([np.full(n, -1, np.int32),
                      np.append(np.arange(1, n), -1).astype(np.int32)], 1)
    nodes[:, 12:14] = codes.view(np.float32)
    assert tree_depth(nodes, 0) == n
    with pytest.raises(ValueError, match="exceeds the traversal stack"):
        check_depth(nodes, 0)


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_placement(env_set, tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    got = ct.compilation_cache_dir(env)
    if env_set:
        assert got == str(tmp_path)
    else:
        assert got == os.path.join(str(REPO), ".cache", "xla")
        assert ".cache/" in (REPO / ".gitignore").read_text()


def _sources():
    for p in list(PKG.rglob("*.py")) + list(REPO.glob("*.py")) + list(
            (REPO / "tools").glob("*.py")) + list((REPO / "examples").glob(
                "*.py")):
        yield p, p.read_text()


def test_no_module_imports_pallas():
    pat = re.compile(r"experimental[ .]+(import\s+)?pallas")
    bad = [str(p) for p, text in _sources() if pat.search(text)]
    assert not bad, bad


def test_no_platform_string_tests_or_fault_knobs():
    """One function (backend.by_platform) picks the code path; no module
    compares platform names to choose one, and no fault-bisection
    environment knob is read."""
    bad = []
    for p, text in _sources():
        if re.search(r"platform (not )?in \(\"cpu\",?\)|platform != \"cpu\"",
                     text) or re.search(r"environ\.get\(\"CT_", text):
            bad.append(str(p))
    assert not bad, bad


_CONTRACTIONS = {"einsum", "matmul", "dot", "tensordot", "dot_general",
                 "inner", "vdot", "outer", "batch_matmul"}


def _contraction_calls(tree):
    """Calls jnp./jax.numpy./lax./jax.lax.<contraction>(...) in a module."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _CONTRACTIONS):
            continue
        owner = ast.unparse(node.func.value)
        if owner in ("jnp", "jax.numpy", "lax", "jax.lax"):
            yield node


def test_every_contraction_states_its_precision():
    """A GPU runs an f32 contraction at DEFAULT precision in TF32, so every
    jnp/lax contraction in the package names its precision."""
    bad, seen = [], 0
    for p in PKG.rglob("*.py"):
        for node in _contraction_calls(ast.parse(p.read_text())):
            seen += 1
            if not any(k.arg == "precision" for k in node.keywords):
                bad.append(f"{p.relative_to(REPO)}:{node.lineno}")
    assert seen > 10, seen  # the scan finds the package's contractions
    assert not bad, bad
