"""The CUDA traversal kernel against the XLA oracle, on a GPU.

Skipped where JAX has no CUDA GPU. On a GPU host:

    python -m pytest tests/ -m gpu --gpu
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudatracerlib_tpu.accel import traversal
from cudatracerlib_tpu.accel.bvh import build_bvh
from cudatracerlib_tpu.ops import bvh_trace

from test_kernel_path import _rays, _scene_tris

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene(cuda_device):
    tris = _scene_tris(n_spheres=12, seed=4)
    return tris, build_bvh(tris)


@pytest.mark.parametrize("mode", ["closest", "any_hit", "t_range"])
def test_kernel_matches_oracle(scene, mode):
    tris, bvh = scene
    o, d = _rays(tris, 4096, seed=7)
    t_max = jnp.full((4096,), 1.5) if mode == "t_range" else jnp.inf
    any_hit = mode == "any_hit"
    hit = jax.jit(bvh_trace.intersect_kernel, static_argnames="any_hit")(
        bvh, o, d, 1e-4, t_max, any_hit=any_hit)
    ref = traversal.intersect(bvh, o, d, 1e-4, t_max, any_hit=any_hit)
    vh, vr = np.asarray(hit.valid), np.asarray(ref.valid)
    assert np.mean(vh != vr) <= 1e-3
    if not any_hit:
        both = vh & vr
        np.testing.assert_allclose(np.asarray(hit.t)[both],
                                   np.asarray(ref.t)[both], rtol=1e-4,
                                   atol=1e-4)


def test_intersect_auto_takes_the_kernel_and_keeps_gradients(scene):
    tris, bvh = scene
    o, d = _rays(tris, 1024, seed=9)

    def loss(o):
        return jnp.sum(jnp.where(traversal.intersect_auto(bvh, o, d).valid,
                                 traversal.intersect_auto(bvh, o, d).t, 0.0))

    g = jax.jit(jax.grad(loss))(o)
    assert np.isfinite(np.asarray(g)).all()
    text = jax.jit(lambda o: traversal.intersect_auto(bvh, o, d)).lower(
        o).as_text()
    assert bvh_trace.TARGETS[False] in text
