"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding tests follow the standard JAX recipe of
--xla_force_host_platform_device_count (SURVEY.md §4). The platform is
selected through jax.config (jax may already be imported); XLA_FLAGS still
works because backends initialize lazily.

GPU tests (`@pytest.mark.gpu`, tests/test_gpu.py) need a CUDA GPU: their
`cuda_device` fixture skips them elsewhere. Run them on a GPU host with

    python -m pytest tests/ -m gpu --gpu

where `--gpu` leaves JAX on its default platform instead of the CPU.

Subprocess isolation (`@pytest.mark.subproc`): the heaviest grad-of-render
programs (SSS sigma_s FD, spectral cauchy grad) compile cleanly standalone
but abort the XLA:CPU compiler when they follow ~90 other large programs in
one process ("Fatal Python error: Aborted" near the end of the suite, RSS
7.3 GB). Marked tests re-exec their own nodeid in a FRESH interpreter, so
one `python -m pytest tests/` run completes green in a single command.
"""
import os
import subprocess
import sys

import pytest

import jax

_CHILD_ENV = "CUDATRACERLIB_TEST_SUBPROCESS"


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true", default=False,
                     help="run on JAX's default platform (a CUDA GPU) "
                          "instead of the virtual CPU mesh")


@pytest.fixture(scope="session")
def cuda_device():
    """The first CUDA GPU, or a skip where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA GPU (run: python -m pytest tests/ -m gpu "
                    "--gpu)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_xla_caches_between_modules():
    """Reset JAX/XLA compilation caches after every test module.

    The in-suite XLA:CPU compiler state accumulates across the suite's
    ~100 large programs (7+ GB RSS by the end) and eventually SEGFAULTS
    whichever big program compiles late — the round-4 'Fatal Python
    error at 187/188' failure class, which roamed between tests as the
    suite composition changed. Per-module clearing caps the accumulation;
    the persistent compilation cache keeps recompiles cheap."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "subproc: run this test in a fresh interpreter (XLA:CPU compiler "
        "state isolation; see conftest docstring)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips elsewhere (see conftest)")
    if not config.getoption("--gpu"):
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if (item.get_closest_marker("subproc")
            and os.environ.get(_CHILD_ENV) != "1"):
        env = dict(os.environ, **{_CHILD_ENV: "1"})
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-x", "-q", "--no-header",
             "-p", "no:cacheprovider", item.nodeid],
            cwd=str(item.config.rootpath), env=env,
            capture_output=True, text=True, timeout=1200,
        )
        if r.returncode != 0:
            raise AssertionError(
                f"subprocess-isolated test failed (rc={r.returncode}):\n"
                f"{r.stdout[-4000:]}\n{r.stderr[-2000:]}")
        # the child already ran the body; skip the in-process call
        item.obj = lambda *a, **k: None
    res = yield
    return res
