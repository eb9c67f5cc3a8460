"""cudatracerlib_tpu — a differentiable path-tracing framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of CudaTracerLib:
wavefront Monte-Carlo rendering with BVH traversal over SoA ray batches,
Mitsuba-style BSDF/light/sensor/medium models as pure differentiable JAX,
photon mapping/bidirectional integrators over sort-based spatial grids, and
multi-device scaling via jax.sharding — plus end-to-end pixel gradients the
CUDA reference never had. It runs on an NVIDIA GPU, with a CUDA BVH
traversal kernel, and on the CPU through the same entry points.

Layer map (mirrors SURVEY.md §1):
  backend.py — the one GPU/CPU code-path decision
  math/      — vectors, frames, spectrum, warps, MIS, Fresnel, microfacet
  sampling/  — counter-based RNG, sampling records
  scene/     — BSDFs, lights, sensors, textures, media, materials, Scene pytree
  accel/     — BVH build (CPU) + XLA traversal, spatial grids
  ops/       — the CUDA BVH traversal kernel and its JAX wrapper
  render/    — integrators (path tracer, wavefront, BDPT, PPM, ...)
  image/     — film, reconstruction filters, tone mapping, denoise
  io/        — OBJ/PLY loaders, Mitsuba XML scenes, image output
  parallel/  — mesh/sharding helpers, multi-host render/train steps
  utils/     — settings, timing, checkpointing
"""

__version__ = "0.1.0"

import os as _os

# Everything the package caches (compiled programs, built scenes) lives in
# one git-ignored directory of the checkout.
CACHE_ROOT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".cache")


def compilation_cache_dir(environ=_os.environ) -> str:
    """Where JAX keeps compiled programs: JAX_COMPILATION_CACHE_DIR when it
    is set, else a fixed directory of the checkout (a fixed path keeps the
    cache's keys stable from one run to the next)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        CACHE_ROOT, "xla")


def _enable_compilation_cache():
    """Persistent XLA compilation cache: renderer programs are large, and
    caching across processes makes CLI runs, benchmarks and test reruns
    start in seconds. JAX reads JAX_COMPILATION_CACHE_DIR itself; only
    without it is a directory set here."""
    import jax as _jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = compilation_cache_dir()
        _os.makedirs(cache_dir, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()
