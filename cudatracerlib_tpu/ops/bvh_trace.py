"""CUDA BVH traversal through `jax.ffi`: build, registration and wrapper.

The kernel (bvh_trace.cu) walks the fat-node BVH with one thread per ray and
a private stack. This module packs a ray batch into the kernel's (Bp, 8)
layout, pads it to whole thread blocks, calls the kernel and decodes its
(Bp, 4) output back into a `Hit`. Packing, padding and decoding are plain
JAX, so the CPU tests reach them with the XLA oracle standing in for the
kernel (`oracle_trace`).

The shared library is compiled from the tracked source with `nvcc` on first
use into `build/` at the repository root (git-ignored), under a name that
carries a hash of the source, so a stale build is never loaded. Build it
ahead of time with `python -m cudatracerlib_tpu.ops.bvh_trace`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import jax
import jax.numpy as jnp

from ..accel.bvh import BVH
from ..accel.traversal import Hit, intersect

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_trace.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")
BLOCK = 128   # rays per thread block (kBlock in bvh_trace.cu)
TARGETS = {False: "BvhTraceClosest", True: "BvhTraceAny"}  # by any_hit

_LOCK = threading.Lock()
_REGISTERED = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbvh_trace-{digest}.so")


def build_library() -> str:
    """Compile bvh_trace.cu for sm_90a unless this source's build exists."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _cuda_present() -> bool:
    try:
        return bool(jax.devices("cuda"))
    except RuntimeError:
        return False


def ensure_registered() -> None:
    """Build and register the CUDA targets once per process when the process
    has a CUDA backend; elsewhere the kernel branch is traced but never
    lowered (backend.by_platform), so nothing needs building."""
    global _REGISTERED
    with _LOCK:
        if _REGISTERED or not _cuda_present():
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        for name in TARGETS.values():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, name)), platform="CUDA")
        _REGISTERED = True


def pack_rays(o, d, t_min, t_max):
    """(B, 3) origins/directions + (B,) interval -> (Bp, 8) kernel rays,
    Bp a whole number of thread blocks. Padding rays have an empty interval
    (t_min = 1, t_max = 0), so they visit at most the root."""
    B = o.shape[0]
    bp = -(-max(B, 1) // BLOCK) * BLOCK
    f32 = jnp.float32
    t_min = jnp.broadcast_to(jnp.asarray(t_min, f32), (B,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, f32), (B,))
    rays = jnp.concatenate([o.astype(f32), t_min[:, None],
                            d.astype(f32), t_max[:, None]], axis=1)
    pad = jnp.tile(jnp.asarray([[0, 0, 0, 1, 0, 0, 1, 0]], f32), (bp - B, 1))
    return jnp.concatenate([rays, pad], axis=0)


def unpack_hits(out, B: int) -> Hit:
    """(Bp, 4) [t u v prim-bits] -> Hit for the first B rays."""
    out = out[:B]
    prim = jax.lax.bitcast_convert_type(out[:, 3], jnp.int32)
    return Hit(t=out[:, 0], prim=prim, bary=out[:, 1:3], valid=prim >= 0)


def kernel_trace(nodes, woop, root, rays, any_hit: bool):
    """The FFI call: (Bp, 8) rays -> (Bp, 4) hits."""
    ensure_registered()
    call = jax.ffi.ffi_call(
        TARGETS[any_hit],
        jax.ShapeDtypeStruct((rays.shape[0], 4), jnp.float32),
        vmap_method="sequential")
    return call(nodes, woop, root, rays)


def oracle_trace(nodes, woop, root, rays, any_hit: bool):
    """`kernel_trace`'s contract computed by the XLA oracle (CPU tests)."""
    bvh = BVH(nodes=nodes, woop=woop, tri_index=None, root_code=root[0],
              world_min=None, world_max=None)
    h = intersect(bvh, rays[:, 0:3], rays[:, 4:7], rays[:, 3], rays[:, 7],
                  any_hit=any_hit)
    prim_bits = jax.lax.bitcast_convert_type(h.prim, jnp.float32)
    return jnp.concatenate([h.t[:, None], h.bary, prim_bits[:, None]], axis=1)


def intersect_kernel(bvh: BVH, o, d, t_min=1e-4, t_max=jnp.inf,
                     any_hit: bool = False, trace=kernel_trace) -> Hit:
    """Raw (non-differentiable) Hit of a (B,) ray batch from the kernel."""
    B = o.shape[0]
    root = jnp.reshape(jnp.asarray(bvh.root_code, jnp.int32), (1,))
    out = trace(bvh.nodes, bvh.woop, root, pack_rays(o, d, t_min, t_max),
                any_hit)
    return unpack_hits(out, B)


if __name__ == "__main__":
    print(build_library())
