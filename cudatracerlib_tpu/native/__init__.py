"""Native (C++) components, built on demand with g++ and loaded via ctypes.

The repo rule (SURVEY.md §7): components that are native in the reference stay
native here — the SBVH builder is CPU C++ in CudaTracerLib
(Engine/SpatialStructures/BVH/SplitBVHBuilder.cpp), so this builder is C++
too; JAX consumes the flat arrays it emits.

The library is compiled from the tracked source into `build/` at the
repository root (git-ignored), under a name that carries a hash of the
source, with portable flags: a build is never taken from another host or an
older source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
_LOCK = threading.Lock()
_LIB = None


def _build_lib() -> str:
    src = os.path.join(_DIR, "bvh_builder.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libbvh_builder-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def get_lib():
    """Compile-on-first-use native library; None if no toolchain."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            so = _build_lib()
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
        lib = ctypes.CDLL(so)
        lib.bvh_build.restype = ctypes.c_int
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.bvh_build_ex.restype = ctypes.c_int
        lib.bvh_build_ex.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.bvh_n_nodes.restype = ctypes.c_int
        lib.bvh_n_order.restype = ctypes.c_int
        lib.bvh_copy.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        ]
        _LIB = lib
        return _LIB


def build_bvh_native(tris: np.ndarray, leaf_size: int, n_bins: int,
                     max_depth: int, spatial: bool = True,
                     alpha: float = 1e-5):
    """Returns (nodes (M,16) f32, order (P,) i32, root) or None if unavailable.

    `spatial`: enable SBVH spatial splits (reference SplitBVHBuilder's
    default path); `alpha`: overlap gate as a fraction of root surface area."""
    lib = get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris.reshape(-1, 9), np.float32)
    with _LOCK:
        root = lib.bvh_build_ex(
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.shape[0], leaf_size, n_bins, max_depth,
            1 if spatial else 0, alpha,
        )
        n_nodes = lib.bvh_n_nodes()
        n_order = lib.bvh_n_order()
        nodes = np.empty((n_nodes, 16), np.float32)
        order = np.empty((n_order,), np.int32)
        lib.bvh_copy(
            nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        lib.bvh_release()
    return nodes, order, int(root)
