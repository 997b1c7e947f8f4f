"""ctypes loader for the native BVH builder (bvh_builder.cpp).

Compiles the shared library from bvh_builder.cpp on first use with g++
(plain C ABI + ctypes) and caches it next to the source; the library is
never committed (.gitignore lists it). Falls back silently if no compiler
is available; scene/bvh_builder.py then uses the numpy path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_LIB = os.path.join(_HERE, "libmpt_bvh.so")
_lock = threading.Lock()
_lib = None


def build_library(path: str = _LIB) -> str:
    """Compile bvh_builder.cpp into the shared library at `path`."""
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", path, _SRC],
                   check=True, capture_output=True)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            build_library()
        lib = ctypes.CDLL(_LIB)
        lib.mpt_bvh_depth.restype = ctypes.c_int
        lib.mpt_bvh_depth.argtypes = [ctypes.c_int]
        lib.mpt_build_bvh.restype = None
        lib.mpt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def build(centers, bbmin, bbmax):
    """Returns a scene.bvh_builder.BVH or None on any failure."""
    from ..scene.bvh_builder import BVH

    try:
        lib = _load()
    except Exception:
        return None
    n = int(centers.shape[0])
    if n == 0:
        return None
    centers = np.ascontiguousarray(centers, np.float32)
    bbmin = np.ascontiguousarray(bbmin, np.float32)
    bbmax = np.ascontiguousarray(bbmax, np.float32)
    depth = lib.mpt_bvh_depth(n)
    sz_leaf = 1 << depth
    sz = 2 * sz_leaf - 1
    out_min = np.empty((sz, 3), np.float32)
    out_max = np.empty((sz, 3), np.float32)
    leaf = np.empty(sz_leaf, np.int32)

    def p(a, t=ctypes.c_float):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.mpt_build_bvh(p(centers), p(bbmin), p(bbmax), n,
                      p(out_min), p(out_max), p(leaf, ctypes.c_int32))
    return BVH(out_min, out_max, leaf, depth)
