"""Native (C++) BVH builder: bit-identical to the numpy builder."""
import numpy as np
import pytest

from montecarlo_pathtracing_tpu.native import bvh_native
from montecarlo_pathtracing_tpu.scene.bvh_builder import build_bvh


def _boxes(n, seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-50, 50, (n, 3)).astype(np.float32)
    h = rs.uniform(0.1, 3, (n, 3)).astype(np.float32)
    return c, (c - h).astype(np.float32), (c + h).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 9, 64, 100, 1000, 4097])
def test_native_matches_numpy(n):
    c, mn, mx = _boxes(n, n)
    native = bvh_native.build(c, mn, mx)
    if native is None:
        pytest.skip("no C++ toolchain available")
    py = build_bvh(c, mn, mx, use_native=False)
    assert native.depth == py.depth
    np.testing.assert_array_equal(native.leaf, py.leaf)
    np.testing.assert_array_equal(native.bb_min, py.bb_min)
    np.testing.assert_array_equal(native.bb_max, py.bb_max)


def test_default_path_prefers_native():
    c, mn, mx = _boxes(100, 0)
    if bvh_native.build(c, mn, mx) is None:
        pytest.skip("no C++ toolchain available")
    bvh = build_bvh(c, mn, mx)   # use_native=None -> try native
    py = build_bvh(c, mn, mx, use_native=False)
    np.testing.assert_array_equal(bvh.leaf, py.leaf)


def test_library_builds_from_source(tmp_path):
    """The shared library is built from bvh_builder.cpp (none is
    committed) and exports the C ABI the loader binds."""
    import ctypes
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain available")
    path = bvh_native.build_library(str(tmp_path / "libmpt_bvh.so"))
    lib = ctypes.CDLL(path)
    lib.mpt_bvh_depth.restype = ctypes.c_int
    lib.mpt_bvh_depth.argtypes = [ctypes.c_int]
    assert lib.mpt_bvh_depth(100) == bvh_native._load().mpt_bvh_depth(100)
    assert hasattr(lib, "mpt_build_bvh")
