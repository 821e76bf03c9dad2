"""ctypes loader + compile-on-demand for the native SBVH builder.

The Python SBVH builder (accel/bvh.py) is the correctness reference; this
C++ builder is the production path for real mesh sizes (~100x faster;
the Python builder needs ~30 s for a 4.4k-triangle mesh). The role matches
the reference's C++ CPU builder (src/SplitBVHBuilder.cpp). pybind11 is not
available in this image, so the binding is a plain C ABI + ctypes.
"""
from __future__ import annotations

import ctypes
import contextlib
import fcntl
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "native", "sbvh.cpp"),
         os.path.join(_HERE, "native", "alias.cpp")]
_LIB_DIR = os.path.join(_HERE, "native", "_build")
_LIB = os.path.join(_LIB_DIR, "libsbvh.so")
_LOCK = os.path.join(_LIB_DIR, "libsbvh.lock")

_lock = threading.Lock()
_lib = None
# a build or load that failed under the file lock: no retry would mend it
_error = None


def _compile():
    """Compile into a file of this process's own and rename it onto _LIB:
    a process never sees a half-written library."""
    tmp = "%s.%d.tmp" % (_LIB, os.getpid())
    cmd = ["g++", "-O2", "-march=native", "-std=c++17", "-shared", "-fPIC",
           *_SRCS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale():
    return (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < max(os.path.getmtime(s)
                                            for s in _SRCS))


@contextlib.contextmanager
def _file_lock():
    """Held across processes around the compile and the load, so that no
    process loads a library another one is still building."""
    os.makedirs(_LIB_DIR, exist_ok=True)
    with open(_LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _load():
    lib = ctypes.CDLL(_LIB)
    lib.sbvh_build.restype = ctypes.c_int
    lib.sbvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sbvh_free.argtypes = [ctypes.c_void_p]
    lib.alias_build.restype = ctypes.c_int
    lib.alias_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def get_lib():
    """Returns the loaded ctypes lib or None when unavailable (g++ missing
    or failing; `last_error()` says why). Compiles it first when it is
    missing or older than its sources; safe when several processes start
    at once on one checkout."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            return None
        try:
            with _file_lock():
                if _stale():
                    _compile()
                try:
                    _lib = _load()
                except OSError:
                    # a library left by an older writer: build it anew
                    _compile()
                    _lib = _load()
            return _lib
        except Exception as e:
            _error = e
            return None


def last_error():
    """The exception that made get_lib() return None, or None."""
    return _error


def alias_build_native(p):
    """Exact Vose alias construction via the native lib (native/alias.cpp).

    p: [n] float64 weights scaled to mean 1. Returns (prob f32 [n],
    alias i32 [n]) — bit-identical to the Python reference loop in
    tracer/envsample.py — or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(np.asarray(p, np.float64))
    n = int(p.shape[0])
    prob = np.empty(n, np.float32)
    alias = np.empty(n, np.int32)
    rc = lib.alias_build(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return prob, alias


def build_bvh_native(tri_verts, platform=None, params=None):
    """Build an SBVH with the native builder.

    tri_verts: [T,3,3]. Returns (root BVHNode, tri_index_array) compatible
    with accel.flatten.flatten_bvh, or None if the native lib is missing.
    """
    from .bvh import Platform, BuildParams, BVHNode

    lib = get_lib()
    if lib is None:
        return None
    platform = platform or Platform()
    params = params or BuildParams()

    tv = np.ascontiguousarray(np.asarray(tri_verts, np.float32).reshape(-1, 9))
    T = tv.shape[0]
    out_bounds = ctypes.POINTER(ctypes.c_float)()
    out_meta = ctypes.POINTER(ctypes.c_int)()
    out_tidx = ctypes.POINTER(ctypes.c_int)()
    nn = ctypes.c_int()
    ni = ctypes.c_int()
    root_id = ctypes.c_int()
    rc = lib.sbvh_build(
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T,
        ctypes.c_float(params.split_alpha),
        int(platform.min_leaf_size),
        int(min(platform.max_leaf_size, 0x7FFFFFF)),
        1 if params.enable_spatial_splits else 0,
        ctypes.c_float(platform.sah_triangle_cost / platform.sah_node_cost),
        ctypes.byref(out_bounds), ctypes.byref(out_meta),
        ctypes.byref(out_tidx), ctypes.byref(nn), ctypes.byref(ni),
        ctypes.byref(root_id))
    if rc != 0:
        return None

    n = nn.value
    bounds = np.ctypeslib.as_array(out_bounds, shape=(n, 6)).copy()
    meta = np.ctypeslib.as_array(out_meta, shape=(n, 4)).copy()
    tri_idx = np.ctypeslib.as_array(out_tidx, shape=(ni.value,)).copy()
    lib.sbvh_free(out_bounds)
    lib.sbvh_free(out_meta)
    lib.sbvh_free(out_tidx)

    # rebuild the BVHNode tree for the shared flattener
    node_objs = [None] * n

    def mk(i):
        lo = bounds[i, :3].astype(np.float64)
        hi = bounds[i, 3:].astype(np.float64)
        l, r, s, c = meta[i]
        if l < 0:
            return BVHNode(lo, hi, tri_start=int(s), tri_end=int(s + c))
        return BVHNode(lo, hi, left=node_objs[l], right=node_objs[r])

    # children are emitted before parents (post-order), so a forward pass works
    for i in range(n):
        node_objs[i] = mk(i)
    return node_objs[root_id.value], tri_idx.astype(np.int64)
