"""Host-side acceleration structure: SBVH build, flattening into the
unified (K,16) stream, the content-hashed cache and the native (C++) SBVH
and alias builders.

The port's own copy of the JAX package's `accel` (numpy, plus C++ built
with g++ and loaded through ctypes; no jax). The algorithms,
`CACHE_VERSION` and the cache key are unchanged, so both packages key a
mesh to the same cache file and flatten it to the same stream bit for bit
(`tests/test_torch_accel.py`). The native library builds into this
package's `native/_build/` with `-march=native`, from this package's
sources; when g++ fails the callers use the Python builder (~30 s for the
4.4k-triangle TestObj mesh).
"""
from .bvh import (
    Platform, BuildParams, BVHNode, SBVHBuilder, build_bvh, validate_bvh,
)
from .flatten import FlatBVH, flatten_bvh, flatten_mesh_bvh, woopify
from .cache import load_or_build
