"""Content-hashed BVH disk cache.

Improves on the reference's BVH cache (src/main.cpp:250-346, "<scene>.bvh"
raw dump with no invalidation — stale if the OBJ changes): we key the cache
file by a hash of the mesh contents and build parameters, so edits to the
scene automatically invalidate.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .flatten import FlatBVH, flatten_mesh_bvh

# v4: BFS node-row order (split-table SMEM prefix)
# v5: native builder honors sah_triangle_cost — entries keyed with a
#     non-default cost but built by the old cost-ignoring native builder
#     must invalidate
CACHE_VERSION = 5


def _cache_key(mesh, platform, params):
    import hashlib
    h = hashlib.sha256()
    h.update(b"v%d" % CACHE_VERSION)
    h.update(mesh.content_hash().encode())
    h.update(repr((platform, params)).encode())
    return h.hexdigest()[:20]


def load_or_build(mesh, cache_dir=None, platform=None, params=None,
                  verbose=False) -> FlatBVH:
    if cache_dir is None:
        return flatten_mesh_bvh(mesh, platform, params)
    os.makedirs(cache_dir, exist_ok=True)
    key = _cache_key(mesh, platform, params)
    path = os.path.join(cache_dir, "bvh_%s.npz" % key)
    if os.path.exists(path):
        if verbose:
            print("BVH cache hit: %s" % path)
        z = np.load(path)
        return FlatBVH(
            prims=z["prims"], meta=z["meta"], num_nodes=int(z["num_nodes"]),
            tri_pos=z["tri_pos"], tri_uv=z["tri_uv"], tri_nrm=z["tri_nrm"],
            tri_mat=z["tri_mat"], tri_orig=z["tri_orig"],
            root_lo=z["root_lo"], root_hi=z["root_hi"],
            max_depth=int(z["max_depth"]))
    fb = flatten_mesh_bvh(mesh, platform, params)
    np.savez_compressed(
        path, num_nodes=fb.num_nodes, max_depth=fb.max_depth,
        **{f.name: getattr(fb, f.name) for f in dataclasses.fields(fb)
           if f.name not in ("num_nodes", "max_depth")})
    if verbose:
        print("BVH cache write: %s" % path)
    return fb
