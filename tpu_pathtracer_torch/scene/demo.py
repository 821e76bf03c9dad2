"""The demo scenes and their camera (port of scene/demo.py): TestObj and
its variants, the head scene, the ~105k-triangle organic blob (subsurface
or jade medium) and the ~135k-triangle large TestObj composition. Each
returns (flat_bvh, materials, envmap, texture).

The BVH comes from the port's `accel` (numpy + C++), a copy of the JAX
package's builder and content-hashed cache with the same cache key, so
both packages trace the same flattened stream bit for bit.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from ..accel.cache import load_or_build

from .config import (
    MatDesc, MAT_DIFF, MAT_REFL, MAT_GLASS, MAT_FRESNEL, MAT_SUBSURFACE,
    F0_PRESETS,
)
from .camera import InteractiveCamera
from . import procedural
from .mesh import TriangleMesh, compute_face_normals
from .plyloader import write_ply_binary, load_ply


def default_camera(width, height, pitch=0.25, radius=4.0,
                   center=(0.0, 0.8, 0.0), fovx=60.0):
    cam = InteractiveCamera()
    cam.center_position = center
    cam.radius = radius
    cam.pitch = pitch
    cam.set_resolution(width, height)
    cam.set_fovx(fovx)
    return cam


def testobj_scene(cache_dir=None, variant="default"):
    """The TestObj composition: textured diffuse ground, MAT_FRESNEL inner
    sphere, MAT_GLASS outer shell, MAT_REFL plate. Returns
    (flat_bvh, materials, envmap, texture).

    variants: default, lambertian, gold, subsurface (BSSRDF inner sphere),
    media (jade medium inside the glass shell)."""
    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=cache_dir)
    if variant == "lambertian":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_DIFF, objcol=(0.9, 0.3, 0.25)),
                MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.9, 0.35)),
                MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.35, 0.9))]
    elif variant == "gold":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_REFL, alphax=0.15, alphay=0.15,
                        F0=F0_PRESETS["gold"]),
                MatDesc(refltype=MAT_GLASS),
                MatDesc(refltype=MAT_REFL)]
    elif variant == "subsurface":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.83, 0.79, 0.75),
                        alphax=0.3, etaT=1.4, mfp=(0.35, 0.3, 0.25), ks=0.2),
                MatDesc(refltype=MAT_GLASS),
                MatDesc(refltype=MAT_REFL)]
    elif variant == "media":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_DIFF, objcol=(0.8, 0.8, 0.8)),
                MatDesc(refltype=MAT_GLASS, medium="jade"),
                MatDesc(refltype=MAT_REFL)]
    elif variant == "default":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                        kd=5.0, ks=1.0),
                MatDesc(refltype=MAT_GLASS),
                MatDesc(refltype=MAT_REFL)]
    else:
        raise ValueError("unknown testobj_scene variant %r" % (variant,))
    envmap = procedural.make_sky_envmap()
    texture = procedural.make_checker_texture()
    return fb, mats, envmap, texture


def head_scene(cache_dir=None):
    """The 'head scene' analog (reference src/scenes.txt:8-11: head.ply +
    albedo map + MAT_SKIN/BSSRDF): a displaced-blob mesh round-tripped
    through the binary PLY loader, subsurface skin material, on a diffuse
    ground."""
    blob = procedural.make_uv_sphere((0.0, 1.0, 0.0), 0.9, 0,
                                     n_lat=28, n_lon=56)
    # smooth displacement for a head-ish organic silhouette
    v = blob.vertices.copy()
    c = np.array([0.0, 1.0, 0.0], np.float32)
    r = v - c
    disp = (0.10 * np.sin(3.0 * v[:, 0] * 2.1)
            * np.cos(2.0 * v[:, 1]) * np.sin(1.7 * v[:, 2] + 0.5)
            + 0.06 * np.sin(5.0 * v[:, 1] + 1.3))
    ln = np.linalg.norm(r, axis=-1, keepdims=True)
    v = c + r * (1.0 + disp[:, None] / np.maximum(ln, 1e-6))
    blob = TriangleMesh(v.astype(np.float32), blob.indices, blob.uv,
                        blob.normals, blob.material_ids)
    fn = compute_face_normals(blob)
    blob.normals[:] = fn[:, None, :]

    # round-trip through the PLY format (exercises the loader end to end)
    ply_dir = cache_dir or tempfile.gettempdir()
    os.makedirs(ply_dir, exist_ok=True)
    ply_path = os.path.join(ply_dir, "head_demo.ply")
    write_ply_binary(ply_path, blob)
    head = load_ply(ply_path)
    head.material_ids[:] = 1

    ground = procedural.make_plane((0, 0, 0), 20.0, 20.0, 0, uv_scale=8.0)
    mesh = TriangleMesh.concatenate([ground, head])
    fb = load_or_build(mesh, cache_dir=cache_dir)
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            # skin-ish subsurface (scenes.txt bssrdf face recipe: alphax 0.5,
            # F0 0.04, etaT 1.4)
            MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.85, 0.67, 0.55),
                    alphax=0.5, etaT=1.4, mfp=(0.25, 0.14, 0.10), ks=0.2,
                    F0=(0.04, 0.04, 0.04))]
    envmap = procedural.make_sky_envmap()
    texture = procedural.make_checker_texture()
    return fb, mats, envmap, texture


def large_organic_scene(cache_dir=None, variant="sss", n_lat=160,
                        n_lon=320):
    """Reference-scale heavy-transport showcase: a ~105k-tri
    IRREGULAR organic blob (procedural.make_organic_blob — the head.ply
    stand-in; reference src/scenes.txt:8-11 + src/renderkernel.cu:698-844
    run subsurface probe re-traversals on a scanned mesh of this class)
    round-tripped through the binary PLY loader at full scale, over a
    textured ground.

    variant="sss": skin-ish BSSRDF blob (3-probe reservoir re-traversals).
    variant="media": glass blob with a jade interior (volumetric distance
    sampling + scattered interior rays)."""
    blob = procedural.make_organic_blob(n_lat=n_lat, n_lon=n_lon, mat_id=1)
    ply_dir = cache_dir or tempfile.gettempdir()
    os.makedirs(ply_dir, exist_ok=True)
    ply_path = os.path.join(ply_dir, "organic_%dx%d.ply" % (n_lat, n_lon))
    write_ply_binary(ply_path, blob)
    blob = load_ply(ply_path)
    blob.material_ids[:] = 1

    ground = procedural.make_plane_grid((0, 0, 0), 20.0, 20.0, 0,
                                        nx=32, nz=32, uv_scale=8.0)
    mesh = TriangleMesh.concatenate([ground, blob])
    fb = load_or_build(mesh, cache_dir=cache_dir)
    if variant == "media":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_GLASS, medium="jade")]
    elif variant == "sss":
        mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
                MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.85, 0.67, 0.55),
                        alphax=0.5, etaT=1.4, mfp=(0.25, 0.14, 0.10),
                        ks=0.2, F0=(0.04, 0.04, 0.04))]
    else:
        # a typo must not silently render the sss composition
        raise ValueError("unknown large_organic_scene variant %r"
                         % (variant,))
    envmap = procedural.make_sky_envmap()
    texture = procedural.make_checker_texture()
    return fb, mats, envmap, texture


def large_scene(cache_dir=None, n_lat=128, n_lon=256, ground_div=48):
    """Reference-asset-scale TestObj composition (~135k triangles at the
    defaults — the reference's actual workload class: TestObj.obj is a
    user-supplied 10^5-triangle OBJ loaded per-face at the reference's
    src/main.cpp:482-587, and the SBVH constants are sized for meshes that
    big, src/SplitBVHBuilder.h:34-39). The packed stream (~177k rows of
    64 bytes on the card, ~11 MB) sits in L2 and far outgrows an SM's L1,
    so this scene is where the traversal table's residency can matter."""
    mesh = procedural.make_large_scene(n_lat=n_lat, n_lon=n_lon,
                                       ground_div=ground_div)
    fb = load_or_build(mesh, cache_dir=cache_dir)
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                    kd=5.0, ks=1.0),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    envmap = procedural.make_sky_envmap()
    texture = procedural.make_checker_texture()
    return fb, mats, envmap, texture
