"""The TestObj demo scene and its camera (port of scene/demo.py).

The BVH comes from the port's `accel` (numpy + C++), a copy of the JAX
package's builder and content-hashed cache, so both packages trace the
same flattened stream. The head and large/organic demo scenes are not
ported yet (ROADMAP queue A).
"""
from __future__ import annotations

from ..accel.cache import load_or_build

from .config import (
    MatDesc, MAT_DIFF, MAT_REFL, MAT_GLASS, MAT_FRESNEL, MAT_SUBSURFACE,
    F0_PRESETS,
)
from .camera import InteractiveCamera
from . import procedural


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

    variants: default, lambertian, gold, subsurface, media (the last two
    build here but the port's Renderer does not render them yet)."""
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
