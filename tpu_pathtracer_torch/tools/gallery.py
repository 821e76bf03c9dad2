"""The material gallery (port of tools/gallery.py): one image per material
family on the standard test composition, after the reference's
renderingResult grid, and with --ladder its BSSRDF convergence row
(50, 200 and 800 spp).

    python -m tpu_pathtracer_torch.tools.gallery [--size 256] [--spp 64] \\
        [--only mirror,medium_jade] [--ladder] [--ext png]

Images go to --out-dir as <variant>.<ext>: .ppm is written with numpy
alone, any other extension through PIL (imported only then). The device
is --device (default cuda).
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def variants():
    """{name: materials} of the gallery, the JAX tool's sixteen."""
    from ..scene.config import (
        MatDesc, MAT_DIFF, MAT_REFL, MAT_DIFF_REFL, MAT_FRESNEL, MAT_GLASS,
        MAT_EMIT, MAT_NULL, MAT_SUBSURFACE, F0_PRESETS,
    )

    def mats(center):
        return [MatDesc(refltype=MAT_DIFF, useTexture=True), center,
                MatDesc(refltype=MAT_GLASS),
                MatDesc(refltype=MAT_REFL)]

    return {
        "diffuse": mats(MatDesc(refltype=MAT_DIFF, objcol=(0.85, 0.4, 0.3))),
        "mirror": mats(MatDesc(refltype=MAT_REFL, alphax=0.0)),
        "ggx_gold": mats(MatDesc(refltype=MAT_REFL, alphax=0.15, alphay=0.15,
                                 F0=F0_PRESETS["gold"])),
        "ggx_aniso": mats(MatDesc(refltype=MAT_REFL, alphax=0.4, alphay=0.05,
                                  F0=F0_PRESETS["silver"],
                                  tangent=(0.0, 1.0, -1.0))),
        # the reference's second anisotropic configuration: the roughness
        # axes swapped
        "ggx_aniso2": mats(MatDesc(refltype=MAT_REFL, alphax=0.05,
                                   alphay=0.4, F0=F0_PRESETS["silver"],
                                   tangent=(0.0, 1.0, -1.0))),
        "diff_refl": mats(MatDesc(refltype=MAT_DIFF_REFL, alphax=0.2,
                                  alphay=0.2, kd=1.0, ks=1.0,
                                  objcol=(0.4, 0.5, 0.8))),
        "fresnel_blend": mats(MatDesc(refltype=MAT_FRESNEL, alphax=0.1,
                                      alphay=0.1, kd=5.0, ks=1.0)),
        "smooth_glass": mats(MatDesc(refltype=MAT_GLASS, etaT=1.5)),
        "rough_glass": mats(MatDesc(refltype=MAT_GLASS, etaT=1.5,
                                    alphax=0.2)),
        "emissive": mats(MatDesc(refltype=MAT_EMIT, emit=(3.0, 2.0, 1.2))),
        "null": mats(MatDesc(refltype=MAT_NULL)),
        "medium_tea": mats(MatDesc(refltype=MAT_GLASS, medium="tea")),
        "medium_jade": mats(MatDesc(refltype=MAT_GLASS, medium="jade")),
        "medium_milk": mats(MatDesc(refltype=MAT_GLASS, medium="milk")),
        # the reference's smoke image: the "cloud" preset
        "medium_cloud": mats(MatDesc(refltype=MAT_GLASS, medium="cloud")),
        "bssrdf_soe": mats(MatDesc(refltype=MAT_SUBSURFACE,
                                   objcol=(0.83, 0.79, 0.75), alphax=0.3,
                                   etaT=1.4, mfp=(0.35, 0.3, 0.25), ks=0.2)),
    }


def variant_settings(name):
    """The RenderSettings of a variant, or None for the Renderer's
    default: dense media need a deep scatter budget to cross the sphere."""
    if not name.startswith("medium"):
        return None
    from ..tracer.wavefront import RenderSettings
    return RenderSettings(bounce_min=2, bounce_max=64, use_envmap=True,
                          use_texture=True, has_media=True)


def scene_parts(cache_dir):
    """(flat_bvh, envmap, texture) of the gallery's composition."""
    from ..scene import procedural
    from ..accel import load_or_build
    fb = load_or_build(procedural.make_test_scene(), cache_dir=cache_dir)
    return fb, procedural.make_sky_envmap(), procedural.make_checker_texture()


def render_variant(name, mats, size, spp, parts, device):
    """(renderer, accumulation) of spp frames of one variant."""
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer
    fb, envmap, texture = parts
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=size,
                 height=size, settings=variant_settings(name), device=device)
    rc = default_camera(size, size).build_render_camera()
    return r, r.render_frames(r.zeros_accum(), rc, 1, spp)


def ladder(size, parts, out_dir, ext, device, spps=(50, 200, 800)):
    """The BSSRDF convergence row: one accumulation, written at each of
    spps. Returns [(spp, seconds, path)]."""
    from ..scene.config import (MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL,
                                MAT_SUBSURFACE)
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer
    from .render import _save_image
    fb, envmap, texture = parts
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.83, 0.79, 0.75),
                    alphax=0.3, etaT=1.4, mfp=(0.35, 0.3, 0.25), ks=0.2),
            MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=size,
                 height=size, device=device)
    rc = default_camera(size, size).build_render_camera()
    accum, done, out = r.zeros_accum(), 0, []
    for spp in spps:
        t0 = time.time()
        accum = r.render_frames(accum, rc, done + 1, spp - done)
        done = spp
        path = os.path.join(out_dir, "bssrdf_%dspp.%s" % (spp, ext))
        _save_image(path, r, accum, done)
        out.append((spp, time.time() - t0, path))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.gallery",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="renders")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--cache-dir", default=".bvh_cache_torch")
    ap.add_argument("--ladder", action="store_true",
                    help="render the BSSRDF convergence ladder "
                         "(bssrdf_{50,200,800}spp)")
    ap.add_argument("--ext", default="png",
                    help="image format: ppm (numpy) or a PIL format")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gallery: no CUDA device (pass --device cpu)")
    from .render import _save_image
    os.makedirs(args.out_dir, exist_ok=True)
    parts = scene_parts(args.cache_dir)
    if args.ladder:
        for spp, s, path in ladder(args.size, parts, args.out_dir, args.ext,
                                   device):
            print("bssrdf %3d spp %5.1fs -> %s" % (spp, s, path))
        return 0
    table = variants()
    sel = args.only.split(",") if args.only else list(table)
    for name in sel:
        if name not in table:
            raise SystemExit("unknown variant %r" % name)
        t0 = time.time()
        r, accum = render_variant(name, table[name], args.size, args.spp,
                                  parts, device)
        path = os.path.join(args.out_dir, "%s.%s" % (name, args.ext))
        _save_image(path, r, accum, args.spp)
        print("%-14s %5.1fs -> %s" % (name, time.time() - t0, path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
