"""The default scene at 1920x1080 through the whole asset pipeline at asset
scale (port of tools/showcase_1080p.py): a 2048x1024 procedural HDR sky
written and read back through scene/hdr.py's RGBE codec, its alias table
built natively, then a progressive render.

    python -m tpu_pathtracer_torch.tools.showcase_1080p [--spp 256] \\
        [--out renders/showcase_1080p.png] [--env-size 2048]

It prints the seconds of the env I/O, the renderer build (the alias build
included), the first frame and the remaining frames. An output ending in
.ppm is written with numpy alone, any other extension through PIL
(imported only then). The device is --device (default cuda).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..utils.timing import synchronize


def render_showcase(W, H, env_size, spp, out, cache_dir, device):
    """Render the showcase at W x H with an env_size x env_size/2 sky and
    write it to out. Returns {env_io_s, build_s, first_frame_s, rest_s,
    rest_ms_per_frame, spp, out, mean}."""
    from ..scene import procedural
    from ..scene.demo import testobj_scene, default_camera
    from ..scene.hdr import write_hdr, read_hdr
    from ..tracer.renderer import Renderer
    from .render import _save_image
    fb, mats, _, texture = testobj_scene(cache_dir=cache_dir)

    t0 = time.perf_counter()
    env = procedural.make_sky_envmap(env_size, env_size // 2)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = os.path.join(cache_dir, "showcase_sky.hdr")
    write_hdr(tmp, env)
    env = read_hdr(tmp)
    t_io = time.perf_counter() - t0

    t0 = time.perf_counter()
    r = Renderer(fb, mats, envmap=env, texture=texture, width=W, height=H,
                 device=device)
    synchronize(device)
    t_build = time.perf_counter() - t0

    rc = default_camera(W, H).build_render_camera()
    t0 = time.perf_counter()
    accum = r.render_frames(r.zeros_accum(), rc, 1, 1)
    synchronize(device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = 1
    while done < spp:
        step = min(32, spp - done)
        accum = r.render_frames(accum, rc, done + 1, step)
        done += step
    synchronize(device)
    t_rest = time.perf_counter() - t0
    _save_image(out, r, accum, done)
    return {"env_io_s": t_io, "build_s": t_build, "first_frame_s": t_first,
            "rest_s": t_rest,
            "rest_ms_per_frame": t_rest * 1e3 / max(done - 1, 1),
            "spp": done, "out": out,
            "mean": float(accum.mean()) / done}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.showcase_1080p",
        description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--out", default="renders/showcase_1080p.png")
    ap.add_argument("--env-size", type=int, default=2048)
    ap.add_argument("--cache-dir", default=".bvh_cache_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("showcase_1080p: no CUDA device (pass --device "
                         "cpu)")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    t = render_showcase(1920, 1080, args.env_size, args.spp, args.out,
                        args.cache_dir, device)
    print("env io %.2fs | renderer build (incl. the alias build) %.2fs | "
          "first frame %.2fs | %d more spp %.1fs (%.1f ms/frame)"
          % (t["env_io_s"], t["build_s"], t["first_frame_s"], t["spp"] - 1,
             t["rest_s"], t["rest_ms_per_frame"]))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
