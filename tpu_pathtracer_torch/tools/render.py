"""Headless progressive renderer CLI (port of tools/render.py).

Loads a scene (a scene description JSON or a built-in demo), renders it
progressively on one device (or sharded over several with --multichip),
prints a stats line about once a second, writes snapshots, and
checkpoints the accumulation buffer so that a render resumes across
processes. The checkpoint npz has the JAX tool's keys (accum, frame,
width, height), so a checkpoint written by either tool resumes in the
other.

    python -m tpu_pathtracer_torch.tools.render --demo default --spp 64 \\
        --size 512 --out out.ppm
    python -m tpu_pathtracer_torch.tools.render --scene desc.json --spp 256 \\
        --out img.png --checkpoint ckpt.npz
    python -m tpu_pathtracer_torch.tools.render --demo media --resume \\
        ckpt.npz --spp 1024 --out img.ppm

An output ending in .ppm is written with numpy alone; any other extension
is written as PNG through PIL, which is imported only then. The device is
--device (default cuda); --device cpu renders on the plain versions of the
kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.image import write_ppm
from ..utils.timing import RateMeter

DEMOS = ("default", "large", "lambertian", "gold", "subsurface", "media",
         "head", "organic_sss", "organic_media")


def save_checkpoint(path, accum, frame, meta):
    if isinstance(accum, torch.Tensor):
        accum = accum.detach().cpu().numpy()
    np.savez_compressed(path, accum=np.asarray(accum), frame=frame, **meta)


def load_checkpoint(path):
    z = np.load(path)
    meta = {k: int(z[k]) for k in ("width", "height") if k in z.files}
    return z["accum"], int(z["frame"]), meta


def _save_image(path, renderer, accum, frames):
    if path.endswith(".ppm"):
        write_ppm(path, renderer.accum_to_buffer(accum), frames)
    else:
        from PIL import Image   # PNG output needs PIL
        Image.fromarray(renderer.accum_to_image(accum, frames),
                        "RGB").save(path)


def _demo_parts(name, cache_dir):
    from ..scene import demo
    if name == "head":
        return demo.head_scene(cache_dir=cache_dir)
    if name == "large":
        return demo.large_scene(cache_dir=cache_dir)
    if name in ("organic_sss", "organic_media"):
        return demo.large_organic_scene(cache_dir=cache_dir,
                                        variant=name.split("_")[1])
    return demo.testobj_scene(cache_dir=cache_dir, variant=name)


def _device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.render",
        description=__doc__.splitlines()[0])
    ap.add_argument("--scene", help="scene description (JSON) path")
    ap.add_argument("--demo", help="built-in demo: " + ", ".join(DEMOS))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="render.png",
                    help=".ppm (numpy) or any PIL format (.png, ...)")
    ap.add_argument("--snapshot-every", type=float, default=0.0,
                    help="write <out>.snap.<ext> every N seconds")
    ap.add_argument("--checkpoint", help="checkpoint file (npz)")
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    help="checkpoint every N frames")
    ap.add_argument("--resume", help="resume from checkpoint file")
    ap.add_argument("--cache-dir", default=".bvh_cache_torch")
    ap.add_argument("--multichip", action="store_true",
                    help="shard lanes over every CUDA device")
    ap.add_argument("--camera", help=".cam binary file to load")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("render: no CUDA device (pass --device cpu to "
                         "render on the CPU)")
    W = args.width or args.size
    H = args.height or args.size

    if args.scene:
        from ..scene.config import load_scene_desc
        from ..tracer.renderer import renderer_from_scene_desc
        desc = load_scene_desc(args.scene)
        desc.width, desc.height = W, H
        renderer = renderer_from_scene_desc(
            desc, base_dir=os.path.dirname(args.scene),
            cache_dir=args.cache_dir, device=device)
        cam_file = desc.camFile
    else:
        from ..tracer.renderer import Renderer
        name = args.demo or "default"
        if name not in DEMOS:
            raise SystemExit("render: unknown demo %r (want one of %s)"
                             % (name, ", ".join(DEMOS)))
        fb, mats, envmap, texture = _demo_parts(name, args.cache_dir)
        renderer = Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=W, height=H, device=device)
        cam_file = None

    from ..scene.demo import default_camera
    from ..scene.camera import InteractiveCamera
    if args.camera or cam_file:
        icam = InteractiveCamera.load_cam(args.camera or cam_file)
        icam.set_resolution(W, H)
    else:
        icam = default_camera(W, H)
    rc = icam.build_render_camera()

    if args.multichip:
        from ..parallel.sharding import ShardedRenderer
        renderer = ShardedRenderer(renderer)

    accum = renderer.zeros_accum()
    start_frame = 0
    if args.resume and os.path.exists(args.resume):
        a, start_frame, meta = load_checkpoint(args.resume)
        if meta and (meta.get("width"), meta.get("height")) != (W, H):
            raise SystemExit("render: %s holds a %dx%d render, not %dx%d"
                             % (args.resume, meta["width"], meta["height"],
                                W, H))
        # a sharded run's buffer carries padding rows past width*height
        n = min(a.shape[0], accum.shape[0])
        accum[:n] = torch.from_numpy(np.ascontiguousarray(
            a[:n], np.float32)).to(accum.device)
        print("resumed at frame %d from %s" % (start_frame, args.resume))

    meter = RateMeter(accum.device)
    t_wall0 = time.time()
    last_snap = time.time()
    ext = os.path.splitext(args.out)[1] or ".png"
    batch = max(1, min(32, args.spp // 8))
    ck = args.checkpoint or args.resume
    frame = start_frame + 1
    while frame <= args.spp:
        n = min(batch, args.spp - frame + 1)
        accum = renderer.render_frames(accum, rc, frame, n)
        frame += n
        meter.tick(W * H * n, frames=n)
        done = frame - 1
        if args.snapshot_every and \
                time.time() - last_snap > args.snapshot_every:
            _save_image(args.out + ".snap" + ext, renderer, accum, done)
            last_snap = time.time()
        if ck and done % args.checkpoint_every < batch:
            save_checkpoint(ck, accum, done, {"width": W, "height": H})

    frames = max(args.spp, start_frame)
    _save_image(args.out, renderer, accum, frames)
    print("wrote %s (%d spp)" % (args.out, frames))
    wall_s = time.time() - t_wall0
    with open(args.out + ".wall.json", "w") as f:
        json.dump({"width": W, "height": H, "spp": args.spp,
                   "start_frame": start_frame, "wall_s": round(wall_s, 1),
                   "device": _device_name(device)}, f)
    print("wall %.1f s (%.2f min) -> %s.wall.json"
          % (wall_s, wall_s / 60.0, args.out))
    if ck:
        save_checkpoint(ck, accum, frames, {"width": W, "height": H})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
