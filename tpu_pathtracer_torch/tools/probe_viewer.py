"""The viewer's frame cost at a 16:9 window (port of tools/probe_viewer.py).

Reports, as the median of host-visible calls, each ending with
Renderer.accum_to_image's uint8 readback (what the viewer pays a step):

  preview div  1-spp frames at 1/2, 1/4 and 1/8 of the window, the
               moving-camera ladder (tools/interactive.py --preview-div)
  full         the full-resolution 1-spp frame
  batch4       4 frames in one render_frames call (the viewer's --batch
               converging step), per frame

    python -m tpu_pathtracer_torch.tools.probe_viewer [--size 1080]

The device is --device (default cuda); --device cpu runs the same calls
on the CPU (host times of the plain versions, no device figure).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

DIVS = (2, 4, 8)


def median_ms(fn, reps):
    """Median wall ms of reps calls of fn after one warm-up call; fn must
    end with a host readback."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def probe(parts, H, device, reps=10):
    """The ladder at a (16H/9) x H window of the scene parts (flat_bvh,
    materials, envmap, texture): {"width", "height", "preview": {div:
    {width, height, ms}}, "full_ms", "batch4_ms_per_frame"}."""
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer
    fb, mats, envmap, texture = parts
    W = H * 16 // 9
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=H, device=device)

    def frames(rr, n):
        rc = default_camera(rr.width, rr.height).build_render_camera()
        acc = rr.zeros_accum()
        return lambda: rr.accum_to_image(rr.render_frames(acc, rc, 1, n), n)
    out = {"width": W, "height": H, "preview": {}}
    for div in DIVS:
        lo = Renderer(fb, mats, envmap=envmap, texture=texture,
                      width=W // div, height=H // div, settings=r.settings,
                      base_scene=r.scene, device=device)
        out["preview"][div] = {"width": lo.width, "height": lo.height,
                               "ms": median_ms(frames(lo, 1), reps)}
    out["full_ms"] = median_ms(frames(r, 1), reps)
    out["batch4_ms_per_frame"] = median_ms(frames(r, 4), reps) / 4.0
    return out


def report(rec):
    lines = ["preview %4dx%-4d (div %d) %8.1f ms/frame (%.1f fps)"
             % (p["width"], p["height"], div, p["ms"], 1e3 / p["ms"])
             for div, p in rec["preview"].items()]
    lines.append("full    %4dx%-4d         %8.1f ms/frame (%.1f fps)"
                 % (rec["width"], rec["height"], rec["full_ms"],
                    1e3 / rec["full_ms"]))
    lines.append("batch4  %4dx%-4d         %8.1f ms/frame (converging)"
                 % (rec["width"], rec["height"],
                    rec["batch4_ms_per_frame"]))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.probe_viewer",
        description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1080, help="window height")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cache-dir", default=".bvh_cache_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_viewer: no CUDA device (pass --device cpu)")
    from ..scene.demo import testobj_scene
    rec = probe(testobj_scene(cache_dir=args.cache_dir), args.size, device,
                args.reps)
    for line in report(rec):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
