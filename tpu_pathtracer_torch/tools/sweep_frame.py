"""A/B RenderSettings overrides on the real 1-spp frame cost (port of
tools/sweep_frame.py).

For each override set the marginal frame cost, (time of HI frames - time
of LO frames) / (HI - LO), as the median over --turns; the sets are timed
in turns inside this one process (forward, then backward, and so on), so
that every set meets the same host and card. For example

    python -m tpu_pathtracer_torch.tools.sweep_frame --wh 1024 \\
        "pool_lanes=1<<20" "pool_lanes=1<<19" \\
        "pool_lanes=1<<19,scatter_mode='wave'"

Each positional argument is a comma-separated list of field=value pairs
(Python literals, << allowed; "" for the defaults) applied by
dataclasses.replace. The device is --device (default cuda).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from ..utils.timing import synchronize
from .profile_frame import build_renderer, settings_overrides


def sweep(r, rc, specs, frames=(1, 5), turns=3):
    """{spec: {ms_per_frame (the median), runs (each turn's marginal ms)}}
    of each override spec on renderer r, the specs timed in turns."""
    base = r.settings
    sets = {s: dataclasses.replace(base, **settings_overrides(s))
            for s in specs}
    lo, hi = frames

    def cost(st):
        r.settings = st
        ts = []
        for M in (lo, hi):
            synchronize(r.device)
            t0 = time.perf_counter()
            r.render_frames(r.zeros_accum(), rc, 1, M)
            synchronize(r.device)
            ts.append(time.perf_counter() - t0)
        return (ts[1] - ts[0]) / (hi - lo) * 1e3
    runs = {s: [] for s in specs}
    try:
        for st in sets.values():               # warm-up
            r.settings = st
            r.render_frames(r.zeros_accum(), rc, 1, 1)
        for t in range(turns):
            order = list(specs) if t % 2 == 0 else list(reversed(specs))
            for s in order:
                runs[s].append(cost(sets[s]))
    finally:
        r.settings = base
    return {s: {"ms_per_frame": statistics.median(v), "runs": v}
            for s, v in runs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.sweep_frame",
        description=__doc__.splitlines()[0])
    ap.add_argument("--wh", type=int, default=1024)
    ap.add_argument("--w", type=int, default=0)
    ap.add_argument("--h", type=int, default=0)
    ap.add_argument("--frames", type=int, nargs=2, default=(1, 5))
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--demo", default="default",
                    help="a demo of tools/render.py (default, large, "
                         "organic_sss, ...)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("cfgs", nargs="+")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sweep_frame: no CUDA device (pass --device cpu)")
    W, H = args.w or args.wh, args.h or args.wh
    r, rc = build_renderer(args.demo, W, H, device)
    for spec, rec in sweep(r, rc, args.cfgs, tuple(args.frames),
                           args.turns).items():
        print("%s: %.1f ms/frame (turns %s)"
              % (spec or "defaults", rec["ms_per_frame"],
                 "/".join("%.1f" % x for x in rec["runs"])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
