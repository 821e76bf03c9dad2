"""The control of each cell's comparison: the plain reference computed in
bfloat16, the precision below the configurations' float32, put in the
program's place and compared with the float32 reference by the cell's own
numbers, at the cell's own size: the pixels a run draws from the seed and
a window's frames (render cells) or steps (the drag cell). Its readings
set the upper end of each limit (PERF.md); the benchmark's runs do not run
it.

    python -m portbench.control --workload <cell> --seeds 1 2 3 \\
        [--frames F | --steps N] [--device cuda]

Each seed prints one JSON line: the numbers, the limits, and whether the
control passes them (it must not)."""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import check, scenes
from portbench.camera import Orbit
from portbench.run import ROOT, cell_setup, load_json


def control_numbers(wl, config, traffic, seed, size, device,
                    dtype=torch.bfloat16):
    """The cell's numbers with the reference in `dtype` as the program,
    `size` frames (render) or steps (drag)."""
    inputs = scenes.make_inputs(config)
    if traffic["kind"] == "cli_loop":
        from portbench.drivers import cli_loop as drv
        drawn = drv.plan(traffic, config, seed)
        lanes = drv.lanes_of(drawn["pixels"], config)
        f0 = drawn["frame0"]
        orbit = Orbit(**config["camera"])
        want = drv.reference_sums(inputs, config, orbit, lanes, f0,
                                  f0 + size, device)
        got = drv.reference_sums(inputs, config, orbit, lanes, f0,
                                 f0 + size, device, dtype)
        return check.render_numbers(got, want)
    from portbench.drivers import viewer_drag as drv
    drawn = drv.plan(traffic, config, seed)
    div = int(traffic["preview_div"])
    cams = drv.camera_track(drawn["orbit"], drawn["moves"], size,
                            config["width"] // div, config["height"] // div)
    picked = drv.pick_steps(drawn["rng"], size, traffic)
    cams = [cams[i] for i in picked]
    want = drv.reference_pixels(inputs, config, cams, drawn["sx"],
                                drawn["sy"], div, device)
    got = drv.reference_pixels(inputs, config, cams, drawn["sx"],
                               drawn["sy"], div, device, dtype)
    return check.image_numbers(got, want)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    wl, config, traffic = cell_setup(bench, args.workload)
    size = args.frames if traffic["kind"] == "cli_loop" else args.steps
    lims = check.limits(args.workload)
    for seed in args.seeds:
        numbers = control_numbers(wl, config, traffic, seed, size,
                                  torch.device(args.device))
        ok, shown = check.judge(numbers, lims)
        print(json.dumps({"cell": args.workload, "seed": seed, "size": size,
                          "numbers": numbers, "check": shown,
                          "control_passes": ok}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
