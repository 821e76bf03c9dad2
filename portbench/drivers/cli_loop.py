"""Traffic `cli_loop`: the CLI's progressive render loop
(tpu_pathtracer_torch/tools/render.py), calls of `frames_per_call` 1-spp
frames into one device accumulation, back to back, with no readback in the
window, under the configuration's camera. The seed draws the first frame
number (so each seed traces other samples of the same image: the same
work) and the `check_pixels` pixels whose sums are compared with the
reference.

frame_ms = the window's time over the frames of the whole calls it ran;
the window closes with a synchronize after the call that crossed
--seconds. With --trace 1 one more call (with the program's counters on)
runs under the profiler into the same accumulation, profiled anew (at
most TRACE_TRIES calls) while its trace lacks some of the waves or steps
the program counted (_stages.marks_whole). Everything the traced call
counted is read from the integrator that the configuration's settings
name (`regen`, the default, or `bounce`; program.traced_waves and
program.counters look it up and build nothing): the run's `traced`
carries `integrator`, `waves` (regen waves at each width, or the bounce
steps launched), the rays, and every counter the program publishes,
beside its trace."""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import check, program, scenes
from portbench.camera import Orbit
from portbench.metrics import _stages
from portbench.reference import render as ref


# the reference's paths a call, a bound on its memory
PATHS_PER_CALL = 1 << 18
# traced calls at most, while the profiler loses records of the call
TRACE_TRIES = 6


def plan(traffic, config, seed):
    """What the seed draws: the first frame number and the compared pixels
    (flat indices y * W + x)."""
    rng = np.random.default_rng(seed)
    frame0 = 1 + int(rng.integers(0, 1 << 24)) * 64
    W, H = config["width"], config["height"]
    pix = rng.choice(W * H, traffic["check_pixels"], replace=False)
    return {"frame0": frame0, "pixels": pix}


def lanes_of(pix, config):
    """The reference's lanes of flat pixel indices."""
    W, H = config["width"], config["height"]
    return ref.lane_of_pixel(torch.as_tensor(pix % W),
                             torch.as_tensor(pix // W), W, H)


def run(ctx):
    p, cfg = ctx.traffic, ctx.config
    drawn = plan(p, cfg, ctx.seed)
    orbit, frame0 = Orbit(**cfg["camera"]), drawn["frame0"]
    W, H = cfg["width"], cfg["height"]
    fpc = int(p["frames_per_call"])

    inputs = scenes.make_inputs(cfg)
    r, _ = program.build_renderer(cfg, inputs, ctx.device, ctx.cache_dir)
    rc = program.render_camera(orbit, W, H)
    r.render_frames(r.zeros_accum(), rc, 1, fpc)
    if ctx.trace:
        r.render_frames(r.zeros_accum(), rc, 1, fpc, with_stats=True)
    accum = r.zeros_accum()
    ctx.window_opens()

    t0 = time.perf_counter()
    frame = frame0
    while True:
        accum = r.render_frames(accum, rc, frame, fpc)
        frame += fpc
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    t1 = time.perf_counter()
    metrics = {"frame_ms": (t1 - t0) * 1e3 / (frame - frame0)}

    traced = {}
    if ctx.trace:
        integrator = r.settings.integrator
        for _ in range(TRACE_TRIES):
            events, (accum, _, rays) = ctx.profile(
                lambda: r.render_frames(accum, rc, frame, fpc,
                                        with_stats=True))
            frame += fpc
            waves = program.traced_waves(r)
            if _stages.marks_whole(events, waves, integrator, fpc):
                break
            print("cli_loop: the profiler lost records of a traced call; "
                  "profiling the next", file=sys.stderr)
        traced = {"loop": "render", "integrator": integrator,
                  "events": events, "window": "portbench_window",
                  "frames": fpc, "waves": waves, "rays": rays,
                  "stream_rows": program.stream_rows(r),
                  "counters": program.counters(r)}
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0

    # ---- the comparison, with the program's state freed ----
    lanes = lanes_of(drawn["pixels"], cfg)
    got = accum[lanes.to(accum.device)].double().cpu().numpy()
    del accum, r
    ctx.free_device()
    t = time.perf_counter()
    want = reference_sums(inputs, cfg, orbit, lanes, frame0, frame,
                          ctx.device)
    return {"metrics": metrics, "attempted": frame - frame0, "failed": 0,
            "memory_peak_bytes": peak, "traced": traced,
            "numbers": check.render_numbers(got, want),
            "reference_s": time.perf_counter() - t}


def reference_sums(inputs, cfg, orbit, lanes, f0, f1, device,
                   dtype=torch.float32):
    """[K,3] float64: each lane's sum over the frames [f0, f1) by the
    plain reference, in calls of at most PATHS_PER_CALL paths."""
    mesh, mats, env, tex = inputs
    sc = ref.Scene(mesh, mats, env, tex, device, dtype,
                   settings=cfg.get("settings"))
    W, H = cfg["width"], cfg["height"]
    cam = orbit.vector(W, H)
    K = lanes.shape[0]
    lanes = lanes.to(device)
    out = torch.zeros((K, 3), dtype=torch.float64, device=device)
    per = max(1, PATHS_PER_CALL // K)
    for a in range(f0, f1, per):
        b = min(a + per, f1)
        fr = torch.arange(a, b, device=device).repeat_interleave(K)
        ln = lanes.repeat(b - a)
        L = ref.trace_paths(sc, cam, W, H, fr, ln).double()
        out += L.view(b - a, K, 3).sum(0)
    return out.cpu().numpy()
