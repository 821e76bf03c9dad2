"""The marginal per-op profile of the real frame, and each wave stage's
device time (port of tools/profile_frame.py).

Profiles a LO-frame and a HI-frame render of a demo scene with
torch.profiler and prints (HI - LO) / (HI - LO frames) per op: the
drain waves and the one-time work cancel in the difference, leaving the
steady cost of one frame (utils/profiling.py). Then the ops rolled into
the wave-stage categories, and the device's busy time and idle share
over the profiled window, which the host paces.

    python -m tpu_pathtracer_torch.tools.profile_frame --wh 1024 \\
        --frames 1 5 [--demo subsurface] [--integrator bounce] \\
        [--set pool_lanes=1<<19,scatter_mode='wave'] [--stages]

--stages then prints each stage's device ms a frame: one with_stats call
of HI frames under torch.profiler, its device time split by the call's
stage marks (ops/marks.py; utils/profiling.py: stage_device_ms), a regen
call's by wave, a bounce call's by frame (each frame one `respawn` mark,
so the report's "waves" are its frames). Only a CUDA card's marks carry
device time, so --stages refuses any other device.

The device is --device (default cuda). --device cpu runs the same control
flow with the CPU activity only and prints "host ops (cpu)", the host's
aten ops by self time, and no device figure.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import tempfile

import torch

from ..utils import profiling
from ..utils.timing import synchronize


def settings_overrides(spec):
    """{field: value} of a 'field=value,...' list of Python literals; a
    value may use <<, as in pool_lanes=1<<19."""
    out = {}
    for pair in filter(None, (p.strip() for p in spec.split(","))):
        k, v = pair.split("=", 1)
        if "<<" in v:
            a, b = v.split("<<", 1)
            out[k.strip()] = ast.literal_eval(a.strip()) \
                << ast.literal_eval(b.strip())
        else:
            out[k.strip()] = ast.literal_eval(v.strip())
    return out


def frame_runner(r, rc):
    """run(M): M frames from frame 1 into a zero accumulation, waiting for
    the device."""
    def run(M):
        acc = r.render_frames(r.zeros_accum(), rc, 1, M)
        synchronize(r.device)
        return acc
    return run


def profile(r, rc, frames=(1, 5)):
    """The marginal profile of r's frame: {ops, meta, rollup, spans,
    device, pool_rows}; rollup holds the category sums. A device profile
    that holds no traversal kernel raises: the `trace` bucket is never
    left empty in silence."""
    on_dev = r.device.type == "cuda"
    run = frame_runner(r, rc)
    run(1)                                     # builds, caches, warm-up
    P = r.width * r.height
    if r.settings.integrator == "regen" and r.settings.pool_lanes > 0:
        P = min(P, r.settings.pool_lanes)
    ops, meta, spans = profiling.profile_marginal(run, frames, device=on_dev,
                                                  pool_rows=P)
    if on_dev and not any(profiling.bucket(*m[:3]) == "trace"
                          for m in meta.values()):
        raise RuntimeError("the device profile holds no traverse_kernel "
                           "event: the trace bucket would read 0")
    return {"ops": ops, "meta": meta,
            "rollup": profiling.categorize(ops, meta, pool_rows=P),
            "spans": spans, "device": str(r.device), "pool_rows": P}


def report(prof, top=30):
    """The printed report of profile() as a list of lines."""
    on_dev = prof["device"].startswith("cuda")
    lo, hi, marg = prof["spans"]
    df = hi["frames"] - lo["frames"]
    head = "device ops" if on_dev else "host ops (cpu)"
    rows = sorted(((ms, k) for k, ms in prof["ops"].items()), reverse=True)
    tot = sum(ms for ms, _ in rows)
    lines = ["%s: marginal anatomy over %d frames, op-sum %.2f ms/frame, "
             "window %.2f ms/frame" % (head, df, tot, marg["window_ms"])]
    for ms, k in rows[:top]:
        cat, op, kernel, _rows = prof["meta"][k]
        lines.append("%9.3f ms  %-14s %-24s %s" % (
            ms, profiling.bucket(cat, op, kernel, _rows, prof["pool_rows"]),
            (op or "-")[:24], kernel[:90]))
    lines.append("categories (ms/frame): " + ", ".join(
        "%s %.3f" % kv for kv in prof["rollup"].items()))
    if on_dev:
        for s in (lo, hi):
            lines.append("device busy %d frames: %.2f of %.2f ms (idle "
                         "%.1f%%), %d device events"
                         % (s["frames"], s["busy_ms"], s["window_ms"],
                            100 * s["idle_share"], s["events"]))
        lines.append("device busy, marginal: %.2f ms a frame, of %.2f ms of "
                     "profiled window (idle %.1f%%) and of the %.2f ms frame "
                     "timed without the profiler (idle %.1f%%)"
                     % (marg["busy_ms"], marg["window_ms"],
                        100 * marg["idle_share"], marg["frame_ms"],
                        100 * marg["frame_idle_share"]))
    else:
        lines.append("frame timed without the profiler: %.2f ms (host)"
                     % marg["frame_ms"])
    return lines


def stage_profile(r, rc, frames):
    """stage_device_ms of one with_stats call of `frames` frames on r's
    device, after a warm-up call of the same key (it builds and captures),
    under torch.profiler (CPU and CUDA activity); every device event of
    the trace counts."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        r.render_frames(r.zeros_accum(), rc, 1, frames, with_stats=True)
        synchronize(r.device)
    run()
    with tempfile.TemporaryDirectory(prefix="profile_frame_") as tmp:
        path = os.path.join(tmp, "stages.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        prof.export_chrome_trace(path)
        return profiling.stage_device_ms(path)


def stage_report(got, frames):
    """The printed lines of a stage_profile of `frames` frames: each
    marked stage's device ms a frame in wave order, then the device time
    outside any stage, the marks' own and the busy frame."""
    from ..ops.marks import STAGES
    per = {k: ms / frames for k, ms in got["stages"].items()}
    lines = ["stages (device ms a frame, one with_stats call of %d frames, "
             "%d waves):" % (frames, len(got["wave_ms"]))]
    lines += ["%9.3f ms  %s" % (per[k], k) for k in STAGES if k in per]
    lines.append("%9.3f ms  outside any stage" % (got["none_ms"] / frames))
    lines.append("%9.3f ms  the %d marks' own kernels"
                 % (got["marks_ms"] / frames, got["marks"]))
    lines.append("%9.3f ms  busy frame (the stages, the rest and the marks)"
                 % (sum(per.values())
                    + (got["none_ms"] + got["marks_ms"]) / frames))
    return lines


def build_renderer(demo_name, W, H, device, integrator=None, overrides=None):
    """(renderer, render camera) of a demo at W x H with the demo's default
    settings, the integrator and the overrides applied; BVHs are cached in
    .bvh_cache_torch, as the render CLI's default."""
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer
    from .render import DEMOS, _demo_parts
    if demo_name not in DEMOS:
        raise SystemExit("unknown demo %r (want one of %s)"
                         % (demo_name, ", ".join(DEMOS)))
    fb, mats, envmap, texture = _demo_parts(demo_name, ".bvh_cache_torch")
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=H, device=device)
    kw = dict(overrides or {})
    if integrator:
        kw["integrator"] = integrator
    if kw:
        r.settings = dataclasses.replace(r.settings, **kw)
    return r, default_camera(W, H).build_render_camera()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.profile_frame",
        description=__doc__.splitlines()[0])
    ap.add_argument("--wh", type=int, default=1024)
    ap.add_argument("--w", type=int, default=0, help="width (0 = --wh)")
    ap.add_argument("--h", type=int, default=0, help="height (0 = --wh)")
    ap.add_argument("--frames", type=int, nargs=2, default=(1, 5))
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--demo", default="default")
    ap.add_argument("--set", default="",
                    help="comma-separated RenderSettings field=value "
                         "overrides (Python literals)")
    ap.add_argument("--integrator", choices=("regen", "bounce"))
    ap.add_argument("--stages", action="store_true",
                    help="then each regen stage's device ms a frame, from "
                         "the stage marks (a CUDA card only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device (pass --device cpu "
                         "to profile on the CPU)")
    if args.stages and device.type != "cuda":
        raise SystemExit("profile_frame --stages: the stage marks carry "
                         "device time only on a CUDA card, not on %s"
                         % device)
    W, H = args.w or args.wh, args.h or args.wh
    r, rc = build_renderer(args.demo, W, H, device, args.integrator,
                           settings_overrides(args.set))
    print("%s %dx%d, %s integrator, frames %d %d, device %s"
          % (args.demo, W, H, r.settings.integrator, args.frames[0],
             args.frames[1], args.device), flush=True)
    for line in report(profile(r, rc, tuple(args.frames)), args.top):
        print(line, flush=True)
    if args.stages:
        hi = args.frames[1]
        for line in stage_report(stage_profile(r, rc, hi), hi):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
