"""The marginal per-op profile of the real frame, and the price of each
wave stage (port of tools/profile_frame.py).

Profiles a LO-frame and a HI-frame render of a demo scene with
torch.profiler and prints (HI - LO) / (HI - LO frames) per op: the
drain waves and the one-time work cancel in the difference, leaving the
steady cost of one frame (utils/profiling.py). Then the ops rolled into
the wave-stage categories, and the device's busy time and idle share
over the profiled window, which the host paces.

    python -m tpu_pathtracer_torch.tools.profile_frame --wh 1024 \\
        --frames 1 5 [--demo subsurface] [--integrator bounce] \\
        [--set pool_lanes=1<<19,scatter_mode='wave'] [--dup shade,permute]

--dup STAGE[,STAGE...] prices each regen stage (tracer/regen.DUP_STAGES;
"all" for every one): the median marginal ms per frame (HI against LO
frames, as tools/sweep_frame.py times it) with RenderSettings.dup_stage
set minus without it, the sets taken in turns inside this process (none,
each stage, each stage backwards, none); then each stage's image is held
to the undoubled one bit for bit under torch's deterministic algorithms
(CUDA's index_add_ otherwise adds in no fixed order).

The device is --device (default cuda). --device cpu runs the same control
flow with the CPU activity only and prints "host ops (cpu)", the host's
aten ops by self time, and no device figure.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses

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


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (index_add_ adds in index order) for
    the body, without their filling of uninitialised memory, which adds a
    kernel to every allocation."""
    import torch.utils.deterministic as tud
    was, fill = (torch.are_deterministic_algorithms_enabled(),
                 tud.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        tud.fill_uninitialized_memory = fill


def price_stages(r, rc, stages, frames=(1, 5)):
    """The price of each dup_stage on r's frame. sweep_frame.sweep times
    the undoubled settings and each stage's in turns, forward then back
    (none, s1 ... sN, sN ... s1, none), so each stage sits between two
    undoubled renders; a stage's price is its marginal ms per frame minus
    the undoubled one, the drain of a render call cancelled in each. Then,
    under deterministic(), each stage's image of HI frames is held to the
    undoubled one. Returns {stage: {none_ms, dup_ms, price_ms,
    bit_equal}}: each turn's marginal ms per frame without and with the
    stage, the difference of their medians, and whether the doubled image
    equals the undoubled one bit for bit."""
    from .sweep_frame import sweep
    specs = {s: "dup_stage=%r" % s for s in stages}
    rec = sweep(r, rc, [""] + list(specs.values()), frames, turns=2)
    none = rec[""]
    out = {s: {"none_ms": none["runs"], "dup_ms": rec[spec]["runs"],
               "price_ms": rec[spec]["ms_per_frame"]
               - none["ms_per_frame"]} for s, spec in specs.items()}
    base = r.settings

    def image(stage):
        r.settings = dataclasses.replace(base, dup_stage=stage)
        return r.render_frames(r.zeros_accum(), rc, 1, frames[1])
    try:
        with deterministic():
            ref = image("")
            for s in stages:
                out[s]["bit_equal"] = torch.equal(image(s), ref)
    finally:
        r.settings = base
    return out


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
    ap.add_argument("--dup", default="",
                    help="price these regen stages (comma-separated, or "
                         "'all')")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device (pass --device cpu "
                         "to profile on the CPU)")
    from ..tracer.regen import DUP_STAGES
    stages = list(DUP_STAGES) if args.dup == "all" else \
        [s for s in args.dup.split(",") if s]
    for s in stages:
        if s not in DUP_STAGES:
            raise SystemExit("unknown stage %r (want %s)"
                             % (s, ", ".join(DUP_STAGES)))
    W, H = args.w or args.wh, args.h or args.wh
    r, rc = build_renderer(args.demo, W, H, device, args.integrator,
                           settings_overrides(args.set))
    print("%s %dx%d, %s integrator, frames %d %d, device %s"
          % (args.demo, W, H, r.settings.integrator, args.frames[0],
             args.frames[1], args.device), flush=True)
    for line in report(profile(r, rc, tuple(args.frames)), args.top):
        print(line, flush=True)
    if stages:
        for s, p in price_stages(r, rc, stages,
                                 tuple(args.frames)).items():
            print("dup %-12s price %+8.2f ms/frame (with %s, without %s "
                  "ms); image bit for bit: %s"
                  % (s, p["price_ms"],
                     "/".join("%.1f" % x for x in p["dup_ms"]),
                     "/".join("%.1f" % x for x in p["none_ms"]),
                     p["bit_equal"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
