"""The stage marks of the program's instrumented calls, as the per-layer
readers read them. `MARK_PREFIX` and `stage_device_ms` are frozen copies
of `tpu_pathtracer_torch/ops/marks.py` and `utils/profiling.py` as this
benchmark first read them, unchanged but for this docstring (the trace
arithmetic they use is `_trace.py`'s); `_is_mark` takes every device event
named `pt_stage_<stage>` as the mark of `<stage>`, so a stage the program
adds needs only its reader (`stage_ms.<stage>.py`); the rest is the
benchmark's own. The program's regen wave marks, in wave order: respawn,
ext_trace, medium (a scene with media), surface, material, shade, bssrdf
(a scene with a subsurface material), sample_env, shadow_trace, permute,
scatter, end. A trace of a program without the marks or spans gives None.

The bounce integrator's contract (tracer/wavefront.py), which marks_whole
holds a bounce trace to: `frame_start` is marked `respawn`, once a frame;
each launched `bounce_step`, the no-op steps after a frame's end among
them, is marked `ext_trace`, then `medium` (a scene with media), then
`surface`, then shade_hits' own marks (`material`, `shade`, `bssrdf`,
`sample_env`, `shadow_trace`), then `end`; `frame_end` is marked
`scatter`, once a frame. So each step's work falls to its stage, the
frame's deferred environment fetch to `scatter`, and a "wave" of
stage_device_ms (`wave_ms`, from a `respawn` mark to the next) is a
frame."""
from __future__ import annotations

import collections

from portbench.metrics._trace import DEVICE_CATS, _span, load_events

MARK_PREFIX = "pt_stage_"


def stage_device_ms(trace, window=None):
    """Device time of each wave stage of an instrumented call, from the
    stage marks (the pt_stage_* kernels) among the device events that
    start inside the record_function `window` (all when None). Each
    device event belongs to the latest mark that started before it; the
    `end` mark closes a wave, so what runs from there to the next mark
    (and before the first mark) belongs to no stage.

    Returns {"stages": {stage: ms} for each stage marked, "none_ms",
    "marks_ms" (the marks' own kernels), "marks" (their count),
    "wave_starts" (us, the start of each `respawn` mark), "wave_ms" (each
    wave's device ms, from its `respawn` mark to its `end` mark)}."""
    events = load_events(trace)
    w0, w1 = _span(events, window)
    dev = sorted(((e["ts"], not _is_mark(e["name"]), e) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                  and w0 <= e["ts"] < w1), key=lambda x: x[:2])
    stages = collections.Counter()
    none_us = marks_us = 0.0
    n_marks = 0
    starts, wave_us = [], []
    stage = None
    for ts, not_mark, e in dev:
        dur = e.get("dur", 0)
        if not not_mark:
            stage = e["name"][len(MARK_PREFIX):]
            marks_us += dur
            n_marks += 1
            if stage == "respawn":
                starts.append(ts)
                wave_us.append(0.0)
            if stage == "end":
                stage = None
            else:
                stages[stage] += 0.0
            continue
        if stage is None:
            none_us += dur
        else:
            stages[stage] += dur
            if wave_us:
                wave_us[-1] += dur
    return {"stages": {k: us / 1e3 for k, us in stages.items()},
            "none_ms": none_us / 1e3, "marks_ms": marks_us / 1e3,
            "marks": n_marks, "wave_starts": starts,
            "wave_ms": [us / 1e3 for us in wave_us]}


def _is_mark(name):
    return name.startswith(MARK_PREFIX)


# ---- the benchmark's own ----

def render_stages(run):
    """stage_device_ms of a traced render run over every device event of
    its trace, or None where the run is not a render or its trace holds no
    stage mark. The profiled region holds the traced call and one warm-up
    op before it, which falls before the first mark (no stage). The host's
    window is not used here: on the H100 the profiler's device timestamps
    stray from the host's clock by up to some milliseconds either way, so
    a wave's marks at either end of the call can fall outside it."""
    if run.get("loop") != "render" or not run.get("events") \
            or not run.get("frames"):
        return None
    got = stage_device_ms(run["events"], None)
    return got if got["marks"] else None


def marks_whole(events, waves, integrator="regen", frames=0):
    """False where the trace holds stage marks but not as many as the call
    counted: the profiler lost device records (on the H100 runs of some
    tens to some thousands of a traced call's records, in one call of
    three to one of five), so every device reading of that trace would
    read short. True for a trace without marks, which no second call can
    mend.

    A regen call (`waves`, {width: count}) needs one `respawn` and one
    `end` mark for each wave it counted, and every stage marked a whole
    multiple of the waves. A bounce call (`integrator` "bounce", `waves`
    {lanes: launched steps}, `frames` the call's frames) needs one `end`
    mark for each launched step, one `respawn` and one `scatter` mark for
    each frame, and every other stage marked a whole multiple of the
    launched steps (the contract in this module's docstring)."""
    n = collections.Counter(e["name"] for e in events
                            if e.get("ph") == "X"
                            and e.get("cat") in DEVICE_CATS
                            and e["name"].startswith(MARK_PREFIX))
    if not n:
        return True
    want = sum(int(c) for c in (waves or {}).values())
    if integrator == "bounce":
        once = {MARK_PREFIX + s for s in ("respawn", "scatter")}
        return want > 0 and frames > 0 and n[MARK_PREFIX + "end"] == want \
            and all(n[m] == frames for m in once) \
            and all(c % want == 0 for m, c in n.items() if m not in once)
    return want > 0 and n[MARK_PREFIX + "respawn"] == want \
        == n[MARK_PREFIX + "end"] and all(c % want == 0 for c in n.values())


def stage_ms(run, stage):
    """Device ms a frame of `stage` in the traced call, or None."""
    got = render_stages(run)
    if got is None or stage not in got["stages"]:
        return None
    return got["stages"][stage] / run["frames"]


def _host_spans(run):
    """{name: [duration us]} of the program's host spans (the
    record_functions of utils/profiling.py: span) inside a traced drag
    window, or None where the run is not a drag."""
    if run.get("loop") != "drag" or not run.get("events"):
        return None
    w0, w1 = _span(run["events"], run["window"])
    spans = collections.defaultdict(list)
    for e in run["events"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and w0 <= e["ts"] < w1:
            spans[e["name"]].append(e.get("dur", 0))
    return spans


def traced_steps(run):
    """The viewer steps the traced drag window holds, one program span
    `pt.viewer.preview` a step; 0 where it holds none."""
    spans = _host_spans(run)
    return len(spans.get("pt.viewer.preview", ())) if spans else 0


def host_span_ms(run, name):
    """Host ms a viewer step in the program's spans named `name` inside
    the traced drag window: their summed durations over the traced steps
    (traced_steps). These steps run under the profiler, so compare the
    result with readback_traced_ms, the benchmark's readback over the same
    steps. None where the run is not a drag or its trace holds no such
    span."""
    spans = _host_spans(run)
    steps = traced_steps(run)
    if not steps or name not in spans:
        return None
    return sum(spans[name]) / 1e3 / steps
