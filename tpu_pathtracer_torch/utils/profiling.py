"""Per-op frame profiles from torch.profiler (port of utils/profiling.py).

The marginal-diff protocol of the JAX package: profile a LO-frame and a
HI-frame render, subtract the per-op sums and divide by the frame
difference, so the drain waves and the one-time work cancel and what is
left is the steady cost of one frame. Here an "op" is one CUDA kernel
(or memcpy / memset) under the aten op that launched it, read from the
profiler's exported chrome trace: a kernel event's "External id" names
the innermost op on the host stack when it was launched.

Unlike the TPU, whose frame is one device program, the port's frame is
paced by the host: `device_busy` gives the union of the device intervals
over the profiled window, and so the device's idle share.

On a CPU-only profile (`profile_marginal(..., device=False)`) the ops are
the host's aten ops by exclusive (self) time. Such a profile records no
shapes (the plain traversal's host trace is large enough as it is), so
its gathers are not split into pool-width and table ones.

The port's own spans and marks, which land in the same trace on the
profiler's one clock (nothing is recorded while no profiler runs):
- `span(name)`: a host span, a record_function while torch.profiler
  records: `pt.viewer.preview` (tools/interactive.py: the preview's
  render); `pt.image.unswizzle` (Renderer.accum_to_image: the tonemap and
  the un-swizzle, on the device for a tensor, with the preview's pixel
  repetition; Renderer.accum_to_buffer: the host scatter); `pt.image.copy`
  (the copy to the host and its wait) (tracer/renderer.py);
- the stage marks of a regen wave's with_stats call (ops/marks.py: on a
  CUDA device the empty kernel `pt_stage_<stage>` captured into the
  wave's graph, on the CPU a zero-length record_function of that name):
  `stage_device_ms` splits a trace's device time by them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import tempfile

import torch

from ..ops.marks import MARK_PREFIX, STAGES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "profile_window"          # the record_functions' name prefix
# the aten ops that read rows of a table by an index tensor
_GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather",
               "aten::take")
_COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::cat",
             "aten::to", "aten::_to_copy", "aten::stack")
CATEGORIES = ("trace", "image_scatter", "argsort", "permute_gather",
              "gathers", "layout_copies", "other")
_NULL_SPAN = contextlib.nullcontext()


def span(name):
    """A host span named `name`: torch.profiler.record_function(name)
    while the profiler records, else one shared null context (no cost
    beyond the check)."""
    if not torch.autograd._profiler_enabled():
        return _NULL_SPAN
    return torch.profiler.record_function(name)


def load_events(trace):
    """The event list of a chrome trace file (a list passes through)."""
    if isinstance(trace, list):
        return trace
    with open(trace) as f:
        return json.load(f)["traceEvents"]


def _table_rows(op, dims):
    """Rows of the table a gather op reads: the largest extent of its first
    input (a pool-state plane is [3, P], a row table [K, C])."""
    if op not in _GATHER_OPS or not dims or not dims[0]:
        return 0
    first = dims[0]
    if first and isinstance(first[0], list):      # a TensorList input
        first = first[0]
    return max(first) if first else 0


def _pool_width(rows, pool_rows):
    """The JAX rule (tpu_pathtracer/utils/profiling.py:103-116): a scene
    table has fewer rows than half the pool; the compaction permute's
    operands are pool-sized. It holds where the pool is wider than twice
    the largest scene table (at 1024x1024: 1M lanes against <= 200k rows),
    not at toy sizes."""
    return bool(pool_rows) and rows >= pool_rows // 2


def _key(name, op, rows, pool_rows):
    key = "%s | %s" % (op or "-", name)
    if op in _GATHER_OPS and pool_rows:
        key += " [pool-width]" if _pool_width(rows, pool_rows) else " [table]"
    return key


def _span(events, window):
    """(t0, t1) in us of the record_function named `window`, or of the
    whole trace when window is None."""
    if window is None:
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and isinstance(e.get("ts"), float)]
    else:
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name") == window]
        if not spans:
            raise ValueError("no record_function %r in the trace" % window)
    return min(s for s, _ in spans), max(t for _, t in spans)


def collect_device_ops(trace, pool_rows=None, window=None):
    """Sum the device events (kernels, memcpy, memset) of a chrome trace
    by name under their launching op, those that start inside the
    record_function `window` (all when None). Returns (dur_us Counter,
    count Counter, meta {key: (event cat, op, kernel name, table rows)});
    with pool_rows, gathers split into pool-width and table keys."""
    events = load_events(trace)
    w0, w1 = _span(events, window)
    ops = {e["args"]["External id"]: (e["name"], e["args"].get("Input Dims"))
           for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and "External id" in e.get("args", {})}
    dur, cnt, meta = collections.Counter(), collections.Counter(), {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS \
                or not w0 <= e["ts"] < w1:
            continue
        op, dims = ops.get(e.get("args", {}).get("External id"), ("", None))
        rows = _table_rows(op, dims)
        key = _key(e["name"], op, rows, pool_rows)
        dur[key] += e.get("dur", 0)
        cnt[key] += 1
        meta.setdefault(key, (e["cat"], op, e["name"], rows))
    return dur, cnt, meta


def collect_host_ops(trace, pool_rows=None, window=None):
    """The host's aten ops of a chrome trace by exclusive (self) time, those
    that start inside `window`, with the return form of collect_device_ops
    (the kernel name is the op's)."""
    events = load_events(trace)
    w0, w1 = _span(events, window)
    evs = sorted((e for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                  and w0 <= e["ts"] < w1),
                 key=lambda e: (str(e["tid"]), e["ts"], -e.get("dur", 0)))
    self_us = [e.get("dur", 0) for e in evs]
    stack = []
    for i, e in enumerate(evs):
        while stack and (evs[stack[-1]]["tid"] != e["tid"]
                         or e["ts"] >= evs[stack[-1]]["ts"]
                         + evs[stack[-1]].get("dur", 0)):
            stack.pop()
        if stack:
            self_us[stack[-1]] -= e.get("dur", 0)
        stack.append(i)
    dur, cnt, meta = collections.Counter(), collections.Counter(), {}
    for e, us in zip(evs, self_us):
        rows = _table_rows(e["name"], e["args"].get("Input Dims"))
        key = _key(e["name"], e["name"], rows, pool_rows)
        dur[key] += us
        cnt[key] += 1
        meta.setdefault(key, ("cpu_op", e["name"], e["name"], rows))
    return dur, cnt, meta


def device_busy(trace, window=None):
    """The device's busy time over a profiled window: the union of the
    device intervals inside the record_function `window` (the trace's
    whole span when None). Returns {window_ms, busy_ms, idle_share,
    events}."""
    events = load_events(trace)
    w0, w1 = _span(events, window)
    dev = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    busy, end = 0.0, w0
    for s, t in sorted(dev):
        s, t = max(s, end), min(t, w1)
        if t > s:
            busy += t - s
            end = t
    window_us = max(w1 - w0, 1e-9)
    return {"window_ms": window_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window_us, "events": len(dev)}


def profile_marginal(run, frames=(1, 5), device=True, pool_rows=None):
    """run(M) must render M frames and wait for the device. One profiler
    session (CPU + CUDA activity; CPU only with device=False) opens with
    one small device op (the session's one-time start costs land there,
    not in a window), then holds run(LO) and run(HI), each in its own
    record_function. Then, without the profiler, run(LO) and run(HI) are
    timed in two turns: the frame as the user's host runs it, against
    which the device's busy time gives the idle share (the profiler's own
    host time stretches the profiled windows).

    Returns (ops {key: marginal ms per frame}, meta, spans): spans holds
    the LO and HI windows' {frames, window_ms, and with device busy_ms,
    idle_share, events}, then the marginal per frame {window_ms, frame_ms
    (unprofiled), and with device busy_ms, idle_share (of the profiled
    window), frame_idle_share (of frame_ms)}. The trace is written to a
    temporary directory and removed."""
    import time
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device
                                     else [])
    names = ["%s_%d" % (WINDOW, M) for M in frames]
    with tempfile.TemporaryDirectory(prefix="profile_frame_") as tmp:
        path = os.path.join(tmp, "frames_%d_%d.json" % tuple(frames))
        with profile(activities=acts, record_shapes=device) as prof:
            if device:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            for M, name in zip(frames, names):
                with record_function(name):
                    run(M)
        prof.export_chrome_trace(path)
        del prof
        events = load_events(path)
        out, spans = [], []
        for M, name in zip(frames, names):
            if device:
                out.append(collect_device_ops(events, pool_rows, name))
                span = device_busy(events, name)
            else:
                out.append(collect_host_ops(events, pool_rows, name))
                span = {"window_ms": device_busy(events, name)["window_ms"]}
            spans.append(dict(span, frames=M))
        del events
    plain = []
    for _ in range(2):
        ts = []
        for M in frames:
            t0 = time.perf_counter()
            run(M)
            ts.append(time.perf_counter() - t0)
        plain.append(ts)
    df = frames[1] - frames[0]
    ops, meta = marginal_ops(out[0], out[1], df)
    lo, hi = spans
    marg = {"window_ms": (hi["window_ms"] - lo["window_ms"]) / df,
            "frame_ms": statistics.median((b - a) * 1e3 / df
                                          for a, b in plain)}
    if device:
        marg["busy_ms"] = (hi["busy_ms"] - lo["busy_ms"]) / df
        marg["idle_share"] = 1.0 - marg["busy_ms"] / max(marg["window_ms"],
                                                         1e-9)
        marg["frame_idle_share"] = 1.0 - marg["busy_ms"] / max(
            marg["frame_ms"], 1e-9)
    spans.append(dict(marg, frames="marginal"))
    return ops, meta, spans


def marginal_ops(lo, hi, df):
    """(ops {key: ms per frame}, meta) of two collected profiles (the
    collect_* triples of the LO and HI runs) df frames apart. A key of
    one run only counts as 0 in the other, so its marginal can be
    negative."""
    (dlo, _, mlo), (dhi, _, mhi) = lo, hi
    meta = dict(mlo)
    meta.update(mhi)
    ops = {n: (dhi.get(n, 0) - dlo.get(n, 0)) / df / 1e3
           for n in set(dhi) | set(dlo)}
    return ops, meta


def categorize(ops, meta, pool_rows=None):
    """Roll per-op marginal costs into the JAX package's wave-stage
    buckets, by kernel and op name: trace (the traverse_kernel
    instantiations), image_scatter (index_add_), argsort (the sort
    kernels), permute_gather (gathers from a pool-width table) against
    gathers (scene tables; the JAX rule, see _pool_width), layout_copies
    (copies, memcpy, memset) and other (mostly the elementwise kernels).
    Negative marginals are kept so that pieces of one bucket cancel."""
    buckets = collections.Counter({c: 0.0 for c in CATEGORIES})
    for key, ms in ops.items():
        cat, op, kernel, rows = meta.get(key, ("", "", key, 0))
        buckets[bucket(cat, op, kernel, rows, pool_rows)] += ms
    return dict(buckets)


def bucket(cat, op, kernel, rows=0, pool_rows=None):
    """The category of one op (see categorize)."""
    k, o = kernel.lower(), op.lower()
    if "traverse_kernel" in k:
        return "trace"
    if "index_add" in o or "indexfunc" in k:
        return "image_scatter"
    if "sort" in o or "sort" in k:
        return "argsort"
    if op in _GATHER_OPS:
        return "permute_gather" if _pool_width(rows, pool_rows) \
            else "gathers"
    if cat in ("gpu_memcpy", "gpu_memset") or "copy" in k \
            or op in _COPY_OPS:
        return "layout_copies"
    return "other"


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
    return name.startswith(MARK_PREFIX) and \
        name[len(MARK_PREFIX):] in STAGES
