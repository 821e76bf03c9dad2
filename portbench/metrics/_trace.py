"""The arithmetic the per-layer readers apply to a torch.profiler chrome
trace. `load_events`, `device_busy`, `collect_device_ops`, `categorize`
and `bucket` (with their helpers) are frozen copies of
`tpu_pathtracer_torch/utils/profiling.py` at commit 6acb8e4, unchanged
but for the docstrings; `device_ops_top` and `idle_gaps_top` are the
benchmark's own, for a run's breakdown."""
from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather",
               "aten::take")
_COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::cat",
             "aten::to", "aten::_to_copy", "aten::stack")
CATEGORIES = ("trace", "image_scatter", "argsort", "permute_gather",
              "gathers", "layout_copies", "other")


def load_events(trace):
    if isinstance(trace, list):
        return trace
    with open(trace) as f:
        return json.load(f)["traceEvents"]


def _table_rows(op, dims):
    if op not in _GATHER_OPS or not dims or not dims[0]:
        return 0
    first = dims[0]
    if first and isinstance(first[0], list):
        first = first[0]
    return max(first) if first else 0


def _pool_width(rows, pool_rows):
    return bool(pool_rows) and rows >= pool_rows // 2


def _key(name, op, rows, pool_rows):
    key = "%s | %s" % (op or "-", name)
    if op in _GATHER_OPS and pool_rows:
        key += " [pool-width]" if _pool_width(rows, pool_rows) else " [table]"
    return key


def _span(events, window):
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
    """(dur_us Counter, count Counter, meta {key: (cat, op, kernel, rows)})
    of the device events that start inside the record_function `window`."""
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


def device_busy(trace, window=None):
    """{window_ms, busy_ms, idle_share, events}: the union of the device
    intervals inside the record_function `window`."""
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


def categorize(ops, meta, pool_rows=None):
    buckets = collections.Counter({c: 0.0 for c in CATEGORIES})
    for key, ms in ops.items():
        cat, op, kernel, rows = meta.get(key, ("", "", key, 0))
        buckets[bucket(cat, op, kernel, rows, pool_rows)] += ms
    return dict(buckets)


def bucket(cat, op, kernel, rows=0, pool_rows=None):
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


# ---- the benchmark's own ----

def device_ops_top(trace, window, n=10):
    """[[bucket: kernel, seconds], ...]: the n device operations of the
    window that took most time, by kernel name, each with its bucket."""
    dur, _, meta = collect_device_ops(trace, window=window)
    by = collections.Counter()
    for key, us in dur.items():
        cat, op, kernel, rows = meta[key]
        by["%s: %s" % (bucket(cat, op, kernel, rows), kernel[:96])] += us
    return [[k, us / 1e6] for k, us in by.most_common(n)]


def idle_gaps_top(trace, window, n=10):
    """[[host op, seconds], ...]: the device's idle time inside the window
    by what the host was doing in the middle of each gap: the innermost
    host op or annotation open then, or, where none is, "after <op>" of
    the last one that had ended; the n largest sums."""
    events = load_events(trace)
    w0, w1 = _span(events, window)
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                 and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0)
    gaps, end = [], w0
    for s, t in dev:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "user_annotation",
                                        "python_function", "cuda_runtime",
                                        "cuda_driver")
                   and e.get("name") != window),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    by = collections.Counter()
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        name, last = None, None
        # the latest-started host event still open at mid is the innermost
        for j in range(i - 1, max(i - 5000, 0) - 1, -1):
            if host[j][1] > mid:
                name = host[j][2]
                break
            if last is None or host[j][1] > last[0]:
                last = (host[j][1], host[j][2])
        if name is None:
            name = "after " + last[1] if last else "(no host op)"
        by[name] += g1 - g0
    return [[k, us / 1e6] for k, us in by.most_common(n)]
