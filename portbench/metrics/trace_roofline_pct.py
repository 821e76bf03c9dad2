"""trace_roofline_pct: the traversal kernels' share of their byte bound
over the traced call: the bound (_roofline.py, a frozen copy of
chip_smoke.py's traversal bytes) over the device time of the kernels
named traverse_kernel, in percent. The rays are the program's counter of
traced rays (render_frames with_stats); the launches are the traversal
kernels in the trace. Bound at 3.35 TB/s, an H100 SXM at 700 W; the card's
power limit is printed beside the run's result. Moves frame_ms."""
from portbench.metrics._roofline import traversal_bound_s
from portbench.metrics._trace import collect_device_ops


def read(run):
    if run.get("loop") != "render" or not run.get("events") \
            or not run.get("rays"):
        return None
    dur, cnt, meta = collect_device_ops(run["events"], window=run["window"])
    us = launches = 0
    for key, d in dur.items():
        if "traverse_kernel" in meta[key][2]:
            us += d
            launches += cnt[key]
    if not us:
        return None
    bound = traversal_bound_s(run["rays"], launches, run["stream_rows"])
    return 100.0 * bound / (us / 1e6)
