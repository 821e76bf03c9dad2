"""gather_copy_ms_per_frame: device ms a frame of the traced call in row
gathers (kernels named `*gather*`, such as vectorized_gather_kernel) and
in the layout copies (the `layout_copies` bucket of categorize, a frozen
copy of the port's utils/profiling.py: copies, CatArrayBatchedCopy,
memcpy, memset). Under CUDA graphs a kernel reaches the trace without its
launching op, so the kernel's name decides. Moves frame_ms."""
from portbench.metrics._trace import bucket, collect_device_ops


def read(run):
    if run.get("loop") != "render" or not run.get("events") \
            or not run.get("frames"):
        return None
    dur, _, meta = collect_device_ops(run["events"], window=run["window"])
    us = 0.0
    for key, d in dur.items():
        cat, op, kernel, rows = meta[key]
        if "gather" in kernel.lower() or \
                bucket(cat, op, kernel, rows) == "layout_copies":
            us += d
    return us / 1e3 / run["frames"]
