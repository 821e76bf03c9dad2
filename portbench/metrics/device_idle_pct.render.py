"""device_idle_pct.render: 100 x (1 - device busy / window) over the
traced render call (device_busy, a frozen copy of the port's
utils/profiling.py). Moves frame_ms."""
from portbench.metrics._trace import device_busy


def read(run):
    if run.get("loop") != "render" or not run.get("events"):
        return None
    return 100.0 * device_busy(run["events"], run["window"])["idle_share"]
