"""device_idle_pct.drag: 100 x (1 - device busy / window) over the traced
drag steps (device_busy, a frozen copy of the port's utils/profiling.py).
Moves drag_step_ms."""
from portbench.metrics._trace import device_busy


def read(run):
    if run.get("loop") != "drag" or not run.get("events"):
        return None
    return 100.0 * device_busy(run["events"], run["window"])["idle_share"]
