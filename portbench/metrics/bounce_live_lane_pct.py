"""bounce_live_lane_pct: the share of the bounce integrator's masked lane
steps that do live work, in percent: the lanes live at the start of each
step of the traced call (the program's counter `bounce_live_lanes`,
BounceIntegrator.last_counters of a with_stats call), over the lanes a
step covers times the steps the call launched (`waves`, {lanes: launched
steps}, the no-op steps after a frame's end among them). None where the
program publishes no such counter or the call counted no step. It falls
only where a change launches steps that no path needs. Moves frame_ms."""


def read(run):
    n = (run.get("counters") or {}).get("bounce_live_lanes")
    waves = run.get("waves")
    if run.get("loop") != "render" or n is None or not waves:
        return None
    steps = sum(int(lanes) * int(k) for lanes, k in waves.items())
    if not steps:
        return None
    return 100.0 * float(n) / steps
