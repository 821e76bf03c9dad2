"""bssrdf_lanes_per_frame: the lanes that entered the BSSRDF probe loop
over every wave of the traced call (the program's counter `bssrdf_lanes`,
RegenIntegrator.last_counters of a with_stats call on a scene with a
subsurface material), over the call's frames: how much of the pool the
probe segment engages. None where the program publishes no such counter.
Moves frame_ms."""


def read(run):
    n = (run.get("counters") or {}).get("bssrdf_lanes")
    if run.get("loop") != "render" or n is None or not run.get("frames"):
        return None
    return float(n) / run["frames"]
