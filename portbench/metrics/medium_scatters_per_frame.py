"""medium_scatters_per_frame: the lanes that scattered in a medium over
every wave of the traced call (the program's counter `medium_scatters`,
RegenIntegrator.last_counters of a with_stats call on a scene with media),
over the call's frames. None where the program publishes no such counter.
Moves frame_ms."""


def read(run):
    n = (run.get("counters") or {}).get("medium_scatters")
    if run.get("loop") != "render" or n is None or not run.get("frames"):
        return None
    return float(n) / run["frames"]
