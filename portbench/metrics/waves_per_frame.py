"""waves_per_frame: the regen waves of the traced call, at every drain
width (RegenIntegrator.last_waves, the program's counter, over-run waves
included), over the call's frames; on a bounce configuration's trace the
bounce steps the call launched (BounceIntegrator.last_launched, the no-op
steps after a frame's end included) over its frames. Moves frame_ms."""


def read(run):
    waves = run.get("waves")
    if run.get("loop") != "render" or not waves or not run.get("frames"):
        return None
    return float(sum(waves.values())) / run["frames"]
