"""stage_ms.respawn: device ms a frame of the traced call in the wave stage
`respawn`: the respawn (tracer/regen.py: regen_wave, from its start to the
extension trace). A stage runs from its mark (the program's pt_stage_respawn
kernel, launched by the instrumented with_stats call inside its captured
graphs) to the next mark; each device event belongs to the latest mark
before it (_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "respawn")
