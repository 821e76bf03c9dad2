"""stage_ms.surface: device ms a frame of the traced call in the wave stage
`surface`: the attribute fetch and the env / texture quad lookup. A stage
runs from its mark (the program's pt_stage_surface kernel, launched by the
instrumented with_stats call inside its captured graphs) to the next mark;
each device event belongs to the latest mark before it (_stages.py). Moves
frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "surface")
