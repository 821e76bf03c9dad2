"""stage_ms.shadow_trace: device ms a frame of the traced call in the wave
stage `shadow_trace`: the any-hit shadow traces, NEE's and the distant
light's, and the path bookkeeping after them up to the permute. A stage runs
from its mark (the program's pt_stage_shadow_trace kernel, launched by the
instrumented with_stats call inside its captured graphs) to the next mark;
each device event belongs to the latest mark before it (_stages.py). Moves
frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "shadow_trace")
