"""stage_ms.ext_trace: device ms a frame of the traced call in the wave stage
`ext_trace`: the extension trace (a scene with media samples the medium in
the stage `medium` after it). A stage runs from its mark (the program's
pt_stage_ext_trace kernel, launched by the instrumented with_stats call
inside its captured graphs) to the next mark; each device event belongs to
the latest mark before it (_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "ext_trace")
