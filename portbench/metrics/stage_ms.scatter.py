"""stage_ms.scatter: device ms a frame of the traced call in the wave stage
`scatter`: the dead-row flush into the image (index_add_) and the wave's
status. A stage runs from its mark (the program's pt_stage_scatter kernel,
launched by the instrumented with_stats call inside its captured graphs) to
the next mark; each device event belongs to the latest mark before it
(_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "scatter")
