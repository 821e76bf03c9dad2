"""stage_ms.bssrdf: device ms a frame of the traced call in the wave stage
`bssrdf`: the BSSRDF probe segment (tracer/bssrdf_shade.py: bssrdf_scatter;
scenes with subsurface materials only). A stage runs from its mark (the
program's pt_stage_bssrdf kernel, launched by the instrumented with_stats
call inside its captured graphs) to the next mark; each device event belongs
to the latest mark before it (_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "bssrdf")
