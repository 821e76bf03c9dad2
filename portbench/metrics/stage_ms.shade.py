"""stage_ms.shade: device ms a frame of the traced call in the wave stage
`shade`: the BSDF draw (the shade kernel) and what follows it up to the
BSSRDF probes or env NEE. A stage runs from its mark (the program's
pt_stage_shade kernel, launched by the instrumented with_stats call inside
its captured graphs) to the next mark; each device event belongs to the
latest mark before it (_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "shade")
