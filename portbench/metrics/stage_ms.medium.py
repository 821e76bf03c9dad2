"""stage_ms.medium: device ms a frame of the traced call in the wave stage
`medium`, which a scene with media marks between the closest-hit trace
(`ext_trace`) and `surface`: the distance sampling, the transmittance, the
Henyey-Greenstein direction, the scatter budget and the miss mask
(tracer/medium.py: medium_interaction and what follows it in the wave). A
stage runs from its mark (the program's pt_stage_medium kernel, launched
by the instrumented with_stats call inside its captured graphs) to the
next mark; each device event belongs to the latest mark before it
(_stages.py). None where the trace holds no such mark. Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "medium")
