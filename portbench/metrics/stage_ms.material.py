"""stage_ms.material: device ms a frame of the traced call in the wave stage
`material`: gather_material, the normals and the emission
(tracer/wavefront.py: shade_hits, up to the BSDF draw). A stage runs from
its mark (the program's pt_stage_material kernel, launched by the
instrumented with_stats call inside its captured graphs) to the next mark;
each device event belongs to the latest mark before it (_stages.py). Moves
frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "material")
