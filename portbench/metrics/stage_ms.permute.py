"""stage_ms.permute: device ms a frame of the traced call in the wave stage
`permute`: the compaction permute (tracer/regen.py: _compact: the key, the
argsort and one pool_gather_kernel, which moves the survivors' columns
straight into the pool). A stage runs from its mark (the program's
pt_stage_permute kernel, launched by the instrumented with_stats call
inside its captured graphs) to the next mark; each device event belongs to
the latest mark before it (_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "permute")
