"""stage_ms.sample_env: device ms a frame of the traced call in the wave stage
`sample_env`: the env NEE draw (tracer/envsample.py: sample_env) and its
candidates. A stage runs from its mark (the program's pt_stage_sample_env
kernel, launched by the instrumented with_stats call inside its captured
graphs) to the next mark; each device event belongs to the latest mark
before it (_stages.py). Moves frame_ms."""
from portbench.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "sample_env")
