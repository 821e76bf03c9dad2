"""readback_copy_ms: host ms a viewer step in the program's span
`pt.image.copy`: the device tonemap and the uint8 copy to the host
(tracer/renderer.py: Renderer.accum_to_image); the spans' summed time over
the traced drag steps (one `pt.viewer.preview` span a step; _stages.py:
host_span_ms), the steps of readback_traced_ms. Moves
drag_step_ms."""
from portbench.metrics._stages import host_span_ms


def read(run):
    return host_span_ms(run, "pt.image.copy")
