"""readback_upscale_ms: host ms a viewer step in the program's span
`pt.viewer.upscale`: the host's pixel repetition of the preview up to the
full size (tools/interactive.py: ViewerSession.step); the spans' summed time
over the traced drag steps (one `pt.viewer.preview` span a step; _stages.py:
host_span_ms), the steps of readback_traced_ms. Moves
drag_step_ms."""
from portbench.metrics._stages import host_span_ms


def read(run):
    return host_span_ms(run, "pt.viewer.upscale")
