"""preview_span_ms: host ms a viewer step in the program's span
`pt.viewer.preview`, around the preview's render_frames
(tools/interactive.py: ViewerSession.step); the spans' summed time over
the traced drag steps (one such span a step; _stages.py: host_span_ms).
In the traced run the preview Renderer's render_frames is the benchmark's
wrapped one, which ends in a synchronize, so the span holds the preview's
device time as preview_render_ms does, but over the traced steps alone,
under the profiler; in the program alone no synchronize closes it, and
the preview's device tail falls into the next span, `pt.image.copy`, whose
.cpu() waits for it. Moves drag_step_ms."""
from portbench.metrics._stages import host_span_ms


def read(run):
    return host_span_ms(run, "pt.viewer.preview")
