"""readback_ms: host ms of the viewer step from the end of its preview
render (synchronized) to its uint8 full-size image in host memory: the
device tonemap, the un-swizzle and the pixel repetition up to the full
size, and the uint8 readback (Renderer.accum_to_image and the step's
image); the mean over the traced run's drag steps. Moves drag_step_ms."""


def read(run):
    spans = run.get("spans", {})
    render, step = spans.get("render"), spans.get("step")
    if not render or not step or len(render) != len(step):
        return None
    return 1e3 * sum(s1 - r1 for (_, r1), (_, s1) in zip(render, step)) \
        / len(step)
