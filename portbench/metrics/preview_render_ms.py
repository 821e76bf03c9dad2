"""preview_render_ms: host ms of the viewer step's preview render, a span
the benchmark puts around the preview Renderer's render_frames, ending in
a synchronize; the mean over the traced run's drag steps. Moves
drag_step_ms."""


def read(run):
    spans = run.get("spans", {}).get("render")
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / len(spans)
