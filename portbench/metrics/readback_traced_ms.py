"""readback_traced_ms: readback_ms over the traced drag steps alone: host
ms of the viewer step from the end of its preview render (synchronized) to
its uint8 full-size image in host memory, from the benchmark's own spans
(as readback_ms), the mean over the run's last steps, those that the
profile recorded (one program span `pt.viewer.preview` a step;
_stages.py: traced_steps). The steps that readback_copy_ms and
readback_unswizzle_ms split, under the same profiler: their sum is to be
compared with this, not with readback_ms,
which averages every step of the run. None where the trace holds no
program span to count the steps by. Moves drag_step_ms."""
from portbench.metrics._stages import traced_steps


def read(run):
    spans = run.get("spans", {})
    render, step = spans.get("render"), spans.get("step")
    k = traced_steps(run)
    if not k or not render or not step or len(render) != len(step) \
            or k > len(step):
        return None
    return 1e3 * sum(s1 - r1 for (_, r1), (_, s1)
                     in zip(render[-k:], step[-k:])) / k
