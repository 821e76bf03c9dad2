"""The stage marks of an integrator's instrumented (`with_stats`) call: the
start of each stage of a regen wave, or of a bounce frame's steps, as the
program's own trace events.

On a CUDA device a mark launches the empty kernel `pt_stage_<stage>`
(csrc/marks.cu) on the current stream, so a capture records it as a node
of the step's graph, in stream order between the stage's kernels, and a
replayed call's trace names the stage its device events belong to. On the
CPU a mark is a zero-length record_function `pt_stage_<stage>` while
torch.profiler records, and nothing otherwise. The integrator owns the
decision to mark (tracer/regen.py: regen_wave and tracer/wavefront.py:
frame_start, bounce_step, frame_end mark their stages and pass their
marker to wavefront.shade_hits); a call without with_stats gets the
marker that does nothing, so its graphs carry no mark. The bounce steps
use the regen wave's stage names: frame_start is marked `respawn`, each
bounce_step runs from `ext_trace` to `end`, frame_end is marked
`scatter`. utils/profiling.py: stage_device_ms splits a trace's device
time by the marks.
"""
from __future__ import annotations

import ctypes

import torch

# the stages of a regen wave in wave order, each running from its mark to
# the next; `medium` (a scene with media) and `bssrdf` (a scene with a
# subsurface material) are marked only where the scene has them; `end`
# closes the wave (tracer/regen.py: regen_wave) or a bounce step
# (tracer/wavefront.py: bounce_step, which marks no `permute`)
STAGES = ("respawn", "ext_trace", "medium", "surface", "material", "shade",
          "bssrdf", "sample_env", "shadow_trace", "permute", "scatter", "end")
MARK_PREFIX = "pt_stage_"


def _kernel():
    from ..utils.cuda_build import load
    lib = load("marks")
    fn = lib.tpt_stage_mark
    if fn.argtypes is None:
        lib.tpt_stage_count.restype = ctypes.c_int
        if lib.tpt_stage_count() != len(STAGES):
            raise RuntimeError("csrc/marks.cu has %d stage marks, STAGES %d"
                               % (lib.tpt_stage_count(), len(STAGES)))
        fn.argtypes = [ctypes.c_int32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stage_mark(stage, device):
    """Mark the start of `stage` (one of STAGES) on `device`: on a CUDA
    device the kernel pt_stage_<stage> on the device's current stream
    (captured into a graph as any launch), elsewhere a zero-length
    record_function pt_stage_<stage> while the profiler records."""
    if device.type == "cuda":
        fn = _kernel()
        with torch.cuda.device(device):
            err = fn(STAGES.index(stage),
                     torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError("stage mark %s: launch failed, CUDA error %d"
                               % (stage, err))
    elif torch.autograd._profiler_enabled():
        with torch.profiler.record_function(MARK_PREFIX + stage):
            pass


def no_mark(stage):
    """The marker of a call without with_stats: marks nothing."""


def stage_marker(on, device):
    """mark(stage): stage_mark on `device` when `on` (an integrator's
    with_stats call), else no_mark."""
    if not on:
        return no_mark
    return lambda stage: stage_mark(stage, device)
