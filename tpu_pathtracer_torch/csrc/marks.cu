// Stage marks of the instrumented regen wave: one empty kernel a stage.
//
// Replaces: no TPU kernel and no plain version; a mark computes nothing.
// Under CUDA graphs a replayed kernel reaches torch.profiler's trace
// without the aten op that launched it, so the trace cannot say which
// stage of the wave a row gather or a copy belongs to. The regen
// integrator's with_stats call launches `pt_stage_<stage>` on the current
// stream at the start of each stage (ops/marks.py: stage_mark, called
// from tracer/regen.py and from the shade_hits it passes its marker), so a
// capture records it as a node of the graph, in stream order between the
// stage's kernels. utils/profiling.py: stage_device_ms gives each device
// event to the latest mark that started before it.
//
// What a mark costs: one launch of one thread that does nothing, about a
// microsecond of device time; the graphs of calls without with_stats
// carry none.
//
// The kernels are extern "C", so the trace names them `pt_stage_<stage>`
// as they are written here, in wave order: respawn, ext_trace, medium (a
// scene with media), surface, material, shade, bssrdf (a scene with a
// subsurface material), sample_env, shadow_trace, permute, scatter, end. The order of kStages is the order of
// ops/marks.py: STAGES, whose index tpt_stage_mark takes.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" __global__ void pt_stage_respawn() {}
extern "C" __global__ void pt_stage_ext_trace() {}
extern "C" __global__ void pt_stage_medium() {}
extern "C" __global__ void pt_stage_surface() {}
extern "C" __global__ void pt_stage_material() {}
extern "C" __global__ void pt_stage_shade() {}
extern "C" __global__ void pt_stage_bssrdf() {}
extern "C" __global__ void pt_stage_sample_env() {}
extern "C" __global__ void pt_stage_shadow_trace() {}
extern "C" __global__ void pt_stage_permute() {}
extern "C" __global__ void pt_stage_scatter() {}
extern "C" __global__ void pt_stage_end() {}

namespace {

typedef void (*Mark)();
const Mark kStages[] = {
    pt_stage_respawn,    pt_stage_ext_trace,    pt_stage_medium,
    pt_stage_surface,    pt_stage_material,     pt_stage_shade,
    pt_stage_bssrdf,     pt_stage_sample_env,   pt_stage_shadow_trace,
    pt_stage_permute,    pt_stage_scatter,      pt_stage_end,
};
constexpr int kNumStages = sizeof(kStages) / sizeof(kStages[0]);

}  // namespace

// The number of marks, for the wrapper's check of its stage table.
extern "C" int tpt_stage_count() { return kNumStages; }

// Launch the mark of stage `stage` (an index of kStages) on `stream`;
// returns the launch's CUDA error (0 on success), or -1 for an index out
// of range.
extern "C" int tpt_stage_mark(int32_t stage, void* stream) {
  if (stage < 0 || stage >= kNumStages) return -1;
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kStages[stage]), dim3(1), dim3(1),
      nullptr, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
