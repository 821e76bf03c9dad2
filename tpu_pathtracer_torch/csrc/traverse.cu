// Per-thread BVH traversal over the packed (K,16) primitive stream.
//
// Replaces: tpu_pathtracer/ops/traverse_packet.py, packet_intersect ->
// _queue_kernel with the fused _make_step (the Pallas TPU packet kernel),
// in its closest-hit form (extension trace; prefix or mask, scalar or
// per-lane tmax) and its any-hit form (NEE shadow trace, mask).
//
// What it computes is what _make_step computes for one lane: the ooeps
// inverse direction, two child slab tests per node row over [tmin, hit_t],
// the Woop unit-triangle test with t > tmin, t < hit_t and the u, v bounds,
// leaf runs that end at the meta "last" flag, the SENTINEL / ~row cursor
// convention of accel/flatten.py, and slot -1, t = tmax for lanes that are
// inactive or past the prefix. The TPU kernel walks a packet of rays behind
// one scalar cursor because the TPU has no per-lane gather; a Hopper thread
// walks its own ray with its own stack (Aila-Laine while-while), so the
// queue claim, the tmax-sign encoding, the SMEM table residency and the
// any-hit early-stop reduction, which schedule work on the TPU, are gone.
// Near-child order uses the thread's own entry distances instead of the
// packet's min-reductions; that can change only which slot wins an exact
// tie. The arithmetic follows tracer/traverse.py:intersect_scene (the plain
// version) term for term; built with --fmad=false it gives the same bits.
//
// What bounds it on an H100: dependent 64-byte row loads (latency) and warp
// divergence, not bandwidth or FLOPs. The stream of the demo scene is
// 5,803 rows = 371 KB, so it sits in the 50 MB L2 after the first touches;
// every step is one row fetch whose address depends on the previous step.
// The design answers with many threads in flight (128-thread blocks, one
// ray per thread, no shared memory) so the SMs hide the load latency, and
// with 16-byte read-only loads (__ldg of four float4 per row). Coherent
// callers (the regen pool is compacted by hit slot and direction octant)
// keep a warp's rows close. The stack lives in local memory (L1-cached).
//
// Step census (kCount): out_steps[i] is the number of loop iterations in
// which the thread's cursor was not SENTINEL, i.e. the rows it fetched; 0
// for inactive lanes and lanes past the prefix. The TPU kernel
// (count_steps=True) stores the PACKET's count on every lane of the packet.
// For a packet of identical rays the two agree exactly in closest hit; in
// any hit the thread stops at its hit while a finished packet still pops
// its remaining node rows, one step per stack entry, so the thread's count
// is <= the packet's, equal where the ray misses. The count costs one
// register and one store, in instantiations of their own: the two
// non-counting ones are unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x76543210;
constexpr int kMaxStack = 64;
constexpr int kBlock = 128;

template <bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kBlock)
traverse_kernel(const float4* __restrict__ table,
                const float* __restrict__ orig,
                const float* __restrict__ dir,
                float tmin, float tmax_scalar,
                const float* __restrict__ tmax_lane,
                int n_prefix, const uint8_t* __restrict__ active,
                int n, int stack_depth,
                int* __restrict__ out_slot, float* __restrict__ out_t,
                int* __restrict__ out_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float hit_t = tmax_lane != nullptr ? tmax_lane[i] : tmax_scalar;
  int hit_slot = -1;
  int steps = 0;
  const bool act = active != nullptr ? active[i] != 0 : i < n_prefix;
  if (act) {
    const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
    const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float ooeps = 0x1p-80f;
    const float sdx = fabsf(dx) > ooeps ? dx : (dx >= 0.0f ? ooeps : -ooeps);
    const float sdy = fabsf(dy) > ooeps ? dy : (dy >= 0.0f ? ooeps : -ooeps);
    const float sdz = fabsf(dz) > ooeps ? dz : (dz >= 0.0f ? ooeps : -ooeps);
    const float idx = 1.0f / sdx, idy = 1.0f / sdy, idz = 1.0f / sdz;
    const float oodx = ox * idx, oody = oy * idy, oodz = oz * idz;

    int stack[kMaxStack];
    int sp = 0;
    int cur = 0;
    while (cur != kSentinel) {
      if (kCount) ++steps;
      const int row = cur >= 0 ? cur : ~cur;
      const float4 r0 = __ldg(table + 4 * row);
      const float4 r1 = __ldg(table + 4 * row + 1);
      const float4 r2 = __ldg(table + 4 * row + 2);
      const float4 r3 = __ldg(table + 4 * row + 3);
      const int m0 = __float_as_int(r3.x);
      const int m1 = __float_as_int(r3.y);
      if (cur >= 0) {
        // node row: [c0.lo.x c0.hi.x c0.lo.y c0.hi.y | c1.lo.x c1.hi.x
        //            c1.lo.y c1.hi.y | c0.lo.z c0.hi.z c1.lo.z c1.hi.z]
        const float c0lox = r0.x * idx - oodx, c0hix = r0.y * idx - oodx;
        const float c0loy = r0.z * idy - oody, c0hiy = r0.w * idy - oody;
        const float c1lox = r1.x * idx - oodx, c1hix = r1.y * idx - oodx;
        const float c1loy = r1.z * idy - oody, c1hiy = r1.w * idy - oody;
        const float c0loz = r2.x * idz - oodz, c0hiz = r2.y * idz - oodz;
        const float c1loz = r2.z * idz - oodz, c1hiz = r2.w * idz - oodz;
        const float c0min = fmaxf(fmaxf(fminf(c0lox, c0hix), fminf(c0loy, c0hiy)),
                                  fmaxf(fminf(c0loz, c0hiz), tmin));
        const float c0max = fminf(fminf(fmaxf(c0lox, c0hix), fmaxf(c0loy, c0hiy)),
                                  fminf(fmaxf(c0loz, c0hiz), hit_t));
        const float c1min = fmaxf(fmaxf(fminf(c1lox, c1hix), fminf(c1loy, c1hiy)),
                                  fmaxf(fminf(c1loz, c1hiz), tmin));
        const float c1max = fminf(fminf(fmaxf(c1lox, c1hix), fmaxf(c1loy, c1hiy)),
                                  fminf(fmaxf(c1loz, c1hiz), hit_t));
        const bool trav0 = c0min <= c0max;
        const bool trav1 = c1min <= c1max;
        if (trav0 && trav1) {
          const bool swap = c1min < c0min;
          if (sp < stack_depth) stack[sp++] = swap ? m0 : m1;
          cur = swap ? m1 : m0;
        } else if (trav0) {
          cur = m0;
        } else if (trav1) {
          cur = m1;
        } else {
          cur = sp > 0 ? stack[--sp] : kSentinel;
        }
      } else {
        // triangle row: Woop matrix rows m0 | m1 | m2
        const float Oz = r0.w - ox * r0.x - oy * r0.y - oz * r0.z;
        const float invDz = 1.0f / (dx * r0.x + dy * r0.y + dz * r0.z);
        const float t = Oz * invDz;
        const float Ox = r1.w + ox * r1.x + oy * r1.y + oz * r1.z;
        const float u = Ox + t * (dx * r1.x + dy * r1.y + dz * r1.z);
        const float Oy = r2.w + ox * r2.x + oy * r2.y + oz * r2.z;
        const float v = Oy + t * (dx * r2.x + dy * r2.y + dz * r2.z);
        const bool hit = t > tmin && t < hit_t && u >= 0.0f && u <= 1.0f &&
                         v >= 0.0f && u + v <= 1.0f;
        if (hit) {
          hit_t = t;
          hit_slot = m0;
          if (kAnyHit) break;
        }
        cur = m1 != 0 ? (sp > 0 ? stack[--sp] : kSentinel) : cur - 1;
      }
    }
  }
  out_slot[i] = hit_slot;
  out_t[i] = hit_t;
  if (kCount) out_steps[i] = steps;
}

template <bool kAnyHit, bool kCount>
void launch(dim3 grid, cudaStream_t s, const void* table,
            const void* orig, const void* dir, float tmin,
            float tmax_scalar, const void* tmax_lane, int n_prefix,
            const void* active, int n, int stack_depth, void* out_slot,
            void* out_t, void* out_steps) {
  traverse_kernel<kAnyHit, kCount><<<grid, kBlock, 0, s>>>(
      static_cast<const float4*>(table), static_cast<const float*>(orig),
      static_cast<const float*>(dir), tmin, tmax_scalar,
      static_cast<const float*>(tmax_lane), n_prefix,
      static_cast<const uint8_t*>(active), n, stack_depth,
      static_cast<int*>(out_slot), static_cast<float*>(out_t),
      static_cast<int*>(out_steps));
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// launch's cudaGetLastError() code (0 on success). tmax_lane and active may
// be null: then tmax_scalar, and the prefix [0, n_prefix), are used.
// out_steps may be null; when it is not, the counting instantiation runs.
extern "C" int tpt_traverse(const void* table, const void* orig,
                            const void* dir, float tmin, float tmax_scalar,
                            const void* tmax_lane, int n_prefix,
                            const void* active, int n, int stack_depth,
                            int anyhit, void* out_slot, void* out_t,
                            void* out_steps, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = void (*)(dim3, cudaStream_t, const void*, const void*,
                         const void*, float, float, const void*, int,
                         const void*, int, int, void*, void*, void*);
  Launch fn;
  if (anyhit) {
    fn = out_steps != nullptr ? &launch<true, true> : &launch<true, false>;
  } else {
    fn = out_steps != nullptr ? &launch<false, true> : &launch<false, false>;
  }
  fn(grid, s, table, orig, dir, tmin, tmax_scalar, tmax_lane, n_prefix,
     active, n, stack_depth, out_slot, out_t, out_steps);
  return static_cast<int>(cudaGetLastError());
}
