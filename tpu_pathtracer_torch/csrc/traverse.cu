// BVH traversal over the packed (K,16) primitive stream, one ray per thread.
//
// Replaces: tpu_pathtracer/ops/traverse_packet.py, packet_intersect ->
// _queue_kernel with the fused _make_step (the Pallas TPU packet kernel),
// in its closest-hit form (extension trace; prefix or mask, scalar or
// per-lane tmax) and its any-hit form (NEE shadow trace, mask), each with
// or without the step count.
//
// What it computes is what _make_step computes for one lane: the ooeps
// inverse direction, two child slab tests per node row over [tmin, hit_t]
// with the near child first (`c1min < c0min` swaps), the Woop unit-triangle
// test with t > tmin, t < hit_t and the u, v bounds, leaf runs that end at
// the meta "last" flag, the SENTINEL / ~row cursor convention of
// accel/flatten.py, pushes dropped past stack_depth, and slot -1, t = tmax
// for lanes that are inactive or past the prefix.
//
// The prefix comes as a launch argument or, as the Pallas kernel takes it
// by scalar prefetch (a traced int32, traverse_packet.py:778, 850-856),
// from device memory: with n_prefix_dev set every thread reads the count
// there, so a launch captured in a CUDA graph follows a prefix that the
// previous kernels of the graph computed. The grid stays sized by n. The arithmetic follows
// tracer/traverse.py:intersect_scene (the plain version) term for term;
// built with --fmad=false every lane gives its bits.
//
// What bounds it on an H100. Not bytes (a 1M-ray trace moves ~34 MB, 10 us
// at 3.35 TB/s) and not the FP32 rate: a step is one dependent 64-byte row
// fetch and 60-70 instructions (node ~65, triangle ~55), held by the
// issue rate and the load/store unit (a warp-step's row loads cost as
// many L1 wavefronts as its lanes walk rows apart) and by latency below
// ~48 warps an SM. So the time is the warp-steps paid
// (a warp runs until its slowest lane is done: +80% over the live steps on
// the mid-frame pool, +18% on camera rays) times the cost of a warp-step,
// and that cost is lowest when a warp's lanes walk the same rows and the
// same kind of row together.
//
// The design keeps exactly that: one ray per thread in 128-thread blocks,
// so a warp walks 32 consecutive rays of a compacted (coherent) pool in
// lockstep, at 40 registers and 48 warps an SM, with a 66-entry stack in
// local memory (the builders cap a tree at 64 levels, accel/bvh.py
// MAX_DEPTH, and the Renderer asks for depth + 2). Measured on the card and left out because each made the
// kernel slower (PERF.md gives the numbers): persistent warps with dynamic
// ray fetch (Aila & Laine 2009), alone or with while-while passes, a
// prefetched next batch or a refill threshold; a shared-memory stack; a
// compile-time stack of 16/32/64 entries chosen from stack_depth; and
// parking each warp's last lanes for a second, dense kernel. The
// persistent and parking designs cut the warp-steps paid (the pool's +80%
// to +21-39%) but mixed rays and phases in a warp-step or cost occupancy,
// and a warp-step then cost more than the steps saved.
//
// Table residency (kTable). Replaces the table_mem choice of the TPU kernel
// (_smem_fetch / _vmem_fetch and the split table of _make_step,
// traverse_packet.py:101-149): there "smem" keeps the whole table in scalar
// memory and "split" its BFS-ordered hot prefix, the rest coming from VMEM
// with one branch a step. Here the kTable instantiations keep the first
// table_rows rows of the stream (accel/flatten.py puts the node rows first,
// in breadth-first order, so the prefix is the top of the tree) in dynamic
// shared memory, and a step reads row < table_rows from there and any other
// row through __ldg, as the plain instantiations read every row. The walk
// is the same function (trace_ray), so slot, t and steps are the same bits.
// What it costs: the copy (64 bytes a row, once per block, from L2), shared
// memory that L1 loses (L1 also holds the local-memory stacks and the
// triangle rows), and a compare and a branch on the dependent fetch of
// every step. The kernel keeps the plain kernel's shape, 128-thread blocks,
// 12 an SM, one ray per thread, and adds the copy as a prologue; at most
// kTableMaxRows = 288 rows fit (12 x 19 KB are the SM's 228 KB), and the
// wrapper's plan asks for fewer. Measured on the card (PERF.md, row 6 of
// the kernel table): slower than the plain kernel at every table size on
// every stream, +11% with 8 rows (the branch alone), +18% with 128, +35%
// with 288; 768-thread blocks holding 1,792 rows, two an SM, persistent or
// not, were +37-55% (a block that large holds its SM share until its
// slowest warp ends). L1 already serves the top of the tree. A warp is the
// same 32 consecutive rays in both residencies, so the warp-step count is
// the same too. The rows lie in shared memory as four planes of float4
// (plane q holds words 4q..4q+3 of every row), so lanes that walk
// different rows spread over the banks.
//
// Step census (kCount): out_steps[i] is the number of rows ray i fetched
// (0 for inactive lanes and lanes past the prefix). The TPU kernel
// (count_steps=True) stores the PACKET's count on every lane of the packet:
// for a packet of identical rays the two agree in closest hit; in any hit
// the thread stops at its hit while a finished packet still pops its node
// rows, so the thread's count is <= the packet's, equal where the ray
// misses. Besides, each block adds its warps' passes (a warp's pass count
// is the most steps of its lanes) to the one counter *warp_steps with one
// atomicAdd: 32 x that sum is the thread-steps the card paid. The count
// lives in instantiations of its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x76543210;
constexpr int kBlock = 128;
constexpr int kMaxStack = 66;
// 12 blocks of 4 warps an SM: holds the kernel to 40 registers (without
// it the counting word and the whole-warp exit take 42-47, which leaves
// 40 warps an SM and was 1-3% slower on the card)
constexpr int kMinBlocks = 12;
// the kTable instantiations keep up to kTableMaxRows rows of 64 bytes in
// each block's shared memory: 12 blocks x (18 KB + 1 KB the system keeps)
// are the SM's 228 KB
constexpr int kTableMaxRows = 288;

struct Rays {
  const float4* table;
  const float* orig;
  const float* dir;
  float tmin, tmax_scalar;
  const float* tmax_lane;
  int n_prefix;
  const int* n_prefix_dev;
  const uint8_t* active;
  int n, stack_depth;
  int* out_slot;
  float* out_t;
  int* out_steps;
};

// Walks ray i (i < r.n) and writes its outputs; returns the rows it
// fetched. s_table: the first table_rows rows, as four planes (kTable).
template <bool kAnyHit, bool kCount, bool kTable>
__device__ __forceinline__ int trace_ray(const Rays& r, int i,
                                         const float4* s_table,
                                         int table_rows) {
  const float4* __restrict__ table = r.table;
  const float tmin = r.tmin;
  const int stack_depth = r.stack_depth;
  int steps = 0;
  float hit_t = r.tmax_lane != nullptr ? r.tmax_lane[i] : r.tmax_scalar;
  int hit_slot = -1;
  const bool act =
      r.active != nullptr
          ? r.active[i] != 0
          : i < (r.n_prefix_dev != nullptr ? __ldg(r.n_prefix_dev)
                                           : r.n_prefix);
  if (act) {
    const float ox = r.orig[3 * i], oy = r.orig[3 * i + 1],
                oz = r.orig[3 * i + 2];
    const float dx = r.dir[3 * i], dy = r.dir[3 * i + 1],
                dz = r.dir[3 * i + 2];
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
      float4 r0, r1, r2, r3;
      if (kTable && row < table_rows) {
        r0 = s_table[row];
        r1 = s_table[table_rows + row];
        r2 = s_table[2 * table_rows + row];
        r3 = s_table[3 * table_rows + row];
      } else {
        r0 = __ldg(table + 4 * row);
        r1 = __ldg(table + 4 * row + 1);
        r2 = __ldg(table + 4 * row + 2);
        r3 = __ldg(table + 4 * row + 3);
      }
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
  r.out_slot[i] = hit_slot;
  r.out_t[i] = hit_t;
  if (kCount) r.out_steps[i] = steps;
  return steps;
}

// A warp's passes over one chunk are the most steps of its lanes (every
// thread of the warp calls this).
__device__ __forceinline__ unsigned warp_passes(int steps) {
  return __reduce_max_sync(0xffffffffu, static_cast<unsigned>(steps));
}

// Every thread of the block calls this once, lane 0 of each warp with its
// warp's passes: the block adds them to *warp_steps with one atomic.
template <int kThreads>
__device__ __forceinline__ void add_block_passes(
    unsigned passes, unsigned long long* warp_steps) {
  __shared__ unsigned s_passes[kThreads / 32];
  if ((threadIdx.x & 31u) == 0) s_passes[threadIdx.x / 32] = passes;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_passes[w];
    if (sum > 0) atomicAdd(warp_steps, sum);
  }
}

// One thread per lane, ceil(n / kBlock) blocks. kTable: the block first
// copies the first table_rows rows into shared memory.
template <bool kAnyHit, bool kCount, bool kTable>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
traverse_kernel(const Rays r, int table_rows,
                unsigned long long* __restrict__ warp_steps) {
  extern __shared__ float4 s_table[];
  if constexpr (kTable) {
    // float4 j of the stream is word group j & 3 of row j >> 2
    for (int j = threadIdx.x; j < 4 * table_rows; j += kBlock)
      s_table[(j & 3) * table_rows + (j >> 2)] = __ldg(r.table + j);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int steps =
      i < r.n ? trace_ray<kAnyHit, kCount, kTable>(r, i, s_table, table_rows)
              : 0;
  if constexpr (kCount)
    add_block_passes<kBlock>(warp_passes(steps), warp_steps);
}

template <bool kAnyHit, bool kCount>
int launch(cudaStream_t s, const Rays& r, int table_rows,
           unsigned long long* warp_steps) {
  const int blocks = (r.n + kBlock - 1) / kBlock;
  if (table_rows == 0) {
    traverse_kernel<kAnyHit, kCount, false>
        <<<blocks, kBlock, 0, s>>>(r, 0, warp_steps);
  } else {
    traverse_kernel<kAnyHit, kCount, true>
        <<<blocks, kBlock, static_cast<size_t>(table_rows) * 64, s>>>(
            r, table_rows, warp_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// launch's error code (0 on success; a refused launch returns its code
// here). tmax_lane and active may be null: then tmax_scalar, and the prefix
// [0, n_prefix), are used; n_prefix_dev, when not null, holds the prefix
// (one int32 in device memory, read by the kernel) in place of n_prefix. out_steps may be null; when it is not, the
// counting instantiation runs, and its warp-steps go to *warp_steps (one
// 8-byte word, zeroed here on the stream). table_rows = 0 launches the
// kernel that reads every row through __ldg; table_rows in
// [1, kTableMaxRows] (and <= the rows of `table`, which the caller holds)
// launches the kTable instantiation with that many rows in shared memory
// (18 KB at most: under the 48 KB a launch may use without asking).
extern "C" int tpt_traverse(const void* table, const void* orig,
                            const void* dir, float tmin, float tmax_scalar,
                            const void* tmax_lane, int n_prefix,
                            const void* n_prefix_dev, const void* active, int n, int stack_depth,
                            int anyhit, int table_rows, void* out_slot,
                            void* out_t, void* out_steps, void* warp_steps,
                            void* stream) {
  const bool count = out_steps != nullptr;
  if (stack_depth < 1 || stack_depth > kMaxStack || n < 1 ||
      table_rows < 0 || table_rows > kTableMaxRows ||
      (count && warp_steps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rays r{static_cast<const float4*>(table),
               static_cast<const float*>(orig),
               static_cast<const float*>(dir),
               tmin,
               tmax_scalar,
               static_cast<const float*>(tmax_lane),
               n_prefix,
               static_cast<const int*>(n_prefix_dev),
               static_cast<const uint8_t*>(active),
               n,
               stack_depth,
               static_cast<int*>(out_slot),
               static_cast<float*>(out_t),
               static_cast<int*>(out_steps)};
  const auto fn = anyhit ? (count ? &launch<true, true> : &launch<true, false>)
                         : (count ? &launch<false, true>
                                  : &launch<false, false>);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count) {
    const cudaError_t e = cudaMemsetAsync(
        warp_steps, 0, sizeof(unsigned long long), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return fn(s, r, table_rows, static_cast<unsigned long long*>(warp_steps));
}
