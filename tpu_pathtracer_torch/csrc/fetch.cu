// The hit-attribute fetch of a path segment, one thread a lane.
//
// Replaces: no TPU kernel. tpu_pathtracer/tracer/wavefront.py:294-314
// (fetch_attributes), a row gather of the (Kt,28) attribute table and the
// barycentric interpolation, which XLA fuses on the TPU. The port's plain
// version (ops/surface_fetch.py: fetch_attributes_plain) is the same code
// in torch: the gather writes an [N,28] intermediate, and some forty
// elementwise kernels, many of them over strided column slices, each take
// a round trip through device memory. This kernel reads a lane's inputs
// and its row once and writes its outputs once:
//   in:  hit_slot [N] int32 (-1 on a miss: row 0 is read, as the plain
//        version's clamp gives), hitpoint [N,3] f32, the (Kt,28) f32
//        table (tracer/wavefront.py: pack_tri_attributes): pos 0:9,
//        uv 9:15, normals 15:24, the material id's int32 bits at 24, the
//        geometric normal 25:28;
//   out: hit_uv [N,2], smooth_n [N,3], mat_id [N] int32 (the bits of
//        column 24), tri_n [N,3] (0 where hit_slot < 0).
//
// What bounds it on an H100: bytes. A lane reads 16 B (slot, hitpoint)
// and writes 36 B; its row is 112 B, but the rows of a scene's table
// (TestObj ~0.5 MB, large_scene ~15 MB) stay in the 50 MB L2, so the
// least the card moves is each row the lanes touch once
// (ops/surface_fetch.py: io_bytes). Its arithmetic (some 60 FP32
// operations and two divisions a lane) is far below the 67 TFLOP/s line.
// The design: one thread a lane, the row in seven 16-byte loads through
// the read-only path (a row is 7 x float4, the table 16-byte aligned, as
// the wrapper checks), the per-lane inputs and outputs coalesced across
// the warp; every lane computes, as the plain version does.
//
// Bits. Built with --fmad=false, the kernel rounds every sum and product
// where a torch kernel of the plain version rounds it, in the same order:
// dot is (x*x + y*y) + z*z, `1.0 - v - w` two subtractions, the
// interpolation ((u*a + v*b) + w*c), tensor / tensor an IEEE division,
// and a Python constant rounded to float before it meets a tensor.
// The row's interpolation is csrc/surface.cuh: fetch_row, which
// csrc/bssrdf.cu's probe loop shares.
// Plain PyTorch version: ops/surface_fetch.py, fetch_attributes_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surface.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    fetch_attributes_kernel(int64_t n, const int32_t* __restrict__ hit_slot,
                            const float* __restrict__ hitpoint,
                            const float4* __restrict__ table,
                            float2* __restrict__ hit_uv,
                            float* __restrict__ smooth_n,
                            int32_t* __restrict__ mat_id,
                            float* __restrict__ tri_n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const Attributes a = fetch_row(table, hit_slot[i], load3(hitpoint + 3 * i));
  hit_uv[i] = a.uv;
  store3(smooth_n + 3 * i, a.smooth_n);
  mat_id[i] = a.mat_id;
  store3(tri_n + 3 * i, a.tri_n);
}

}  // namespace

// n_lanes lanes; hit_slot [n] int32, hitpoint [n,3] f32, table (rows,28)
// f32 with a 16-byte aligned base, all contiguous; outputs hit_uv [n,2],
// smooth_n [n,3], mat_id [n] int32, tri_n [n,3], contiguous. Launch on
// `stream`; return cudaGetLastError() (0 on success).
extern "C" int tpt_fetch_attributes(int64_t n_lanes, const void* hit_slot,
                                    const void* hitpoint, const void* table,
                                    void* hit_uv, void* smooth_n,
                                    void* mat_id, void* tri_n,
                                    void* stream) {
  if (n_lanes <= 0) return 0;
  const int64_t grid = (n_lanes + kBlock - 1) / kBlock;
  fetch_attributes_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n_lanes, static_cast<const int32_t*>(hit_slot),
      static_cast<const float*>(hitpoint),
      static_cast<const float4*>(table), static_cast<float2*>(hit_uv),
      static_cast<float*>(smooth_n), static_cast<int32_t*>(mat_id),
      static_cast<float*>(tri_n));
  return static_cast<int>(cudaGetLastError());
}
