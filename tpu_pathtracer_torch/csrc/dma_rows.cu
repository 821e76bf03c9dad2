// Row gather and row scatter of an f32 table by int32 indices.
//
// Replaces: tools/probe_dma.py, make_dma_gather (the Pallas TPU kernel that
// keeps a window of row DMAs in flight, HBM -> VMEM, one descriptor per
// row or per run of `batch` rows) and make_dma_scatter (the same window of
// row DMAs in the store direction). What they compute:
//   gather:  out[j] = tab[src(j)],  src(j) = idx[(j / G) * G] + j % G
//            (G = batch; G = 1 is the plain per-row gather);
//   scatter: out[idx[j]] = tab[j]   (a permutation write; rows that no
//            index names are left as they were, duplicates are undefined).
// The TPU's chunk / window / semaphore schedule has no counterpart: a
// Hopper SM keeps many loads in flight by running many threads.
//
// What bounds it on an H100: bytes. Each output row is read once and
// written once, plus one 4-byte index per row (per run for G > 1). At
// (1,048,576 x 16) f32 that is 64 MiB + 4 MiB + 64 MiB = 138.4 MB, >= 41.3 us
// at 3.35 TB/s; at (1,048,576 x 128) f32 it is 1,077.9 MB, >= 321.8 us. The
// design: a group of threads copies one row with 16-byte float4 loads and
// stores, so a warp moves whole 64-byte (C=16: 8 rows per warp, 4 threads
// a row) or 512-byte (C=128: one row per warp) spans; the random row order
// costs a DRAM page per row, which is what the probe measures. The scalar
// path takes C % 4 != 0 or a table that is not 16-byte aligned. Offsets are
// computed in 64 bits. Plain PyTorch version: ops/dma_rows.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// One group of `group` threads per row; each thread copies elements
// lane, lane + group, ... of the row (float4 elements when kVec).
template <bool kScatter, bool kVec>
__global__ void __launch_bounds__(kBlock)
rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
            float* __restrict__ out, int64_t n_rows, int n_cols, int group,
            int batch) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t j = t / group;
  const int lane = static_cast<int>(t % group);
  if (j >= n_rows) return;
  int64_t src, dst;
  if (kScatter) {
    src = j;
    dst = idx[j];
  } else {
    src = static_cast<int64_t>(idx[(j / batch) * batch]) + j % batch;
    dst = j;
  }
  if (kVec) {
    const int n4 = n_cols / 4;
    const float4* s = reinterpret_cast<const float4*>(tab) + src * n4;
    float4* d = reinterpret_cast<float4*>(out) + dst * n4;
    for (int c = lane; c < n4; c += group) d[c] = __ldg(s + c);
  } else {
    const float* s = tab + src * n_cols;
    float* d = out + dst * n_cols;
    for (int c = lane; c < n_cols; c += group) d[c] = __ldg(s + c);
  }
}

template <bool kScatter>
void launch(const float* tab, const int* idx, float* out, int64_t n_rows,
            int n_cols, int batch, cudaStream_t s) {
  const bool vec = n_cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vec ? n_cols / 4 : n_cols;
  int group = 1;
  while (group < per_row && group < 32) group *= 2;
  const int64_t threads = n_rows * group;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  if (vec) {
    rows_kernel<kScatter, true><<<grid, kBlock, 0, s>>>(
        tab, idx, out, n_rows, n_cols, group, batch);
  } else {
    rows_kernel<kScatter, false><<<grid, kBlock, 0, s>>>(
        tab, idx, out, n_rows, n_cols, group, batch);
  }
}

}  // namespace

// Plain C entry points for ctypes. tab and out are (n_rows, n_cols) f32,
// idx is (n_rows,) int32, all checked by the wrapper (ops/dma_rows.py),
// indices included. Launch on `stream`; return cudaGetLastError() (0 on
// success).
extern "C" int tpt_gather_rows(const void* tab, const void* idx, void* out,
                               int64_t n_rows, int n_cols, int batch,
                               void* stream) {
  launch<false>(static_cast<const float*>(tab), static_cast<const int*>(idx),
                static_cast<float*>(out), n_rows, n_cols, batch,
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpt_scatter_rows(const void* tab, const void* idx, void* out,
                                int64_t n_rows, int n_cols, void* stream) {
  launch<true>(static_cast<const float*>(tab), static_cast<const int*>(idx),
               static_cast<float*>(out), n_rows, n_cols, 1,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
