// The compaction permute of the regen pool as one row gather, a row a
// thread: every pool column of destination row i from source row src[i].
//
// Replaces: no TPU kernel. The JAX package's permute is XLA's gather of a
// packed (P,16) matrix (tpu_pathtracer/tracer/regen.py: _compact). The
// port's plain version (ops/permute.py: pool_gather_plain) does the same in
// three passes over a 64-byte row a lane: a torch.cat of 16 int32 columns
// from the segment's eight outputs into a (P,16) matrix, the row gather
// pmat[src], and the split back into the pool's columns (copies, casts and
// the unpacking of the packed word). This kernel reads each source column
// once at row src[i] and writes each pool column once at row i:
//   in:  src [P] int64 (the stable argsort of the compaction key);
//        o, d, m, ell [P,3] f32; pdf [P] f32; rng, pixel [P] int64;
//        lb, bn, mid [P] int32;
//   out: orig, dir, mask, L [P,3] f32; bsdf_pdf [P] f32; rng, pixel [P]
//        int64; lbn, bounce, medium_id [P] int32.
// No source may share memory with a destination: the wrapper copies such a
// source (the pool's own pixel column, always) once before the launch.
//
// What bounds it on an H100: bytes. A lane reads its 8 B of src and 80 B of
// sources and writes 80 B: 168 B, 176 MB at P = 2^20, 0.053 ms at
// 3.35 TB/s (ops/permute.py: io_bytes). The reads are scattered: a source
// row's ten columns lie in ten arrays. The design: a thread a row, src read
// coalesced, every load of the row through the read-only path before any
// store (some 16 independent loads in flight a thread, at full occupancy:
// 32 registers), the stores to neighbouring rows from neighbouring
// threads; no shared memory; 64-bit offsets. Measured on an H100
// (chip_smoke.py phase 14): 0.087-0.089 ms on the order of a 1920x1080
// wave at P = 2^20, 0.27-0.30 ms on a random order, where each scattered
// 4-byte read seems to cost a 64-byte DRAM access. Two and four rows a thread, all
// loads before the stores (48 and 90 registers), were 1-3% slower on both.
//
// Bits: pure data movement, with the plain version's conversions done in
// registers. Floats move as their 32 bits (NaN payloads, -0.0, infinities
// and bsdf_pdf = -1 unchanged); rng keeps its low 32 bits, zero-extended
// (r.to(int32), then & 0xFFFFFFFF); pixel its low 32 bits, sign-extended;
// lbn, bounce and medium_id go through the packed word
// lb | bn << 8 | (mid + 1) << 16 in 32-bit two's complement and come out
// as w & 0xFF, (w >> 8) & 0xFF and (w >> 16) - 1, shifts right arithmetic,
// as torch's int32 kernels compute them.
// Plain PyTorch version: ops/permute.py, pool_gather_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

struct Cols {
  const int64_t* src;
  const uint32_t *o, *d, *m, *ell, *pdf;
  // the int64 columns read as their low 32-bit words (little-endian)
  const uint32_t *rng, *pixel;
  const int32_t *lb, *bn, *mid;
  uint32_t *orig_out, *dir_out, *mask_out, *L_out, *pdf_out;
  int64_t *rng_out, *pixel_out;
  int32_t *lbn_out, *bounce_out, *mid_out;
};

// the words of one row: o, d, m, ell 3 each, pdf, rng, pixel, packed
constexpr int kWords = 16;

__device__ __forceinline__ void load3(const uint32_t* __restrict__ a,
                                      int64_t j, uint32_t* v) {
  v[0] = __ldg(a + 3 * j);
  v[1] = __ldg(a + 3 * j + 1);
  v[2] = __ldg(a + 3 * j + 2);
}

__device__ __forceinline__ void store3(uint32_t* __restrict__ a, int64_t i,
                                       const uint32_t* v) {
  a[3 * i] = v[0];
  a[3 * i + 1] = v[1];
  a[3 * i + 2] = v[2];
}

__global__ void __launch_bounds__(kBlock)
    pool_gather_kernel(int64_t n, const Cols c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const int64_t s = __ldg(c.src + i);
  uint32_t v[kWords];
  load3(c.o, s, v);
  load3(c.d, s, v + 3);
  load3(c.m, s, v + 6);
  load3(c.ell, s, v + 9);
  v[12] = __ldg(c.pdf + s);
  v[13] = __ldg(c.rng + 2 * s);
  v[14] = __ldg(c.pixel + 2 * s);
  // torch's int32 ops: a << b as unsigned, a + 1 wrapping
  v[15] = static_cast<uint32_t>(__ldg(c.lb + s)) |
          (static_cast<uint32_t>(__ldg(c.bn + s)) << 8) |
          ((static_cast<uint32_t>(__ldg(c.mid + s)) + 1u) << 16);
  store3(c.orig_out, i, v);
  store3(c.dir_out, i, v + 3);
  store3(c.mask_out, i, v + 6);
  store3(c.L_out, i, v + 9);
  c.pdf_out[i] = v[12];
  c.rng_out[i] = static_cast<int64_t>(v[13]);
  c.pixel_out[i] = static_cast<int64_t>(static_cast<int32_t>(v[14]));
  const int32_t w = static_cast<int32_t>(v[15]);
  c.lbn_out[i] = w & 0xFF;
  c.bounce_out[i] = (w >> 8) & 0xFF;
  c.mid_out[i] = (w >> 16) - 1;
}

}  // namespace

// Launch the kernel on `stream` for n rows. The 21 pointers are src, the
// ten sources (o, d, m, ell, pdf, rng, pixel, lb, bn, mid) and the ten
// destinations (orig, dir, mask, L, bsdf_pdf, rng, pixel, lbn, bounce,
// medium_id), all checked by the wrapper (ops/permute.py). Returns the
// launch's CUDA error (0 on success, nothing launched for n = 0), or -1
// for a negative n.
extern "C" int tpt_pool_gather(int64_t n, const void* src, const void* o,
                               const void* d, const void* m, const void* ell,
                               const void* pdf, const void* rng,
                               const void* pixel, const void* lb,
                               const void* bn, const void* mid,
                               void* orig_out, void* dir_out, void* mask_out,
                               void* L_out, void* pdf_out, void* rng_out,
                               void* pixel_out, void* lbn_out,
                               void* bounce_out, void* mid_out,
                               void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  const Cols c{static_cast<const int64_t*>(src),
               static_cast<const uint32_t*>(o),
               static_cast<const uint32_t*>(d),
               static_cast<const uint32_t*>(m),
               static_cast<const uint32_t*>(ell),
               static_cast<const uint32_t*>(pdf),
               static_cast<const uint32_t*>(rng),
               static_cast<const uint32_t*>(pixel),
               static_cast<const int32_t*>(lb),
               static_cast<const int32_t*>(bn),
               static_cast<const int32_t*>(mid),
               static_cast<uint32_t*>(orig_out),
               static_cast<uint32_t*>(dir_out),
               static_cast<uint32_t*>(mask_out),
               static_cast<uint32_t*>(L_out),
               static_cast<uint32_t*>(pdf_out),
               static_cast<int64_t*>(rng_out),
               static_cast<int64_t*>(pixel_out),
               static_cast<int32_t*>(lbn_out),
               static_cast<int32_t*>(bounce_out),
               static_cast<int32_t*>(mid_out)};
  pool_gather_kernel<<<static_cast<unsigned>((n + kBlock - 1) / kBlock),
                       kBlock, 0, static_cast<cudaStream_t>(stream)>>>(n, c);
  return static_cast<int>(cudaGetLastError());
}
