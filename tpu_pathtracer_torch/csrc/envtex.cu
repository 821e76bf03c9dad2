// The environment / texture quad lookup of a path segment, one thread a
// lane, in two instantiations:
//   merged (tpt_env_tex_merged): one row of the merged (He*We + Ht*Wt, 16)
//     envtex table a lane, its env row on a miss lane and its texture row
//     on any other, giving the MIS-weighted env radiance and the texture
//     radiance from that one row;
//   texture-only (tpt_texture_radiance): the (Ht*Wt, 12) texture quad
//     table, every lane a texture lane.
//
// Replaces: no TPU kernel. tpu_pathtracer/tracer/wavefront.py:412-473
// (env_tex_merged) and :388-390 (texture_radiance, scene/texture.py:
// sample_texture_quad), which XLA fuses on the TPU. The port's plain
// versions (ops/surface_fetch.py: env_tex_merged_plain,
// texture_radiance_plain) are the same code in torch: a row gather into
// an [N,16] intermediate and some eighty elementwise kernels, each a round
// trip through device memory.
//   in:  raydir [N,3] f32, bsdf_pdf [N] f32, miss [N] bool, hit_uv [N,2]
//        f32 (non-finite on miss lanes), the env rotation as a 0-d f32
//        tensor read from device memory (a host read would break the
//        capture of a CUDA graph), He, We, Ht, Wt;
//   out: env_L [N,3] (merged only), tex [N,3].
// A quad row holds the four texels of a bilinear footprint (cols 0:12,
// scene/texture.py: make_quad_texture) and, in the env part, the four
// corner pdfs (cols 12:16).
//
// What bounds it on an H100: bytes. A merged lane reads 25 B (raydir,
// bsdf_pdf, miss, hit_uv) and writes 24 B, a texture lane reads 8 B and
// writes 12 B; its row is 64 B (48 B), but the table (12.6 MB for the
// procedural sky and checker) stays in the 50 MB L2, so the least the card
// moves is each row the lanes touch once (ops/surface_fetch.py: io_bytes).
// Its arithmetic (some 80 FP32 operations, atan2f and acosf a lane) is far
// below the 67 TFLOP/s line. The design: one thread a lane, only the
// selected row read (a miss lane's texture index, from a non-finite uv,
// never addresses memory), in 16-byte loads through the read-only path
// (the wrapper checks the table's 16-byte alignment); per-lane inputs and
// outputs coalesced across the warp; every lane computes.
//
// Bits. Built with --fmad=false, the kernel rounds where the plain
// version's separate torch kernels round, in the same order. What torch
// does on the card that this repeats: `t / python_float` is t * (1 /
// float) (the reciprocal rounded in float); a Python constant is rounded
// to float before it meets a tensor (2 pi^2 is formed in double first);
// float torch.remainder(a, b) is fmodf(a, b) plus b where the signs
// differ; int32 remainder is % plus b where the signs differ; a float ->
// int32 cast truncates toward zero (NaN -> 0, as cvt.rzi gives); clamp and
// clamp_min pass NaN through; (1 - fx) is a subtraction from 1; the
// bilinear blend ((q0 (1-fx)) (1-fy) + (q1 fx) (1-fy)) + ... left to
// right; power_heuristic's and the pdf's tensor / tensor an IEEE division;
// atan2f, acosf and sqrtf the CUDA math library's, as torch calls them.
// The texture lookup is csrc/surface.cuh: texture_lookup, which
// csrc/bssrdf.cu's probe loop shares.
// Plain PyTorch versions: ops/surface_fetch.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surface.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kEnvCols = 16, kTexCols = 12;

__device__ __forceinline__ int iclamp(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// torch.clamp with scalar bounds: NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kBlock)
    env_tex_merged_kernel(int64_t n, const float* __restrict__ raydir,
                          const float* __restrict__ bsdf_pdf,
                          const uint8_t* __restrict__ miss,
                          const float2* __restrict__ hit_uv,
                          const float* __restrict__ rotation,
                          const float4* __restrict__ table, int He, int We,
                          int Ht, int Wt, float* __restrict__ env_L,
                          float* __restrict__ tex) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const TexLookup t = texture_lookup(hit_uv[i], Ht, Wt);
  const float dx = raydir[3 * i], dy = raydir[3 * i + 1],
              dz = raydir[3 * i + 2];
  // scene/texture.py: _uv_from_dir
  float ll = atan2f(dx, dz);
  if (ll < 0.0f) ll = ll + F32(kTwoPi);
  const float u = remainder1(ll * (1.0f / F32(kTwoPi)) + __ldg(rotation));
  const float v = acosf(clamp(dy, -1.0f, 1.0f)) * (1.0f / F32(kPi));
  const float xe = u * F32(We) - 0.5f;
  const float ye = v * F32(He) - 0.5f;
  const float xe0 = floorf(xe);
  const float ye0 = floorf(ye);
  const float fxe = xe - xe0, fye = ye - ye0;
  const int xe0i = iclamp(static_cast<int>(xe0), 0, We - 1);
  const int ye0i = iclamp(static_cast<int>(ye0), 0, He - 1);
  const int row = miss[i] ? ye0i * We + xe0i : He * We + t.row;
  float q[kEnvCols];
  load_row<kEnvCols>(table, row, q);
  // scene/texture.py: _corner_pdf
  const int sx = iclamp(static_cast<int>(u * F32(We)) - xe0i, 0, 1);
  const int sy = iclamp(static_cast<int>(v * F32(He)) - ye0i, 0, 1);
  const float p_uv = sy == 0 ? (sx == 0 ? q[12] : q[13])
                             : (sx == 0 ? q[14] : q[15]);
  // ops/surface_fetch.py: mis_env_weight, power_heuristic
  const float sin_t = sqrtf(clamp_min(1.0f - dy * dy, F32(1e-8)));
  const float pdf_e = p_uv / (sin_t * F32(2.0 * kPi * kPi));
  const float pf = bsdf_pdf[i];
  const float pf2 = pf * pf;
  const float heur = pf2 / clamp_min(pf2 + pdf_e * pdf_e, F32(1e-20));
  const float weight = pf < 0.0f ? 1.0f : heur;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    env_L[3 * i + c] = weight * bilinear(q, fxe, fye, c);
    tex[3 * i + c] = bilinear(q, t.fx, t.fy, c);
  }
}

__global__ void __launch_bounds__(kBlock)
    texture_radiance_kernel(int64_t n, const float2* __restrict__ hit_uv,
                            const float4* __restrict__ table, int Ht, int Wt,
                            float* __restrict__ tex) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const TexLookup t = texture_lookup(hit_uv[i], Ht, Wt);
  float q[kTexCols];
  load_row<kTexCols>(table, t.row, q);
#pragma unroll
  for (int c = 0; c < 3; ++c) tex[3 * i + c] = bilinear(q, t.fx, t.fy, c);
}

unsigned grid_of(int64_t n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

}  // namespace

// n_lanes lanes; raydir [n,3], bsdf_pdf [n], miss [n] bool, hit_uv [n,2],
// rotation one f32, table (He*We + Ht*Wt, 16) f32 with a 16-byte aligned
// base, all contiguous; outputs env_L [n,3], tex [n,3], contiguous. Launch
// on `stream`; return cudaGetLastError() (0 on success).
extern "C" int tpt_env_tex_merged(int64_t n_lanes, const void* raydir,
                                  const void* bsdf_pdf, const void* miss,
                                  const void* hit_uv, const void* rotation,
                                  const void* table, int He, int We, int Ht,
                                  int Wt, void* env_L, void* tex,
                                  void* stream) {
  if (n_lanes <= 0) return 0;
  env_tex_merged_kernel<<<grid_of(n_lanes), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n_lanes, static_cast<const float*>(raydir),
      static_cast<const float*>(bsdf_pdf),
      static_cast<const uint8_t*>(miss), static_cast<const float2*>(hit_uv),
      static_cast<const float*>(rotation), static_cast<const float4*>(table),
      He, We, Ht, Wt, static_cast<float*>(env_L), static_cast<float*>(tex));
  return static_cast<int>(cudaGetLastError());
}

// n_lanes lanes; hit_uv [n,2], table (Ht*Wt, 12) f32 with a 16-byte aligned
// base, contiguous; output tex [n,3], contiguous. Launch on `stream`;
// return cudaGetLastError() (0 on success).
extern "C" int tpt_texture_radiance(int64_t n_lanes, const void* hit_uv,
                                    const void* table, int Ht, int Wt,
                                    void* tex, void* stream) {
  if (n_lanes <= 0) return 0;
  texture_radiance_kernel<<<grid_of(n_lanes), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n_lanes, static_cast<const float2*>(hit_uv),
      static_cast<const float4*>(table), Ht, Wt, static_cast<float*>(tex));
  return static_cast<int>(cudaGetLastError());
}
