// Lane arithmetic shared by the port's per-lane kernels (csrc/shade.cu,
// csrc/bssrdf.cu; csrc/surface.cuh builds on it): the V3 ops of
// core/vecmath.py, torch's NaN-passing clamps, the orthonormal basis, the
// cosine hemisphere draw, the dielectric Fresnel term, the PCG draw of
// core/rng.py and the material table's columns.
//
// Bits. Every function rounds where a torch kernel of the plain PyTorch
// version rounds, in the same order, when built with --fmad=false (see
// the note at the top of csrc/shade.cu): dot is (x*x + y*y) + z*z;
// normalize is a * (1 / sqrtf(max(dot, 1e-20))); `1.0 / t` is torch's
// reciprocal (an IEEE division) times 1; a Python constant is rounded to
// float before it meets a tensor (F32); clamp_min / clamp_max / maximum
// pass NaN through as torch's do; torch.linalg.cross on the card is
// fmaf(x, y, -(z*w)).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// core/vecmath.py's Python constants, as doubles
constexpr double kPi = 3.1415926535897932384626433832795;
constexpr double kTwoPi = 2.0 * kPi;
constexpr double kPiOver2 = kPi / 2.0;
constexpr double kPiOver4 = kPi / 4.0;
constexpr double kSqrtOneThird = 0.5773502691896257645091487805019574556476;

// a Python float as torch hands it to a float32 kernel
#define F32(x) static_cast<float>(x)

// material table columns (tracer/wavefront.py: _MAT_COLS)
constexpr int kColRefltype = 0, kColObjcol = 1, kColAlphax = 7,
              kColAlphay = 8, kColKd = 9, kColKs = 10, kColEtaT = 11,
              kColUseNormal = 12, kColUseTexture = 13, kColF0 = 14,
              kColTangent = 17, kColMfp = 20, kMatCols = 31;

__device__ const float kZeroRow[kMatCols] = {};

// the (M,31) table's row of material id; an id outside [0, M) reads a
// row of zeros, as tracer/wavefront.py: gather_material's does
__device__ __forceinline__ const float* mat_row(const float* table,
                                                int32_t n_mats, int32_t id) {
  return id >= 0 && id < n_mats ? table + id * kMatCols : kZeroRow;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
// a[..., None] * s in torch: each component times the scalar
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.clamp_min / clamp_max / maximum: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// 1.0 / t: torch's reciprocal (IEEE division), then times 1 (exact)
__device__ __forceinline__ float rcp(float v) { return 1.0f / v; }

__device__ __forceinline__ float cross_term(float p, float q, float r,
                                            float s) {
  return __fmaf_rn(p, q, -(r * s));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
          cross_term(a.x, b.y, a.y, b.x)};
}

__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, rcp(sqrtf(clamp_min(dot(a, a), F32(1e-20)))));
}

// d - n * 2.0 * dot(n, d)
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return sub(d, scale(scale(n, 2.0f), dot(n, d)));
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// core/vecmath.py: make_basis
__device__ __forceinline__ void make_basis(V3 n, V3* u, V3* v) {
  const float ax = fabsf(n.x), ay = fabsf(n.y);
  const float s = F32(kSqrtOneThird);
  const V3 w = ax < s ? V3{1.0f, 0.0f, 0.0f}
                      : (ay < s ? V3{0.0f, 1.0f, 0.0f}
                                : V3{0.0f, 0.0f, 1.0f});
  *u = normalize(cross(n, w));
  *v = cross(n, *u);
}

// core/vecmath.py: cosine_sample_hemisphere (concentric disk, then the
// basis about n)
__device__ V3 cosine_sample_hemisphere(float u1, float u2, V3 n) {
  const float ox = 2.0f * u1 - 1.0f;
  const float oy = 2.0f * u2 - 1.0f;
  const bool use_x = fabsf(ox) > fabsf(oy);
  const float r = use_x ? ox : oy;
  const float safe_ox = ox == 0.0f ? 1.0f : ox;
  const float safe_oy = oy == 0.0f ? 1.0f : oy;
  const float theta =
      use_x ? F32(kPiOver4) * (oy / safe_ox)
            : F32(kPiOver2) - F32(kPiOver4) * (ox / safe_oy);
  const bool degenerate = ox == 0.0f && oy == 0.0f;
  const float dx = degenerate ? 0.0f : r * cosf(theta);
  const float dy = degenerate ? 0.0f : r * sinf(theta);
  const float z = sqrtf(clamp_min(1.0f - dx * dx - dy * dy, 0.0f));
  V3 u, v;
  make_basis(n, &u, &v);
  return normalize(add(add(scale(u, dx), scale(v, dy)), scale(n, z)));
}

// materials/fresnel.py: fresnel_dielectric(cos_i, 1.0, eta_t)
__device__ __forceinline__ float fresnel_dielectric(float cos_i,
                                                    float eta_t) {
  const float eta = rcp(eta_t);
  const float cos_t =
      sqrtf(clamp_min(1.0f - (1.0f - cos_i * cos_i) * eta * eta, 0.0f));
  const float r1 = eta_t * cos_i;
  const float r2 = cos_t;                      // 1.0 * cos_t
  const float r3 = cos_i;                      // 1.0 * cos_i
  const float r4 = eta_t * cos_t;
  const float rp = (r1 - r2) / (r1 + r2);
  const float rs = (r3 - r4) / (r3 + r4);
  return (rp * rp + rs * rs) * 0.5f;
}

// core/rng.py: RaySampler.next in uint32 arithmetic; the unit float from
// the top 24 bits
__device__ __forceinline__ float next_unit(uint32_t* state) {
  const uint32_t s = *state * 747796405u + 2891336453u;
  *state = s;
  uint32_t w = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  w = (w >> 22) ^ w;
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

}  // namespace
