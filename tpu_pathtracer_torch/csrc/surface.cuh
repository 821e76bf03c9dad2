// The surface lookups a lane makes at a hit, shared by csrc/fetch.cu,
// csrc/envtex.cu and csrc/bssrdf.cu: the attribute row's barycentric
// interpolation (ops/surface_fetch.py: fetch_attributes_plain) and the
// texture's wrap bilinear quad lookup (scene/texture.py:
// sample_texture_quad), with the bits of their plain PyTorch versions on
// the card (see the notes at the top of csrc/fetch.cu and csrc/envtex.cu).

#pragma once

#include "lane_math.cuh"

namespace {

// tracer/wavefront.py: pack_tri_attributes
constexpr int kAttrCols = 28;
constexpr int kColUv = 9, kColNrm = 15, kColMat = 24, kColGeoN = 25;
constexpr int kRowVec4 = kAttrCols / 4;

__device__ __forceinline__ V3 at3(const float* a, int c) {
  return {a[c], a[c + 1], a[c + 2]};
}

// fetch_attributes at one lane: hit_uv, smooth_n, mat_id and tri_n (0
// where slot < 0) from the slot's row (row 0 on a miss, as the plain
// version's clamp gives) and the hit point
struct Attributes {
  float2 uv;
  V3 smooth_n;
  int32_t mat_id;
  V3 tri_n;
};

__device__ __forceinline__ Attributes fetch_row(const float4* table,
                                                int32_t slot, V3 hp) {
  // torch.clamp_min(hit_slot, 0)
  const float4* row = table + static_cast<int64_t>(slot < 0 ? 0 : slot) *
                                  kRowVec4;
  float a[kAttrCols];
#pragma unroll
  for (int k = 0; k < kRowVec4; ++k) {
    const float4 q = __ldg(row + k);
    a[4 * k] = q.x;
    a[4 * k + 1] = q.y;
    a[4 * k + 2] = q.z;
    a[4 * k + 3] = q.w;
  }
  // core/vecmath.py: barycentric(hitpoint, p0, p1, p2)
  const V3 p0 = at3(a, 0), p1 = at3(a, 3), p2 = at3(a, 6);
  const V3 v0 = sub(p1, p0);
  const V3 v1 = sub(p2, p0);
  const V3 v2 = sub(hp, p0);
  const float d00 = dot(v0, v0);
  const float d01 = dot(v0, v1);
  const float d11 = dot(v1, v1);
  const float d20 = dot(v2, v0);
  const float d21 = dot(v2, v1);
  float denom = d00 * d11 - d01 * d01;
  if (fabsf(denom) < F32(1e-30)) denom = F32(1e-30);
  const float v = (d11 * d20 - d01 * d21) / denom;
  const float w = (d00 * d21 - d01 * d20) / denom;
  const float u = 1.0f - v - w;
  Attributes out;
  out.uv = make_float2(
      u * a[kColUv] + v * a[kColUv + 2] + w * a[kColUv + 4],
      u * a[kColUv + 1] + v * a[kColUv + 3] + w * a[kColUv + 5]);
  out.smooth_n = {
      u * a[kColNrm] + v * a[kColNrm + 3] + w * a[kColNrm + 6],
      u * a[kColNrm + 1] + v * a[kColNrm + 4] + w * a[kColNrm + 7],
      u * a[kColNrm + 2] + v * a[kColNrm + 5] + w * a[kColNrm + 8]};
  // torch.where(hit_slot >= 0, a[:, 25:28], 0.0)
  out.tri_n = slot >= 0 ? at3(a, kColGeoN) : V3{0.0f, 0.0f, 0.0f};
  out.mat_id = __float_as_int(a[kColMat]);
  return out;
}

// torch.remainder(a, 1.0) on a float tensor
__device__ __forceinline__ float remainder1(float a) {
  float m = fmodf(a, 1.0f);
  if (m < 0.0f) m += 1.0f;  // m != 0 and its sign differs from 1's
  return m;
}
// torch.remainder(a, b) on an int32 tensor, b > 0
__device__ __forceinline__ int imod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;  // r != 0 and its sign differs from b's
}

// scene/texture.py: _bilinear_rows, channel c
__device__ __forceinline__ float bilinear(const float* q, float fx, float fy,
                                          int c) {
  return q[c] * (1.0f - fx) * (1.0f - fy) + q[3 + c] * fx * (1.0f - fy) +
         q[6 + c] * (1.0f - fx) * fy + q[9 + c] * fx * fy;
}

// the texture half: scene/texture.py's wrap / wrap bilinear of hit_uv;
// (fx, fy) and the quad row's index in the texture's own rows
struct TexLookup {
  float fx, fy;
  int row;
};

__device__ __forceinline__ TexLookup texture_lookup(float2 uv, int Ht,
                                                    int Wt) {
  const float u = remainder1(uv.x);
  const float v = remainder1(uv.y);
  const float x = u * F32(Wt) - 0.5f;
  const float y = v * F32(Ht) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int x0i = imod(static_cast<int>(x0), Wt);
  const int y0i = imod(static_cast<int>(y0), Ht);
  return {x - x0, y - y0, y0i * Wt + x0i};
}

template <int kCols>
__device__ __forceinline__ void load_row(const float4* table, int64_t row,
                                         float* q) {
  const float4* r = table + row * (kCols / 4);
#pragma unroll
  for (int k = 0; k < kCols / 4; ++k) {
    const float4 v = __ldg(r + k);
    q[4 * k] = v.x;
    q[4 * k + 1] = v.y;
    q[4 * k + 2] = v.z;
    q[4 * k + 3] = v.w;
  }
}

// texture_radiance at one lane: the (Ht*Wt, 12) texture quad table's
// bilinear lookup at uv
__device__ __forceinline__ V3 texture_at(const float4* table, int Ht,
                                         int Wt, float2 uv) {
  const TexLookup t = texture_lookup(uv, Ht, Wt);
  float q[12];
  load_row<12>(table, t.row, q);
  return {bilinear(q, t.fx, t.fy, 0), bilinear(q, t.fx, t.fy, 1),
          bilinear(q, t.fx, t.fy, 2)};
}

}  // namespace
