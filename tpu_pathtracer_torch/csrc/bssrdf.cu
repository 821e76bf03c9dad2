// The BSSRDF probe loop of a path segment (sum-of-exponentials profile),
// one thread a lane, in three kernels around the loop's masked closest-hit
// traces, which stay the traversal kernel's (csrc/traverse.cu):
//   probe_start_kernel   (once): every lane's RNG advanced by the loop's
//                        4 * probes + 2 draws; on a loop lane the first
//                        probe ray and the loop's state;
//   probe_step_kernel<false> (after each trace but the last): the hit's
//                        attributes and texture, the validity test, the
//                        reservoir pick, the advance along the probe, and
//                        the next probe ray where the probe missed;
//   probe_step_kernel<true>  (after the last trace): the last pick, the
//                        Lambertian exit direction, the SoE profile with
//                        its 3-axis / 3-channel MIS pdf, the exit Fresnel
//                        factor and the exit point; written in place into
//                        the surface draw's next origin, direction and
//                        throughput on the lanes that found an exit.
//
// Replaces: no TPU kernel. tpu_pathtracer/tracer/bssrdf_shade.py:
// bssrdf_scatter, whose some three hundred elementwise ops and selects
// over all lanes XLA fuses on the TPU into a few fusions around the
// traces. The port's plain version (tracer/bssrdf_shade.py:
// bssrdf_scatter_plain) is the same code in torch: some three hundred
// kernels a wave over the whole pool, many of them broadcasting an [N,1]
// mask against [N,3] columns through torch's strided elementwise kernel,
// and every intermediate a round trip through device memory. Here a lane
// outside the loop's mask only advances its RNG, and a loop lane reads its
// inputs, its material row, the hit's attribute row and the texture row
// it takes, and carries its state across the traces in one 64-byte row:
//   in:  rng (int64-carried uint32 PCG state), the hit point, the
//        interface normal ss_normal, objcol ([N,3] f32, rows s_* floats
//        apart), mat_id (int32), the loop mask (bool), the scene's (M,31)
//        material table, (Kt,28) attribute table and (Ht*Wt,12) texture
//        quad table, each trace's slot (int32) and t;
//   out: rng advanced, the probe rays the traces read (orig, dir [N,3],
//        tmax [N]), ok (bool), is_mul and next_normal (loop lanes only;
//        the distant light's weight and normal at the exit), and on the ok
//        lanes new_orig, next_dir and mask_mul.
//
// What bounds it on an H100: bytes. A loop lane reads 40 B of inputs once
// and each trace's 8 B, writes each probe ray's 28 B and 60 B at the end;
// every lane moves its 16 B of RNG, its mask and ok (ops/bssrdf.py:
// io_bytes). The state row (64 B read and written a launch) and the
// attribute rows (112 B, the ~11 MB table stays in the 50 MB L2) come on
// top. Its arithmetic (a few hundred FP32 operations and a dozen
// transcendentals a lane) is far below the 67 TFLOP/s line. The design: a
// lane per thread; the loop's state in one [N,16] f32 row read and written
// as four 16-byte vectors; the attribute and texture fetches of
// csrc/surface.cuh done in place, only for the hits and the picks that
// need them; the probe rays in the traversal kernel's layout, so the traces
// read them as they are.
//
// Bits. The kernels give the plain version's bits on the card: built with
// --fmad=false, they round every sum and product where a torch kernel of
// the plain version rounds it, in the same order (csrc/lane_math.cuh):
// dot is (x*x + y*y) + z*z; a Python constant is rounded to float before it
// meets a tensor; `scalar / t` is torch's reciprocal times the scalar;
// `t / scalar` is t * (1 / scalar); `** 2` a product; expf, logf, sqrtf,
// sinf and cosf the CUDA math library's; NaN passes the clamps as torch
// passes it. The plain version computes every lane and selects; a kernel
// computes what the selects keep, which are the same bits. The loop is
// chaotic (one ulp flips the reservoir's pick), so nothing less than the
// plain bits holds.
// Plain PyTorch version: tracer/bssrdf_shade.py, bssrdf_scatter_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_math.cuh"
#include "surface.cuh"

// The arguments of every launch (ops/bssrdf.py: ProbeArgs lays them out
// field for field); outside the anonymous namespace, so that the C entry
// that takes it keeps its external linkage.
struct ProbeArgs {
  int64_t n;
  const int64_t* rng_in;
  int64_t* rng_out;
  const float* hitpoint;
  int64_t s_hp;
  const float* normal;
  int64_t s_n;
  const float* objcol;
  int64_t s_obj;
  const int32_t* mat_id;
  const uint8_t* lanes;
  const float* mat_table;
  const float4* tri_attr;
  const float4* tex;                  // null: no texture lookups
  const int32_t* slot;
  const float* dist;
  float4* state;
  float* probe_orig;
  float* probe_dir;
  float* probe_len;
  float* new_orig;
  float* next_dir;
  float* mask_mul;
  uint8_t* ok;
  float* is_mul;
  float* next_normal;
  int32_t n_mats;
  int32_t tex_h;
  int32_t tex_w;
  int32_t n_draws;
};

namespace {

constexpr int kBlock = 256;

// the loop's state row, [N,16] f32: the reservoir's point, normal and
// colour, the last hit's offset from the hit point, the probe's radius,
// the RNG state's bits and the packed counts
constexpr int kStateCols = 16;
constexpr int kResPoint = 0, kResNormal = 3, kResColor = 6, kLastVec = 9,
              kRadius = 12, kRng = 13, kCounts = 14;
// the counts' fields: hit_count, hit_per_probe and probe_hit_count in a
// byte each, then select_this
constexpr uint32_t kByte = 0xffu, kSelectBit = 1u << 24;

constexpr double kFourPi = 4.0 * kPi;
constexpr double kEightPi = 8.0 * kPi;
// -math.log(0.01), the SoE radius cap's numerator
constexpr double kLogOneOverCap = 4.605170185988091;
constexpr float kMaxRatio = 10.0f, kMinNormalDot = F32(0.1);
constexpr float kRayMin = F32(1e-4);

__device__ __forceinline__ float pick(V3 v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : v.z);
}

// tracer/bssrdf_shade.py: param_soe
__device__ __forceinline__ float param_soe(float A) {
  const float p = fabsf(A - F32(0.8));
  return (F32(1.85) - A) + p * F32(7.0) * p * p;
}

// 1.0 / clamp_min(mat["mfp"], 1e-12)
__device__ __forceinline__ V3 sigma_t_of(const float* row) {
  return {rcp(clamp_min(__ldg(row + kColMfp), F32(1e-12))),
          rcp(clamp_min(__ldg(row + kColMfp + 1), F32(1e-12))),
          rcp(clamp_min(__ldg(row + kColMfp + 2), F32(1e-12)))};
}

// a table flag as gather_material gives it: the float cast to int32
__device__ __forceinline__ bool flag(const float* row, int col) {
  return static_cast<int>(__ldg(row + col)) != 0;
}

struct Probe {
  V3 orig, dir;
  float len, radius;
};

// tracer/bssrdf_shade.py: _sample_probe_ray, SoE branch (the r1 cascade
// and the radius x3 on the modified r1 kept)
__device__ Probe spawn_probe(float r1, float r2, float r3, V3 normal,
                             V3 hitpoint, V3 sigma_t, V3 rho, V3 vx,
                             V3 vy) {
  const int ch = min(max(static_cast<int>(r1 * 3.0f), 0), 2);
  r1 = r1 * 3.0f - static_cast<float>(ch);
  const bool axis_n = r1 < 0.5f;
  const bool axis_x = r1 >= 0.5f && r1 < 0.75f;
  const V3 dir = axis_n ? normal : (axis_x ? vx : vy);
  const V3 px = axis_n ? vx : (axis_x ? normal : vx);
  const V3 py = axis_n ? vy : (axis_x ? vy : normal);
  r1 = axis_n ? r1 * 2.0f
              : (axis_x ? r1 * (r1 - 0.5f) * 4.0f
                        : r1 * (r1 - 0.75f) * 4.0f);
  const float st = clamp_min(pick(sigma_t, ch), F32(1e-12));
  const float s = param_soe(pick(rho, ch));
  float radius =
      -logf(clamp_min(1.0f - r2 * F32(0.99), F32(1e-12))) / st / s;
  float radius_max = rcp(st) * F32(kLogOneOverCap) / s;
  if (r1 < 0.5f) {
    radius = radius * 3.0f;
    radius_max = radius_max * 3.0f;
  }
  const float phi = r3 * F32(kTwoPi);
  const float len = sqrtf(clamp_min(radius_max * radius_max -
                                        radius * radius, 0.0f)) * 2.0f;
  const float c = cosf(phi), sn = sinf(phi);
  const V3 disk = add(scale(px, c), scale(py, sn));
  const V3 orig = sub(add(hitpoint, scale(disk, radius)),
                      scale(dir, len * 0.5f));
  return {orig, dir, len, radius};
}

// tracer/bssrdf_shade.py: calculate_bssrdf_soe; beta [3]
__device__ V3 soe_beta(V3 ns, V3 nn, V3 sigma_t, V3 rho, V3 d, V3 ss,
                       V3 ts) {
  const float radius = sqrtf(dot(d, d));
  const float l0 = dot(ss, d), l1 = dot(ts, d), l2 = dot(ns, d);
  const float q0 = l0 * l0, q1 = l1 * l1, q2 = l2 * l2;
  const float rp[3] = {sqrtf(q1 + q2), sqrtf(q2 + q0), sqrtf(q0 + q1)};
  const float acp[3] = {fabsf(dot(ss, nn)) * F32(0.25 / 3.0),
                        fabsf(dot(ts, nn)) * F32(0.25 / 3.0),
                        fabsf(dot(ns, nn)) * F32(0.5 / 3.0)};
  const float st[3] = {sigma_t.x, sigma_t.y, sigma_t.z};
  const float rh[3] = {rho.x, rho.y, rho.z};
  float s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] = param_soe(rh[c]);
  const float inv3 = 1.0f / F32(3.0);
  const float inv4pi = 1.0f / F32(kFourPi);
  const float inv8pi = 1.0f / F32(kEightPi);
  float pdf = 0.0f;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    float ap[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float arg = -s[c] * rp[axis] * st[c];
      const float e1 = expf(arg);
      const float e2 = expf(arg * inv3) * inv3;
      ap[c] = (e1 + e2) * inv4pi * rh[c] * s[c] * st[c];
      if (rp[axis] > F32(1e-4)) ap[c] = ap[c] / clamp_min(rp[axis], F32(1e-4));
    }
    pdf = pdf + (ap[0] + ap[1] + ap[2]) * acp[axis];
  }
  float beta[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float arg = -s[c] * radius * st[c];
    const float e1 = expf(arg);
    const float e2 = expf(arg * inv3);
    float sr = (e1 + e2) * inv8pi * rh[c] * s[c] * st[c];
    if (radius > F32(1e-4)) sr = sr / clamp_min(radius, F32(1e-4));
    beta[c] = clamp_max(sr / clamp_min(pdf, F32(1e-20)), 10.0f);
  }
  return {beta[0], beta[1], beta[2]};
}

// materials/fresnel.py: fresnel_moment_1
__device__ __forceinline__ float fresnel_moment_1(float eta) {
  const float e2 = eta * eta;
  const float e3 = e2 * eta;
  const float e4 = e3 * eta;
  const float e5 = e4 * eta;
  const float lo = F32(0.45966) - eta * F32(1.73965) + e2 * F32(3.37668) -
                   e3 * F32(3.904945) + e4 * F32(2.49277) -
                   e5 * F32(0.68441);
  const float hi = eta * F32(11.1136) + F32(-4.61686) - e2 * F32(10.4646) +
                   e3 * F32(5.11455) - e4 * F32(1.27198) +
                   e5 * F32(0.12746);
  return eta < 1.0f ? lo : hi;
}

// the lane's hit point, interface normal and objcol
__device__ __forceinline__ V3 hitpoint_of(const ProbeArgs& a, int64_t i) {
  return load3(a.hitpoint + i * a.s_hp);
}
__device__ __forceinline__ V3 normal_of(const ProbeArgs& a, int64_t i) {
  return load3(a.normal + i * a.s_n);
}
__device__ __forceinline__ V3 objcol_of(const ProbeArgs& a, int64_t i) {
  return load3(a.objcol + i * a.s_obj);
}

__device__ __forceinline__ void store_probe(const ProbeArgs& a, int64_t i,
                                            const Probe& p) {
  store3(a.probe_orig + 3 * i, p.orig);
  store3(a.probe_dir + 3 * i, p.dir);
  a.probe_len[i] = p.len;
}

__global__ void __launch_bounds__(kBlock) probe_start_kernel(ProbeArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  uint32_t rng = static_cast<uint32_t>(a.rng_in[i]);
  // every lane draws what the whole loop draws, as the plain version does
  uint32_t end = rng;
  for (int k = 0; k < a.n_draws; ++k) end = end * 747796405u + 2891336453u;
  a.rng_out[i] = static_cast<int64_t>(end);
  if (!a.lanes[i]) return;
  const V3 hitpoint = hitpoint_of(a, i), normal = normal_of(a, i),
           objcol = objcol_of(a, i);
  const float* row = mat_row(a.mat_table, a.n_mats, a.mat_id[i]);
  V3 vx, vy;
  make_basis(normal, &vx, &vy);
  const float r1 = next_unit(&rng);
  const float r2 = next_unit(&rng);
  const float r3 = next_unit(&rng);
  const Probe p = spawn_probe(r1, r2, r3, normal, hitpoint, sigma_t_of(row),
                              objcol, vx, vy);
  store_probe(a, i, p);
  // the reservoir starts at the entry point: its point, normal and colour
  float4* st = a.state + i * (kStateCols / 4);
  st[0] = make_float4(hitpoint.x, hitpoint.y, hitpoint.z, normal.x);
  st[1] = make_float4(normal.y, normal.z, objcol.x, objcol.y);
  st[2] = make_float4(objcol.z, 0.0f, 0.0f, 0.0f);
  st[3] = make_float4(p.radius, __uint_as_float(rng), __uint_as_float(0u),
                      0.0f);
}

// one trace's pick, and then the next probe (kFinish false) or the exit
// (kFinish true)
template <bool kFinish>
__global__ void __launch_bounds__(kBlock) probe_step_kernel(ProbeArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  if (!a.lanes[i]) {
    if (kFinish) a.ok[i] = 0;
    return;
  }
  float4* stp = a.state + i * (kStateCols / 4);
  float s[kStateCols];
#pragma unroll
  for (int k = 0; k < kStateCols / 4; ++k) {
    const float4 q = stp[k];
    s[4 * k] = q.x;
    s[4 * k + 1] = q.y;
    s[4 * k + 2] = q.z;
    s[4 * k + 3] = q.w;
  }
  V3 res_point = at3(s, kResPoint), res_normal = at3(s, kResNormal),
     res_color = at3(s, kResColor), last_vec = at3(s, kLastVec);
  float radius = s[kRadius];
  uint32_t rng = __float_as_uint(s[kRng]);
  const uint32_t counts = __float_as_uint(s[kCounts]);
  int hit_count = counts & kByte;
  int hit_per_probe = (counts >> 8) & kByte;
  int probe_hit_count = (counts >> 16) & kByte;
  bool select_this = (counts & kSelectBit) != 0;

  const V3 hitpoint = hitpoint_of(a, i);
  const int32_t id = a.mat_id[i];
  const float* row = mat_row(a.mat_table, a.n_mats, id);
  const float r4 = next_unit(&rng);
  const int32_t slot = a.slot[i];
  const bool got_hit = slot >= 0;
  V3 po = load3(a.probe_orig + 3 * i);
  const V3 pd = load3(a.probe_dir + 3 * i);
  float plen = a.probe_len[i];
  if (got_hit) {
    const float dist = a.dist[i];
    const V3 hp = add(po, scale(pd, dist));
    const V3 vec = sub(hp, hitpoint);
    const float real_radius = sqrtf(dot(vec, vec));
    last_vec = vec;
    const Attributes at = fetch_row(a.tri_attr, slot, hp);
    const float normal_dot = fabsf(dot(normalize(at.smooth_n), pd));
    const bool valid = at.mat_id == id &&
                       real_radius / clamp_min(radius, F32(1e-12)) <
                           kMaxRatio &&
                       normal_dot > kMinNormalDot;
    if (valid) {
      hit_count += 1;
      hit_per_probe += 1;
      // new_hit_count >= 1 here, so clamp_min(new_hit_count, 1) is itself
      if (hit_count == 1 || r4 < rcp(static_cast<float>(hit_count))) {
        res_point = hp;
        res_normal = flag(row, kColUseNormal) ? at.smooth_n : at.tri_n;
        res_color = a.tex != nullptr && flag(row, kColUseTexture)
                        ? texture_at(a.tex, a.tex_h, a.tex_w, at.uv)
                        : objcol_of(a, i);
        select_this = true;
      }
    }
    // a miss now includes the beyond-probe-length case (the trace's tmax)
    plen = plen - dist;
    po = add(hp, scale(pd, kRayMin));
  }

  if (!kFinish) {
    const float r1 = next_unit(&rng);
    const float r2 = next_unit(&rng);
    const float r3 = next_unit(&rng);
    if (got_hit) {
      store3(a.probe_orig + 3 * i, po);
      a.probe_len[i] = plen;
    } else {
      // need_new: commit the probe's hits, then spawn the next probe
      if (select_this) probe_hit_count = hit_per_probe;
      select_this = false;
      hit_per_probe = 0;
      const V3 normal = normal_of(a, i);
      V3 vx, vy;
      make_basis(normal, &vx, &vy);
      const Probe p = spawn_probe(r1, r2, r3, normal, hitpoint,
                                  sigma_t_of(row), objcol_of(a, i), vx, vy);
      store_probe(a, i, p);
      radius = p.radius;
    }
    const uint32_t packed =
        static_cast<uint32_t>(hit_count & kByte) |
        (static_cast<uint32_t>(hit_per_probe & kByte) << 8) |
        (static_cast<uint32_t>(probe_hit_count & kByte) << 16) |
        (select_this ? kSelectBit : 0u);
    stp[0] = make_float4(res_point.x, res_point.y, res_point.z,
                         res_normal.x);
    stp[1] = make_float4(res_normal.y, res_normal.z, res_color.x,
                         res_color.y);
    stp[2] = make_float4(res_color.z, last_vec.x, last_vec.y, last_vec.z);
    stp[3] = make_float4(radius, __uint_as_float(rng),
                         __uint_as_float(packed), 0.0f);
    return;
  }

  if (select_this) probe_hit_count = hit_per_probe;
  const bool ok = hit_count > 0;
  const V3 normal = normal_of(a, i), objcol = objcol_of(a, i);
  V3 mask_mul = scale(mul(scale(res_color,
                                static_cast<float>(probe_hit_count)),
                          objcol),
                      F32(0.8));
  const V3 nn = normalize(res_normal);
  const float u1 = next_unit(&rng);
  const float u2 = next_unit(&rng);
  const V3 nd = cosine_sample_hemisphere(u1, u2, nn);
  V3 vx, vy;
  make_basis(normal, &vx, &vy);
  mask_mul = mul(mask_mul, soe_beta(normal, nn, sigma_t_of(row), objcol,
                                    last_vec, vx, vy));
  const V3 is_mul = mask_mul;
  const float eta_t = __ldg(row + kColEtaT);
  const float out_s = (1.0f - fresnel_dielectric(dot(nd, nn), eta_t)) /
                      (1.0f - fresnel_moment_1(rcp(eta_t)) * 2.0f);
  a.ok[i] = ok;
  store3(a.is_mul + 3 * i, is_mul);
  store3(a.next_normal + 3 * i, nn);
  if (ok) {
    store3(a.new_orig + 3 * i, add(res_point, scale(nn, kRayMin)));
    store3(a.next_dir + 3 * i, nd);
    store3(a.mask_mul + 3 * i, scale(mask_mul, out_s));
  }
}

}  // namespace

// stage 0 launches probe_start_kernel, 1 probe_step_kernel<false>, 2
// probe_step_kernel<true> over args->n lanes (nothing for n = 0), every
// pointer of *args as ops/bssrdf.py: ProbeArgs lays it out and checks it
// (the [N,3] outputs and probe rays contiguous, the tables contiguous and
// 16-byte aligned, state [N,16] f32 16-byte aligned). The arguments are
// copied into the launch, so *args may change after the call. Launch on
// `stream`; return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an unknown stage.
extern "C" int tpt_bssrdf_probe(int stage, const ProbeArgs* args,
                                void* stream) {
  if (args->n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((args->n + kBlock - 1) / kBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0:
      probe_start_kernel<<<grid, kBlock, 0, s>>>(*args);
      break;
    case 1:
      probe_step_kernel<false><<<grid, kBlock, 0, s>>>(*args);
      break;
    case 2:
      probe_step_kernel<true><<<grid, kBlock, 0, s>>>(*args);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
