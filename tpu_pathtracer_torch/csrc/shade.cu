// The surface BSDF draw of a path segment, one thread a lane.
//
// Replaces: no TPU kernel. tpu_pathtracer/tracer/wavefront.py: shade, which
// evaluates all seven material branches for every lane and selects by
// refltype; under jax.jit XLA fuses that elementwise work into a few
// fusions. The port's plain version (ops/shade.py: shade_plain) is the same
// code in torch, some hundreds of elementwise kernels over the whole pool,
// every intermediate a round trip through device memory. This kernel reads
// a lane's inputs once, runs only the branch its refltype needs, and writes
// its outputs once:
//   in:  rng (int64-carried uint32 PCG state), raydir, n, nl ([N,3] f32,
//        rows `stride` floats apart), into (bool), the lane's material id
//        (int32) and the scene's (M,31) f32 material table
//        (tracer/wavefront.py: _MAT_COLS), objcol ([N,3]);
//   out: rng advanced by exactly six draws (core/rng.py: RaySampler.next_n),
//        next_dir, mask_mul, offset, terminate, bounce_inc, glass_refract,
//        ss_refract, ss_normal (the interface normal of the subsurface
//        sampler, computed on every lane as the plain version does).
// Other refltypes than 2..7 (the emitter among them) take the diffuse
// draw, as the plain version's selects give them.
//
// What bounds it on an H100: bytes. A lane reads at most 61 B (rng 8, the
// id 4, raydir / n / nl 36, into 1, objcol 12; which of them depends on
// its branch, ops/shade.py: io_bytes) and writes 55 B; the table is a few
// KB that every lane shares, so it stays in cache. Its arithmetic (at most
// a few hundred FP32 operations and a few transcendentals a lane) is far
// below the 67 TFLOP/s line. The design is the simple one: a lane per
// thread, scalar loads of the table columns the branch reads, divergence
// across the branches of a warp's mixed materials accepted.
//
// Bits. The kernel gives the plain version's bits on the card. It is built
// with --fmad=false and rounds every sum and product where a torch kernel
// of the plain version rounds it, in the same order: dot is
// (x*x + y*y) + z*z; normalize is a * (1 / sqrtf(max(dot, 1e-20)));
// `1.0 / t` is torch's reciprocal (an IEEE division) times 1; `t / scalar`
// on the card is t * (1 / scalar) (torch's div by a CPU scalar); a Python
// constant is rounded to float before it meets a tensor (F32);
// clamp_min / clamp_max / maximum pass NaN through as torch's do; sinf,
// cosf, tanf, atanf and sqrtf are the CUDA math library's, as torch calls
// them. torch.linalg.cross is one CUDA kernel of PyTorch's build, which
// contracts x*y - z*w into fmaf(x, y, -(z*w)); cross() does the same. The
// helpers that csrc/bssrdf.cu shares live in csrc/lane_math.cuh.
// Plain PyTorch version: ops/shade.py, shade_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_math.cuh"

namespace {

constexpr int kBlock = 256;

// refltype (scene/config.py)
constexpr int kMatEmit = 0, kMatGlass = 2, kMatRefl = 3, kMatDiffRefl = 4,
              kMatFresnel = 5, kMatNull = 6, kMatSubsurface = 7;

// F0 + (1 - F0) * pow5(1 - cos), F0 per channel
__device__ __forceinline__ V3 schlick(V3 F0, float cos_theta) {
  const float p = pow5(1.0f - cos_theta);
  return {F0.x + (1.0f - F0.x) * p, F0.y + (1.0f - F0.y) * p,
          F0.z + (1.0f - F0.z) * p};
}

// materials/bsdf.py: _ggx_sample_normal_iso
__device__ V3 ggx_iso(float u1, float u2, float alpha2, V3 n) {
  const float cos_t =
      rcp(sqrtf(1.0f + alpha2 * u1 / clamp_min(1.0f - u1, F32(1e-7))));
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float phi = F32(kTwoPi) * u2;
  V3 t, b;
  make_basis(n, &t, &b);
  const V3 m = add(add(scale(t, sin_t * cosf(phi)),
                       scale(b, sin_t * sinf(phi))),
                   scale(n, cos_t));
  return normalize(m);
}

// materials/bsdf.py: _ggx_sample_normal_aniso
__device__ V3 ggx_aniso(float u1, float u2, float alphax, float alphay, V3 n,
                        V3 tangent) {
  float phi = atanf(alphay / clamp_min(alphax, F32(1e-7)) *
                    tanf(F32(kTwoPi) * u1 + F32(kPiOver2)));
  if (u1 > 0.5f) phi = phi + F32(kPi);
  const float sp = sinf(phi);
  const float cp = cosf(phi);
  const float ax2 = alphax * alphax;
  const float ay2 = alphay * alphay;
  const float denom = cp * cp / clamp_min(ax2, F32(1e-12)) +
                      sp * sp / clamp_min(ay2, F32(1e-12));
  const float cos_t =
      rcp(sqrtf(1.0f + rcp(clamp_min(denom, F32(1e-12))) * u2 /
                           clamp_min(1.0f - u2, F32(1e-7))));
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const V3 t = normalize(tangent);
  const V3 b = cross(n, t);
  const V3 m = add(add(scale(t, sin_t * cp), scale(b, sin_t * sp)),
                   scale(n, cos_t));
  return normalize(m);
}

__device__ __forceinline__ float smith_g(float tan_wo, float alpha2) {
  return rcp(1.0f + (sqrtf(1.0f + alpha2 * tan_wo * tan_wo) - 1.0f) * 0.5f);
}

__device__ __forceinline__ float tan_of(float cos_wo) {
  return sqrtf(clamp_min(1.0f - cos_wo * cos_wo, 0.0f)) /
         clamp_min(cos_wo, F32(1e-6));
}

// materials/bsdf.py: _dielectric_fresnel (etaI / etaT swapped by `into`)
__device__ __forceinline__ float dielectric_fresnel(bool into, float cos_i,
                                                    float cos_t, float etaT) {
  const float etaI_ = into ? 1.0f : etaT;
  const float etaT_ = into ? etaT : 1.0f;
  const float R1 = etaT_ * cos_i;
  const float R2 = etaI_ * cos_t;
  const float R3 = etaI_ * cos_i;
  const float R4 = etaT_ * cos_t;
  const float rp = (R1 - R2) / clamp_min(R1 + R2, F32(1e-12));
  const float rs = (R3 - R4) / clamp_min(R3 + R4, F32(1e-12));
  return (rp * rp + rs * rs) * 0.5f;
}

// eta * raydir + (eta * cos_i - cos_t) * m, normalized
__device__ __forceinline__ V3 refract_dir(V3 raydir, V3 m, float eta,
                                          float cos_i, float cos_t) {
  return normalize(add(scale(raydir, eta), scale(m, eta * cos_i - cos_t)));
}

// materials/bsdf.py: ggx_reflection_sample; m_iso is the isotropic normal
// sample about nl at alphax^2
__device__ void ggx_reflection(float u1, float u2, V3 raydir, V3 nl,
                               V3 tangent, V3 F0, float alphax, float alphay,
                               V3 m_iso, V3* dir, V3* beta) {
  const bool iso = alphax == alphay;
  const float ax2 = alphax * alphax;
  const float ay2 = alphay * alphay;
  const V3 m = iso ? m_iso : ggx_aniso(u1, u2, alphax, alphay, nl, tangent);
  const V3 nd = normalize(reflect(raydir, m));
  const float cos_wowh = clamp_min(fabsf(dot(m, nd)), F32(0.01));
  const V3 F = schlick(F0, cos_wowh);
  const float cos_wo = fabsf(dot(nd, nl));
  const float cos_wi = clamp_min(fabsf(dot(raydir, nl)), F32(0.01));
  const float tan_wo = tan_of(cos_wo);
  float G;
  if (iso) {
    G = smith_g(tan_wo, ax2);
  } else {
    const V3 b_aniso = cross(nl, normalize(tangent));
    const float c = dot(cross(nd, nl), b_aniso);
    const float cos2_phi_wo = c * c;
    const float alpha_a =
        sqrtf(cos2_phi_wo * ax2 + (1.0f - cos2_phi_wo) * ay2);
    const float at = alpha_a * tan_wo;
    G = rcp(1.0f + (sqrtf(1.0f + at * at) - 1.0f) * 0.5f);
  }
  const float cos_wh = clamp_min(dot(m, nl), F32(0.01));
  const float s = G * cos_wowh / cos_wi / cos_wh;
  *dir = nd;
  *beta = {clamp_max(F.x * s, 1.0f), clamp_max(F.y * s, 1.0f),
           clamp_max(F.z * s, 1.0f)};
}

// materials/bsdf.py: fresnel_blend_sample (its min(0.01, .) clamps kept)
__device__ void fresnel_blend(float u1, float u2, float u3, V3 raydir, V3 nl,
                              V3 Rd, V3 Rs, float alpha2, V3 m, V3* dir,
                              V3* beta) {
  const V3 d_dir = cosine_sample_hemisphere(u1, u2, nl);
  const bool diffuse = u3 < 0.5f;
  const V3 wh = normalize(diffuse ? sub(d_dir, raydir) : m);
  const V3 nd = normalize(diffuse ? d_dir : reflect(raydir, m));
  const V3 wo = normalize(raydir);
  const float cos_wi = fabsf(dot(nd, nl));
  const float cos_wo = clamp_max(fabsf(dot(wo, nl)), F32(0.01));
  const float cos_wh = clamp_max(fabsf(dot(wh, nl)), F32(0.01));
  const float cos2_wh = cos_wh * cos_wh;
  const float tan2_wh = (1.0f - cos2_wh) / clamp_min(cos2_wh, F32(1e-12));
  const float cos4_wh = cos2_wh * cos2_wh;
  const float e = 1.0f + tan2_wh / alpha2;
  const float D =
      rcp(F32(kPi) * alpha2 * clamp_min(cos4_wh * e * e, F32(1e-30)));
  const float dot_wiwh = clamp_max(fabsf(dot(nd, wh)), F32(0.01));
  const float k = (1.0f - pow5(1.0f - 0.5f * cos_wi)) *
                  (1.0f - pow5(1.0f - 0.5f * cos_wo));
  const float c = F32(28.0 / (23.0 * kPi));
  const V3 diff = {c * Rd.x * (1.0f - Rs.x) * k, c * Rd.y * (1.0f - Rs.y) * k,
                   c * Rd.z * (1.0f - Rs.z) * k};
  const float sd = D / (4.0f * clamp_min(dot_wiwh, F32(1e-7)) *
                        clamp_min(maximum(cos_wi, cos_wo), F32(1e-7)));
  const V3 f = add(scale(schlick(Rs, dot_wiwh), sd), diff);
  // cos_wi / PI: torch divides by a CPU scalar as a product with 1 / PI
  const float pdf = 0.5f * (cos_wi * (1.0f / F32(kPi)) +
                            D / (4.0f * clamp_min(dot_wiwh, F32(1e-7))));
  *dir = nd;
  *beta = scale(f, cos_wi / clamp_min(pdf, F32(1e-20)));
}

__global__ void __launch_bounds__(kBlock)
shade_kernel(int64_t n_lanes, const int64_t* __restrict__ rng_in,
             const float* __restrict__ raydir_p, int64_t s_dir,
             const float* __restrict__ n_p, int64_t s_n,
             const float* __restrict__ nl_p, int64_t s_nl,
             const uint8_t* __restrict__ into_p,
             const int32_t* __restrict__ mat_id,
             const float* __restrict__ table, int32_t n_mats,
             const float* __restrict__ objcol_p, int64_t s_obj,
             int64_t* __restrict__ rng_out, float* __restrict__ next_dir_p,
             float* __restrict__ mask_mul_p, float* __restrict__ offset_p,
             uint8_t* __restrict__ terminate_p,
             int32_t* __restrict__ bounce_inc_p,
             uint8_t* __restrict__ glass_refract_p,
             uint8_t* __restrict__ ss_refract_p,
             float* __restrict__ ss_normal_p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_lanes) return;
  uint32_t state = static_cast<uint32_t>(rng_in[i]);
  const float u1 = next_unit(&state);
  const float u2 = next_unit(&state);
  const float u3 = next_unit(&state);
  next_unit(&state);                                     // u4: unused
  const float u5 = next_unit(&state);
  next_unit(&state);                                     // u6: unused
  rng_out[i] = static_cast<int64_t>(state);

  // an id outside [0, M) reads a row of zeros, as gather_material's does
  const int32_t id = mat_id[i];
  const float* row = mat_row(table, n_mats, id);
  const int refltype = static_cast<int>(__ldg(row + kColRefltype));
  const float alphax = __ldg(row + kColAlphax);
  const float kd = __ldg(row + kColKd);
  const float ks = __ldg(row + kColKs);
  const float etaT = __ldg(row + kColEtaT);
  const V3 raydir = load3(raydir_p + i * s_dir);
  const V3 nl = load3(nl_p + i * s_nl);
  const V3 objcol = load3(objcol_p + i * s_obj);
  const bool into = into_p[i] != 0;

  // the subsurface interface normal, on every lane (aux["ss_normal"]); at
  // alphax > 1e-3 it is the isotropic GGX normal that the rough branches
  // also draw from (u1, u2, alphax^2, nl)
  const float a2 = alphax * alphax;
  const bool rough = alphax > F32(1e-3);
  const V3 ss_m = rough ? ggx_iso(u1, u2, a2, nl) : nl;

  V3 dir, mm;
  float offset = 1.0f;
  int bounce_inc = 0;
  bool glass_refract = false, ss_refract = false;
  switch (refltype) {
    case kMatRefl:
    case kMatDiffRefl: {
      bool spec = true;
      if (refltype == kMatDiffRefl) {
        spec = u5 < ks / clamp_min(ks + kd, F32(1e-7));
        offset = 0.0f;
      }
      if (refltype == kMatRefl && alphax == 0.0f) {
        // a mirror offsets twice (reference quirk kept)
        dir = normalize(reflect(raydir, load3(n_p + i * s_n)));
        mm = scale(objcol, ks);
        offset = 2.0f;
      } else if (spec) {
        const float alphay = __ldg(row + kColAlphay);
        const V3 m_iso = alphax == alphay
                             ? (rough ? ss_m : ggx_iso(u1, u2, a2, nl))
                             : V3{0.0f, 0.0f, 0.0f};
        V3 g_beta;
        ggx_reflection(u1, u2, raydir, nl, load3(row + kColTangent),
                       load3(row + kColF0), alphax, alphay, m_iso, &dir,
                       &g_beta);
        mm = refltype == kMatRefl ? mul(scale(g_beta, ks), objcol) : g_beta;
      } else {
        dir = cosine_sample_hemisphere(u1, u2, nl);
        mm = objcol;
      }
      bounce_inc = spec ? 1 : 0;
      break;
    }
    case kMatFresnel: {
      const float alpha2 = clamp_min(a2, F32(1e-12));
      const V3 m = rough ? ss_m : ggx_iso(u1, u2, alpha2, nl);
      fresnel_blend(u1, u2, u3, raydir, nl, scale(objcol, kd),
                    load3(row + kColF0), alpha2, m, &dir, &mm);
      offset = 0.0f;
      bounce_inc = 1;
      break;
    }
    case kMatGlass: {
      const float eta = into ? rcp(etaT) : etaT;
      bool refl;
      if (alphax == 0.0f) {
        const float cos_i = fabsf(dot(nl, raydir));
        const float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
        const float sin2_t = eta * eta * sin2_i;
        const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
        const float fr = dielectric_fresnel(into, cos_i, cos_t, etaT);
        refl = sin2_t >= 1.0f || u1 <= fr;
        dir = refl ? normalize(reflect(raydir, nl))
                   : refract_dir(raydir, nl, eta, cos_i, cos_t);
        mm = {1.0f, 1.0f, 1.0f};
      } else {
        const V3 m = rough ? ss_m : ggx_iso(u1, u2, a2, nl);
        const float cos_i = fabsf(dot(m, raydir));
        const float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
        const float sin2_t = eta * eta * sin2_i;
        const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
        const float fr = dielectric_fresnel(into, cos_i, cos_t, etaT);
        refl = sin2_t >= 1.0f || u1 < fr;
        dir = refl ? normalize(reflect(raydir, m))
                   : refract_dir(raydir, m, eta, cos_i, cos_t);
        const float cos_wo = fabsf(dot(dir, nl));
        const float cos_wi = clamp_min(fabsf(dot(raydir, nl)), F32(0.01));
        const float G = smith_g(tan_of(cos_wo), a2);
        const float cos_wh = clamp_min(dot(m, nl), F32(0.01));
        const float beta = clamp_max(G * cos_i / cos_wi / cos_wh, 1.0f);
        // rough transmission out of the medium carries eta^2
        const float f = !refl && !into ? etaT * etaT : 1.0f;
        mm = scale(scale(objcol, beta), f);
      }
      offset = refl ? 1.0f : -1.0f;
      bounce_inc = 1;
      glass_refract = !refl;
      break;
    }
    case kMatSubsurface: {
      const float cos_i = fabsf(dot(ss_m, raydir));
      const float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
      const float eta = into ? rcp(etaT) : etaT;
      const float sin2_t = eta * eta * sin2_i;
      const float fr = fresnel_dielectric(cos_i, etaT);
      const bool refl = sin2_t >= 1.0f || u1 < fr;
      dir = normalize(reflect(raydir, ss_m));
      float beta = 1.0f;
      if (rough) {
        const float cos_wo = fabsf(dot(dir, nl));
        const float cos_wi = clamp_min(fabsf(dot(raydir, nl)), F32(0.01));
        const float G = smith_g(tan_of(cos_wo), a2);
        const float cos_wh = clamp_min(dot(ss_m, nl), F32(0.01));
        beta = clamp_max(G * cos_i / cos_wi / cos_wh, 1.0f);
      }
      mm = mul(scale({ks, ks, ks}, beta), objcol);
      bounce_inc = refl ? 1 : 0;
      ss_refract = !refl;
      break;
    }
    case kMatNull:
      dir = raydir;
      mm = {1.0f, 1.0f, 1.0f};
      offset = -1.0f;
      break;
    default:                            // diffuse, the emitter, the rest
      dir = cosine_sample_hemisphere(u1, u2, nl);
      mm = scale(objcol, kd);
      break;
  }
  store3(next_dir_p + 3 * i, dir);
  store3(mask_mul_p + 3 * i, mm);
  offset_p[i] = offset;
  terminate_p[i] = refltype == kMatEmit;
  bounce_inc_p[i] = bounce_inc;
  glass_refract_p[i] = glass_refract;
  ss_refract_p[i] = ss_refract;
  store3(ss_normal_p + 3 * i, ss_m);
}

}  // namespace

// Plain C entry point for ctypes (ops/shade.py checks every argument).
// rng_in / rng_out are [n] int64, into / terminate / glass_refract /
// ss_refract [n] bool, bounce_inc and mat_id [n] int32, table [n_mats,31]
// f32 contiguous, next_dir / mask_mul / ss_normal [n,3] f32 contiguous,
// offset [n] f32; raydir, n, nl and objcol are [n,3] f32 with rows s_*
// floats apart. Launch on `stream`; return cudaGetLastError() (0 on
// success).
extern "C" int tpt_shade(int64_t n_lanes, const void* rng_in,
                         const void* raydir, int64_t s_dir, const void* n,
                         int64_t s_n, const void* nl, int64_t s_nl,
                         const void* into, const void* mat_id,
                         const void* table, int32_t n_mats,
                         const void* objcol, int64_t s_obj, void* rng_out,
                         void* next_dir, void* mask_mul, void* offset,
                         void* terminate, void* bounce_inc,
                         void* glass_refract, void* ss_refract,
                         void* ss_normal, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_lanes + kBlock - 1) / kBlock));
  shade_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      n_lanes, static_cast<const int64_t*>(rng_in),
      static_cast<const float*>(raydir), s_dir, static_cast<const float*>(n),
      s_n, static_cast<const float*>(nl), s_nl,
      static_cast<const uint8_t*>(into),
      static_cast<const int32_t*>(mat_id), static_cast<const float*>(table),
      n_mats, static_cast<const float*>(objcol), s_obj,
      static_cast<int64_t*>(rng_out), static_cast<float*>(next_dir),
      static_cast<float*>(mask_mul), static_cast<float*>(offset),
      static_cast<uint8_t*>(terminate), static_cast<int32_t*>(bounce_inc),
      static_cast<uint8_t*>(glass_refract),
      static_cast<uint8_t*>(ss_refract), static_cast<float*>(ss_normal));
  return static_cast<int>(cudaGetLastError());
}
