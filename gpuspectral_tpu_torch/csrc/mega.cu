// K1: the persistent path-tracing megakernel, for sm_90a.
//
// Replaces gpuspectral_tpu/integrator/mega.py: render_mega_rows (the
// pallas_call built by _make_kernel around make_bounce_body).  Wrapper:
// gpuspectral_tpu_torch/integrator/mega.py (render_mega_rows).
//
// One thread per pixel lane runs that pixel's spp samples back to back: the
// camera ray, the brute-force closest hit over every triangle, the 8-BSDF
// sample and eval, NEE with a shadow ray and power-heuristic MIS, the
// firefly clamp, Russian roulette, and regeneration of the next sample the
// moment a path ends (mega.py:1130-1163).  Path state lives in registers;
// device memory sees the pixel id going in and four sums coming out.
//
// What bounds it on the H100: the intersection loops.  Every bounce tests
// the ray against all n_tris triangles (closest hit) plus up to all of them
// again (shadow ray), ~20 float operations each, so the work is about
// 2 * n_tris tests per bounce and no memory stream at all.  The design
// keeps that loop on chip: the block stages the (12, n_tris) Woop table in
// shared memory once (<= 96 KB at the 2048-triangle limit), and every
// thread of a warp walks the same triangle at the same time, so each table
// read is a shared-memory broadcast.  The loop is written as "one bounce per
// iteration, regenerate finished lanes", as the TPU kernel's while loop is,
// so the live threads of a warp reach the intersection loops together.
// Shading diverges by BSDF kind (a switch over 8 kinds); per-triangle
// attributes are one 128-byte row gathered from L1/L2 per hit.  Register
// pressure from holding all 8 BSDFs in one kernel is reported by the build
// (-Xptxas -v).
//
// What the TPU design needed and this one does not: (16,128) state planes,
// SMEM scalar broadcasts and select-chain gathers become registers and plain
// loads; the Mosaic-safe uint32->float conversion, modulo and division become
// __uint2float_rn, % and /; int32 bool carries become bool.
//
// Semantics kept exactly (mega.py line numbers): RNG channels (72-84);
// camera with rsqrt (1221-1242); orientation and two-faced flip (881-891);
// light sample (910-926); shadow interval (eps, ldist - eps) (990-995); MIS
// (1005-1034); one ray per live lane plus one per NEE candidate (1081); the
// strict per-channel firefly test (1102); RR on bounce > rr_start_depth
// (1118-1128); termination at depth >= max_depth + 1 (1133).  No
// environment emitter: the wrapper raises on one.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using gst::V3;
using gst::add;
using gst::cross;
using gst::dot;
using gst::length;
using gst::neg;
using gst::normalize;
using gst::safe_inv;
using gst::scale;
using gst::sub;
using gst::v3;

constexpr int kThreads = 128;
constexpr int kAttr = 32;  // attribute row: see integrator/mega.py:_pack_tables
constexpr int kLight = 12;

// RNG channels (path_tracer.CH_*)
constexpr uint32_t CH_BSDF_SELECT = 0, CH_BSDF_U1 = 1, CH_BSDF_U2 = 2, CH_LIGHT_INDEX = 3,
                   CH_LIGHT_U1 = 4, CH_LIGHT_U2 = 5, CH_RR = 6, CH_JITTER_X = 7,
                   CH_JITTER_Y = 8;

enum Kind {
  DIFFUSE = 0,
  SMOOTH_DIELECTRIC = 1,
  SMOOTH_CONDUCTOR = 2,
  SMOOTH_PLASTIC = 3,
  ROUGH_CONDUCTOR = 4,
  SMOOTH_FLOOR = 5,
  ROUGH_FLOOR = 6,
  ROUGH_PLASTIC = 7,
};

constexpr float kPi = gst::kPi;
constexpr double kPiD = 3.14159265358979323846;  // Python's math.pi

struct Params {
  int width, height, spp, max_depth, rr_start_depth, n_tris, n_lights;
  int nee, jitter, mis_exact;
  unsigned int ts;
  float rr_clamp_min, firefly_clamp, shadow_eps, origin_eps;
};

// ------------------------------------------------ sampling / microfacet ---
__device__ __forceinline__ float safe_div(float a, float b) {
  const float mag = fmaxf(fabsf(b), 1e-12f);
  return a / (b < 0.0f ? -mag : mag);
}

__device__ V3 cosine_hemisphere(float u1, float u2) {
  const float ux = 2.0f * u1 - 1.0f;
  const float uy = 2.0f * u2 - 1.0f;
  const bool use_x = fabsf(ux) > fabsf(uy);
  const float r = use_x ? ux : uy;
  const float th = use_x ? (float)(kPiD / 4.0) * safe_div(uy, ux)
                         : (float)(kPiD / 2.0) - (float)(kPiD / 4.0) * safe_div(ux, uy);
  const bool at_origin = (ux == 0.0f) && (uy == 0.0f);
  const float x = at_origin ? 0.0f : r * cosf(th);
  const float y = at_origin ? 0.0f : r * sinf(th);
  const float z = sqrtf(fmaxf(1e-24f, 1.0f - x * x - y * y));
  return v3(x, y, z);
}

__device__ __forceinline__ float cosine_pdf(V3 w) { return fmaxf(fabsf(w.z) / kPi, 1e-6f); }

__device__ V3 half_beckmann(float u1, float u2, float alpha) {
  const float phi = (float)(2.0 * kPiD) * u1;
  const float log_sample = logf(fmaxf(1.0f - u2, 1e-12f));
  const float tan2 = -alpha * alpha * log_sample;
  const float cost = 1.0f / sqrtf(1.0f + tan2);
  const float sint = sqrtf(fmaxf(1e-24f, 1.0f - cost * cost));
  return v3(cosf(phi) * sint, sinf(phi) * sint, cost);
}

__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float denom = f * f + g * g;
  return denom > 0.0f ? f * f / fmaxf(denom, 1e-12f) : 0.0f;
}

__device__ __forceinline__ V3 reflect_local(V3 wo) { return v3(-wo.x, -wo.y, wo.z); }

__device__ float beckmann_d(V3 wh, float alpha) {
  const float cos2 = fmaxf(wh.z * wh.z, 1e-12f);
  const float tan2 = (wh.x * wh.x + wh.y * wh.y) / cos2;
  const float a = expf(-tan2 / fmaxf(alpha * alpha, 1e-12f));
  const float b = kPi * alpha * alpha * cos2 * cos2;
  return a / fmaxf(b, 1e-12f);
}

__device__ float ggx_d(V3 wh, float alpha) {
  const float cos2 = wh.z * wh.z;
  const bool grazing = cos2 <= 1e-12f;
  const float cos2s = fmaxf(cos2, 1e-12f);
  const float tan2 = (wh.x * wh.x + wh.y * wh.y) / cos2s;
  const float b = 1.0f + tan2 / fmaxf(alpha * alpha, 1e-12f);
  const float a = kPi * alpha * alpha * cos2s * cos2s * b * b;
  return grazing ? 0.0f : 1.0f / fmaxf(a, 1e-12f);
}

__device__ float ggx_lambda(V3 w, float alpha) {
  const float cos2 = w.z * w.z;
  const bool grazing = cos2 <= 1e-12f;
  const float cos2s = fmaxf(cos2, 1e-12f);
  const float tan2 = (w.x * w.x + w.y * w.y) / cos2s;
  const float a = -1.0f + sqrtf(fmaxf(1.0f + alpha * alpha * tan2, 1e-24f));
  return grazing ? 0.0f : 0.5f * a;
}

__device__ __forceinline__ float ggx_masking(V3 wo, V3 wi, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha));
}

__device__ float fresnel_dielectric_exact(float no, float cos_tho, float nt, float cos_tht) {
  const float a = nt * cos_tho - no * cos_tht;
  const float ad = nt * cos_tho + no * cos_tht;
  const float b = no * cos_tho - nt * cos_tht;
  const float bd = no * cos_tho + nt * cos_tht;
  const float A = (a * a) / fmaxf(ad * ad, 1e-12f);
  const float B = (b * b) / fmaxf(bd * bd, 1e-12f);
  return 0.5f * (A + B);
}

__device__ float fresnel_dielectric(float cos_tho, float no, float nt) {
  cos_tho = fabsf(cos_tho);
  const float sin_tho = sqrtf(fmaxf(1.0f - cos_tho * cos_tho, 1e-24f));
  const float sqrt_term = 1.0f - ((no * no) / (nt * nt)) * (sin_tho * sin_tho);
  const bool tir = sqrt_term <= 0.0f;
  const float cos_tht = sqrtf(fmaxf(tir ? 1.0f : sqrt_term, 1e-24f));
  const float fr = fresnel_dielectric_exact(no, cos_tho, nt, cos_tht);
  return tir ? 1.0f : fr;
}

__device__ float fresnel_conductor_1(float cos_th, float eta, float k) {
  cos_th = fabsf(cos_th);
  const float cos2 = cos_th * cos_th;
  const float sin2 = 1.0f - cos2;
  const float eta2 = eta * eta;
  const float k2 = k * k;
  const float t0 = eta2 - k2 - sin2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * eta2 * k2, 1e-24f));
  const float t1 = a2b2 + cos2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 1e-24f));
  const float t2 = 2.0f * a * cos_th;
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-12f);
  const float t3 = cos2 * a2b2 + sin2 * sin2;
  const float t4 = t2 * sin2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-12f);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float schlick_fresnel(float r0, float cos_tho) {
  const float a = 1.0f - cos_tho;
  const float a5 = a * a * a * a * a;
  return r0 + a5 * (1.0f - r0);
}

__device__ float coupled_diffuse_term(float r0, float cos_tho, float cos_thi) {
  const float k = 21.0f / ((float)(20.0 * kPiD) * fmaxf(1.0f - r0, 1e-6f));
  const float a = 1.0f - cos_tho;
  const float b = 1.0f - cos_thi;
  const float a5 = a * a * a * a * a;
  const float b5 = b * b * b * b * b;
  return k * (1.0f - a5) * (1.0f - b5);
}

__device__ float fresnel_blend_diffuse_term(float r0, float cos_tho, float cos_thi) {
  const float k = (float)(28.0 / (23.0 * kPiD));
  const float a = 1.0f - 0.5f * cos_tho;
  const float b = 1.0f - 0.5f * cos_thi;
  const float a5 = a * a * a * a * a;
  const float b5 = b * b * b * b * b;
  return k * (1.0f - r0) * (1.0f - a5) * (1.0f - b5);
}

__device__ __forceinline__ float internal_scatter_escape_fraction(float r0, float no, float nt) {
  const float re = ((float)(kPiD * 20.0) * r0 + 1.0f) / 21.0f;
  const float eta = no / nt;
  return 1.0f - eta * eta * (1.0f - re);
}

// ------------------------------------------------------------- BSDFs -----
// mega.py:310-597 (bsdf/dispatch.py semantics).  p = the 12 params of the
// hit triangle's BSDF row.
struct Sample {
  V3 wi, f;
  float pdf;
  bool delta;
};

__device__ __forceinline__ V3 plastic_diffuse(const float* p, float s, float ri) {
  // kd * s * safe_inv(pi * (1 - kd * ri)), per channel
  return v3(p[0] * s * safe_inv(kPi * (1.0f - p[0] * ri)),
            p[1] * s * safe_inv(kPi * (1.0f - p[1] * ri)),
            p[2] * s * safe_inv(kPi * (1.0f - p[2] * ri)));
}

__device__ V3 rough_common_wi(V3 wo, float u_sel, float u1, float u2, float alpha) {
  V3 wh = half_beckmann(u1, u2, alpha);
  if (wh.z <= 0.0f) wh = neg(wh);
  const V3 wi_spec = normalize(add(neg(wo), scale(wh, 2.0f * dot(wh, wo))));
  const V3 wi_d = cosine_hemisphere(u1, u2);
  return u_sel < 0.5f ? wi_spec : wi_d;
}

__device__ void rough_plastic_f_pdf(const float* p, V3 wo, V3 wi, bool eval_clamp, V3& f,
                                    float& pdf) {
  const float ior_in = p[3], ior_out = p[4], r0 = p[5], alpha = p[6];
  const float no = ior_out, nt = fmaxf(ior_in, 1e-6f);
  const float eta = no / nt;
  const V3 wh = normalize(add(wi, wo));
  const float fri = fresnel_dielectric(fabsf(dot(wh, wo)), no, nt);
  const float fro = fresnel_dielectric(fabsf(dot(wh, wi)), no, nt);
  const float ri = internal_scatter_escape_fraction(r0, no, nt);
  const float spec = (fri * ggx_d(wh, alpha) * ggx_masking(wo, wi, alpha)) *
                     safe_inv(4.0f * fabsf(wo.z) * fabsf(wi.z));
  const float s = (1.0f - fri) * (1.0f - fro) * eta * eta;
  const V3 d = plastic_diffuse(p, s, ri);
  float bd = beckmann_d(wh, alpha) * fabsf(wh.z);
  if (eval_clamp) bd = fmaxf(bd, 0.01f);
  pdf = 0.5f * bd * safe_inv(4.0f * fabsf(dot(wo, wh))) + 0.5f * cosine_pdf(wi);
  f = v3(d.x + spec, d.y + spec, d.z + spec);
}

__device__ void rough_floor_f_pdf(const float* p, V3 wo, V3 wi, V3& f, float& pdf) {
  const float r0 = p[3], alpha = p[4];
  const V3 wh = normalize(add(wi, wo));
  const float fr = schlick_fresnel(r0, fabsf(dot(wo, wh)));
  const float dterm = fresnel_blend_diffuse_term(r0, fabsf(wo.z), fabsf(wi.z));
  const float spec = fr * ggx_d(wh, alpha) *
                     safe_inv(4.0f * fabsf(dot(wo, wh)) * fmaxf(fabsf(wo.z), fabsf(wi.z)));
  pdf = 0.5f * beckmann_d(wh, alpha) * fabsf(wh.z) * safe_inv(4.0f * fabsf(dot(wo, wh))) +
        0.5f * cosine_pdf(wi);
  f = v3(p[0] * dterm + spec, p[1] * dterm + spec, p[2] * dterm + spec);
}

__device__ Sample sample_bsdf(int kind, const float* p, V3 wo, float u_sel, float u1, float u2) {
  Sample s;
  switch (kind) {
    case SMOOTH_DIELECTRIC: {
      const float ior_in = fmaxf(p[0], 1e-2f), ior_out = fmaxf(p[1], 1e-2f);
      const bool entering = wo.z > 0.0f;
      const float no = entering ? ior_out : ior_in;
      const float nt = entering ? ior_in : ior_out;
      const float cos_tho = wo.z;
      const float nz = entering ? 1.0f : -1.0f;
      // refract about (0, 0, nz) (mega.py:_refract_local_z)
      const float sin_tho = sqrtf(fmaxf(wo.x * wo.x + wo.y * wo.y, 1e-24f));
      const float sqrt_term = 1.0f - ((no * no) / (nt * nt)) * (sin_tho * sin_tho);
      const bool ok = sqrt_term > 0.0f;
      const float cos_tht = sqrtf(fmaxf(ok ? sqrt_term : 1.0f, 1e-24f));
      const float eta = no / nt;
      const float coef = eta * (wo.z * nz) - cos_tht;
      const V3 wt = v3(-eta * wo.x, -eta * wo.y, -eta * wo.z + coef * nz);
      float fr = fresnel_dielectric_exact(no, fabsf(cos_tho), nt, fabsf(wt.z));
      fr = ok ? fr : 1.0f;
      const bool reflecting = (!ok) || (u_sel < fr);
      s.wi = reflecting ? reflect_local(wo) : wt;
      const float f_reflect = (ok ? fr : 1.0f) * safe_inv(fabsf(cos_tho));
      const float eta2 = (no * no) * safe_inv(nt * nt);
      const float f_refract = eta2 * (1.0f - fr) * safe_inv(fabsf(wt.z));
      const float f_s = reflecting ? f_reflect : f_refract;
      s.f = v3(f_s, f_s, f_s);
      s.pdf = reflecting ? (ok ? fr : 1.0f) : 1.0f - fr;
      s.delta = true;
      break;
    }
    case SMOOTH_CONDUCTOR: {
      const float ior_in = p[0], ior_out = p[1];
      const float aw = fabsf(wo.z);
      const float fr =
          ior_in == 0.0f ? 1.0f : fresnel_dielectric(aw, ior_out, fmaxf(ior_in, 1e-6f));
      s.wi = reflect_local(wo);
      const float f_s = fr * safe_inv(aw);
      s.f = v3(f_s, f_s, f_s);
      s.pdf = 1.0f;
      s.delta = true;
      break;
    }
    case SMOOTH_PLASTIC: {
      const float ior_in = p[3], ior_out = p[4], r0 = p[5];
      const float no = ior_out, nt = fmaxf(ior_in, 1e-6f);
      const float aw = fabsf(wo.z);
      const float fri = fresnel_dielectric(aw, no, nt);
      const bool spec = u_sel < fri;
      s.wi = spec ? reflect_local(wo) : cosine_hemisphere(u1, u2);
      const float fro = fresnel_dielectric(fabsf(s.wi.z), no, nt);
      const float ri = internal_scatter_escape_fraction(r0, no, nt);
      const float eta = no / nt;
      const float sc = eta * eta * (1.0f - fri) * (1.0f - fro);
      const float f_spec = fri * safe_inv(aw);
      s.f = spec ? v3(f_spec, f_spec, f_spec) : plastic_diffuse(p, sc, ri);
      s.pdf = spec ? fri : (1.0f - fri) * cosine_pdf(s.wi);
      s.delta = spec;
      break;
    }
    case ROUGH_CONDUCTOR: {
      const float alpha = p[9];
      const float aw = fabsf(wo.z);
      V3 wh = half_beckmann(u1, u2, alpha);
      if (wh.z <= 0.0f) wh = neg(wh);
      s.wi = normalize(add(neg(wo), scale(wh, 2.0f * dot(wh, wo))));
      const float denom = 4.0f * fabsf(s.wi.z) * aw;
      const float sc = ggx_d(wh, alpha) * ggx_masking(wo, s.wi, alpha) * safe_inv(denom);
      s.f = v3(p[6] * fresnel_conductor_1(aw, p[0], p[3]) * sc,
               p[7] * fresnel_conductor_1(aw, p[1], p[4]) * sc,
               p[8] * fresnel_conductor_1(aw, p[2], p[5]) * sc);
      s.pdf = beckmann_d(wh, alpha) * fabsf(wh.z) * safe_inv(4.0f * fabsf(dot(wo, wh)));
      s.delta = false;
      break;
    }
    case SMOOTH_FLOOR: {
      const float r0 = p[3];
      const float aw = fabsf(wo.z);
      const float fr = schlick_fresnel(r0, aw);
      const bool spec = u_sel < fr;
      s.wi = spec ? reflect_local(wo) : cosine_hemisphere(u1, u2);
      const float coupled = coupled_diffuse_term(r0, aw, fabsf(s.wi.z));
      const V3 f_diff = v3(p[0] * coupled, p[1] * coupled, p[2] * coupled);
      const float add_s = fr * safe_inv(aw);
      s.f = spec ? v3(f_diff.x + add_s, f_diff.y + add_s, f_diff.z + add_s) : f_diff;
      s.pdf = spec ? fr : (1.0f - fr) * cosine_pdf(s.wi);
      s.delta = spec;
      break;
    }
    case ROUGH_FLOOR: {
      s.wi = rough_common_wi(wo, u_sel, u1, u2, p[4]);
      rough_floor_f_pdf(p, wo, s.wi, s.f, s.pdf);
      s.delta = false;
      break;
    }
    case ROUGH_PLASTIC: {
      s.wi = rough_common_wi(wo, u_sel, u1, u2, p[6]);
      rough_plastic_f_pdf(p, wo, s.wi, false, s.f, s.pdf);
      s.delta = false;
      break;
    }
    default: {  // DIFFUSE
      s.wi = cosine_hemisphere(u1, u2);
      const float inv_pi = (float)(1.0 / kPiD);
      s.f = v3(p[0] * inv_pi, p[1] * inv_pi, p[2] * inv_pi);
      s.pdf = cosine_pdf(s.wi);
      s.delta = false;
      break;
    }
  }
  return s;
}

// f of the BSDF for a given direction pair (the NEE direction)
__device__ V3 eval_bsdf(int kind, const float* p, V3 wo, V3 wi) {
  switch (kind) {
    case SMOOTH_DIELECTRIC:
    case SMOOTH_CONDUCTOR:
      return v3(0.0f, 0.0f, 0.0f);
    case SMOOTH_PLASTIC: {
      const float ior_in = p[3], ior_out = p[4], r0 = p[5];
      const float no = ior_out, nt = fmaxf(ior_in, 1e-6f);
      const float fri = fresnel_dielectric(fabsf(wo.z), no, nt);
      const float fro = fresnel_dielectric(fabsf(wi.z), no, nt);
      const float ri = internal_scatter_escape_fraction(r0, no, nt);
      const float eta = no / nt;
      const float sc = (1.0f - fri) * (1.0f - fro) * eta * eta;
      return plastic_diffuse(p, sc, ri);
    }
    case ROUGH_CONDUCTOR: {
      const float alpha = p[9];
      const float aw = fabsf(wo.z);
      const V3 wh = normalize(add(wo, wi));
      const float denom = 4.0f * fabsf(wi.z) * aw;
      const float sc = ggx_d(wh, alpha) * ggx_masking(wo, wi, alpha) * safe_inv(denom);
      return v3(fresnel_conductor_1(aw, p[0], p[3]) * p[6] * sc,
                fresnel_conductor_1(aw, p[1], p[4]) * p[7] * sc,
                fresnel_conductor_1(aw, p[2], p[5]) * p[8] * sc);
    }
    case SMOOTH_FLOOR: {
      const float c = coupled_diffuse_term(p[3], fabsf(wo.z), fabsf(wi.z));
      return v3(p[0] * c, p[1] * c, p[2] * c);
    }
    case ROUGH_FLOOR: {
      V3 f;
      float pdf;
      rough_floor_f_pdf(p, wo, wi, f, pdf);
      return f;
    }
    case ROUGH_PLASTIC: {
      V3 f;
      float pdf;
      rough_plastic_f_pdf(p, wo, wi, true, f, pdf);
      return f;
    }
    default:  // DIFFUSE
      return v3(p[0] / kPi, p[1] / kPi, p[2] / kPi);
  }
}

// ------------------------------------------------------------ kernel -----
__global__ void __launch_bounds__(kThreads)
mega_kernel(const int* __restrict__ pix, int n_lanes, const float* __restrict__ woop_t,
            int t_stride, const float* __restrict__ attr, const float* __restrict__ light,
            const float* __restrict__ cam, Params P, float* __restrict__ rad_r,
            float* __restrict__ rad_g, float* __restrict__ rad_b, int* __restrict__ rays_out) {
  extern __shared__ float sw[];  // (12, n_tris) Woop rows
  const int n = P.n_tris;
  for (int i = threadIdx.x; i < 12 * n; i += blockDim.x) {
    sw[i] = woop_t[(size_t)(i / n) * t_stride + (i % n)];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;

  // camera (scene/camera.py semantics, rsqrt form of mega.py:1221-1242)
  const float r00 = cam[0], r01 = cam[1], r02 = cam[2];
  const float r10 = cam[3], r11 = cam[4], r12 = cam[5];
  const float r20 = cam[6], r21 = cam[7], r22 = cam[8];
  const V3 cam_o = v3(cam[9], cam[10], cam[11]);
  const float zplane = (float)(max(P.width, P.height) / 2.0) / tanf(cam[12] / 2.0f);
  const uint32_t pixel = (uint32_t)pix[lane];
  const float px0 = (float)(pixel % (uint32_t)P.width);
  const float py0 = (float)(pixel / (uint32_t)P.width);
  const float half_w = (float)(P.width / 2.0), half_h = (float)(P.height / 2.0);
  const float sel_pdf = (float)(1.0 / P.n_lights);

  uint32_t sample = 0, depth = 0, seed;
  V3 o, d;
  auto fresh = [&]() {
    seed = gst::pixel_seed(pixel, P.ts + sample);
    float px = px0, py = py0;
    if (P.jitter) {
      px = px + gst::uniform(seed, 0xFFFFu, CH_JITTER_X);
      py = py + gst::uniform(seed, 0xFFFFu, CH_JITTER_Y);
    }
    const float xx = px - half_w;
    const float yy = py - half_h;
    const float inv = rsqrtf(xx * xx + yy * yy + zplane * zplane);
    const float dcx = -xx * inv, dcy = -yy * inv, dcz = zplane * inv;
    d = v3(r00 * dcx + r01 * dcy + r02 * dcz, r10 * dcx + r11 * dcy + r12 * dcz,
           r20 * dcx + r21 * dcy + r22 * dcz);
    o = cam_o;
  };
  fresh();
  V3 w = v3(1.0f, 1.0f, 1.0f);
  float direct_weight = 1.0f, prev_pdf = 1.0f;
  bool prev_nee = false, was_delta = false, count_emitted = true;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;

  while (true) {
    const uint32_t bounce = depth;
    bool done;
    // ---- closest hit over every triangle (strict <: lowest id on ties)
    float best_t = gst::kBig, bu = 0.0f, bv = 0.0f;
    int prim = -1;
    for (int i = 0; i < n; ++i) {
      float t, u, v;
      if (gst::woop_test(sw + i, n, o, d, 0.0f, gst::kBig, t, u, v) && t < best_t) {
        best_t = t;
        prim = i;
        bu = u;
        bv = v;
      }
    }
    if (prim < 0) {  // miss: no environment emitter, the path ends
      rays += 1;
      done = true;
    } else {
      const float* a = attr + (size_t)prim * kAttr;
      const V3 n0 = v3(a[0], a[1], a[2]), n1 = v3(a[3], a[4], a[5]), n2 = v3(a[6], a[7], a[8]);
      const V3 emission = v3(a[9], a[10], a[11]);
      const bool twofaced = a[12] > 0.5f;
      const int kind = (int)rintf(a[14]);
      float p[12];
#pragma unroll
      for (int c = 0; c < 12; ++c) p[c] = a[15 + c];
      V3 gn = v3(a[27], a[28], a[29]);
      const float t = best_t;
      const V3 position = v3(fmaf(d.x, t, o.x), fmaf(d.y, t, o.y), fmaf(d.z, t, o.z));

      const float bw = 1.0f - bu - bv;
      V3 sn = normalize(add(add(scale(n0, bw), scale(n1, bu)), scale(n2, bv)));
      if (dot(sn, gn) < 0.0f) sn = neg(sn);
      const bool backface = dot(gn, neg(d)) < 0.0f;
      const bool emissive = emission.x != 0.0f || emission.y != 0.0f || emission.z != 0.0f;
      if (backface && twofaced && !emissive) {
        gn = neg(gn);
        sn = neg(sn);
      }
      // shading frame (math3d.onb_create)
      const V3 nn = normalize(sn);
      V3 bn = fabsf(nn.x) > fabsf(nn.z) ? v3(-nn.y, nn.x, 0.0f) : v3(0.0f, -nn.z, nn.y);
      bn = normalize(bn);
      const V3 tg = cross(bn, nn);
      const V3 md = neg(d);
      const V3 wo = normalize(v3(dot(md, tg), dot(md, bn), dot(md, nn)));

      const float u_sel = gst::uniform(seed, bounce, CH_BSDF_SELECT);
      const float u1 = gst::uniform(seed, bounce, CH_BSDF_U1);
      const float u2 = gst::uniform(seed, bounce, CH_BSDF_U2);
      const Sample s = sample_bsdf(kind, p, wo, u_sel, u1, u2);
      const float now_ = fabsf(s.wi.z);
      const V3 wi_world = v3(tg.x * s.wi.x + bn.x * s.wi.y + nn.x * s.wi.z,
                             tg.y * s.wi.x + bn.y * s.wi.y + nn.y * s.wi.z,
                             tg.z * s.wi.x + bn.z * s.wi.y + nn.z * s.wi.z);
      const bool transmission = kind == SMOOTH_DIELECTRIC;

      // ---- light sample (uniform pick, sampling.sample_triangle_light)
      const uint32_t lidx = gst::random_bits(seed, bounce, CH_LIGHT_INDEX) % (uint32_t)P.n_lights;
      const float* lr = light + (size_t)lidx * kLight;
      const V3 lv0 = v3(lr[0], lr[1], lr[2]), lv1 = v3(lr[3], lr[4], lr[5]),
               lv2 = v3(lr[6], lr[7], lr[8]);
      const V3 lemit = v3(lr[9], lr[10], lr[11]);
      const float lu1 = gst::uniform(seed, bounce, CH_LIGHT_U1);
      const float lu2 = gst::uniform(seed, bounce, CH_LIGHT_U2);
      const float su = sqrtf(fmaxf(lu1, 0.0f));
      const float lbu = 1.0f - su;
      const float lbv = lu2 * su;
      const float lbw = 1.0f - lbu - lbv;
      const float larea = 0.5f * fabsf(length(cross(sub(lv2, lv0), sub(lv1, lv0))));
      const V3 lnormal = normalize(cross(sub(lv1, lv0), sub(lv2, lv0)));
      const V3 light_pos = add(add(scale(lv0, lbu), scale(lv1, lbv)), scale(lv2, lbw));
      const V3 ldelta = sub(light_pos, position);
      const float ldist = length(ldelta);
      const V3 ldir = scale(ldelta, 1.0f / fmaxf(ldist, 1e-12f));
      const float cos_light = dot(neg(ldir), lnormal);
      const float lfront = cos_light > 0.0f ? 1.0f : 0.0f;
      const V3 light_emitted = scale(lemit, lfront);
      float light_pdf = ldist * ldist / fmaxf(fabsf(cos_light) * larea, 1e-12f);
      light_pdf = light_pdf * sel_pdf;

      const V3 w_light_local = v3(dot(ldir, tg), dot(ldir, bn), dot(ldir, nn));
      const float nol = fabsf(dot(sn, ldir));
      const V3 f_light = eval_bsdf(kind, p, wo, w_light_local);

      const bool front_ok = (dot(gn, md) > 0.0f) && (dot(gn, ldir) > 0.0f);
      const bool nee_candidate = P.nee && !s.delta && (front_ok || transmission);
      bool shadowed = false;
      if (nee_candidate) {  // any-hit on (eps, ldist - eps), first hit wins
        const float t_hi = ldist - P.shadow_eps;
        for (int i = 0; i < n && !shadowed; ++i) {
          float tt, uu, vv;
          shadowed = gst::woop_test(sw + i, n, position, ldir, P.shadow_eps, t_hi, tt, uu, vv);
        }
      }
      const bool nee_done = nee_candidate && !shadowed && (light_pdf != 0.0f);

      const float w_mis = power_heuristic(light_pdf, s.pdf);
      const float nee_s = w_mis * nol * safe_inv(light_pdf);
      float e_r = nee_done ? nee_s * f_light.x * w.x * light_emitted.x : 0.0f;
      float e_g = nee_done ? nee_s * f_light.y * w.y * light_emitted.y : 0.0f;
      float e_b = nee_done ? nee_s * f_light.z * w.z * light_emitted.z : 0.0f;

      // emitter hit with MIS bookkeeping (rayhit.rchit:760-768)
      const float light_flag = dot(gn, md) > 0.0f ? 1.0f : 0.0f;
      float emit_w = 1.0f;
      if (P.nee && P.mis_exact) {
        const float cos_hit = fabsf(dot(gn, md));
        const float pdf_hit = t * t / fmaxf(cos_hit * a[30], 1e-12f) * sel_pdf;
        const float w_emit = prev_nee ? power_heuristic(prev_pdf, pdf_hit) : 1.0f;
        emit_w = (!count_emitted && !was_delta) ? w_emit : 1.0f;
      } else if (P.nee) {
        emit_w = (!count_emitted && !was_delta) ? direct_weight : 1.0f;
      }
      e_r = e_r + emit_w * (emission.x * light_flag * w.x);
      e_g = e_g + emit_w * (emission.y * light_flag * w.y);
      e_b = e_b + emit_w * (emission.z * light_flag * w.z);

      // termination (rayhit.rchit:770-784)
      const bool invalid_hemi = (dot(wi_world, gn) <= 0.0f) && !transmission;
      const bool self_isect = (dot(gn, md) <= 0.0f) && !transmission;
      const bool bad_pdf = !isfinite(s.pdf) || !gst::finite3(s.f) || (s.pdf == 0.0f);
      const bool terminate = invalid_hemi || self_isect || bad_pdf;

      rays += 1 + (nee_candidate ? 1 : 0);
      if (!terminate) {
        const float new_direct_weight = nee_done ? power_heuristic(s.pdf, light_pdf) : 1.0f;
        const V3 off = dot(gn, neg(wi_world)) < 0.0f ? gn : neg(gn);
        o = v3(fmaf(off.x, P.origin_eps, position.x), fmaf(off.y, P.origin_eps, position.y),
               fmaf(off.z, P.origin_eps, position.z));
        d = wi_world;
        const float w_s = now_ * safe_inv(s.pdf);
        w = v3(w.x * s.f.x * w_s, w.y * s.f.y * w_s, w.z * s.f.z * w_s);
        direct_weight = new_direct_weight;
        prev_pdf = s.pdf;
        prev_nee = nee_done;
        was_delta = s.delta;
        count_emitted = false;
      }
      done = terminate;

      // firefly clamp: drop the bounce's contribution if any channel >= clamp
      if (e_r < P.firefly_clamp && e_g < P.firefly_clamp && e_b < P.firefly_clamp) {
        acc_r += e_r;
        acc_g += e_g;
        acc_b += e_b;
      }

      // Russian roulette (raygen.rgen:66-71)
      if (!done && bounce > (uint32_t)P.rr_start_depth) {
        const float q = fminf(fmaxf(fmaxf(fmaxf(w.x, w.y), w.z), P.rr_clamp_min), 1.0f);
        if (gst::uniform(seed, bounce, CH_RR) > q) {
          done = true;
        } else {
          const float inv_q = 1.0f / q;
          w = v3(w.x * inv_q, w.y * inv_q, w.z * inv_q);
        }
      }
    }

    // depth advance, per-path cutoff, regeneration
    depth = bounce + 1;
    if (done || depth >= (uint32_t)(P.max_depth + 1)) {
      if (sample + 1 >= (uint32_t)P.spp) break;
      sample += 1;
      fresh();
      w = v3(1.0f, 1.0f, 1.0f);
      direct_weight = 1.0f;
      prev_pdf = 1.0f;
      prev_nee = false;
      was_delta = false;
      count_emitted = true;
      depth = 0;
    }
  }
  rad_r[lane] = acc_r;
  rad_g[lane] = acc_g;
  rad_b[lane] = acc_b;
  rays_out[lane] = rays;
}

}  // namespace

extern "C" int gst_mega(const int* pix, int n_lanes, const float* woop_t, int t_stride,
                        const float* attr, const float* light, const float* cam, int width,
                        int height, int spp, int max_depth, int rr_start_depth, int n_tris,
                        int n_lights, int nee, int jitter, int mis_exact, unsigned int ts,
                        float rr_clamp_min, float firefly_clamp, float shadow_eps,
                        float origin_eps, float* rad_r, float* rad_g, float* rad_b, int* rays,
                        void* stream) {
  if (n_lanes == 0) return 0;
  Params P{width, height, spp, max_depth, rr_start_depth, n_tris, n_lights, nee, jitter,
           mis_exact, ts, rr_clamp_min, firefly_clamp, shadow_eps, origin_eps};
  const size_t smem = sizeof(float) * 12 * (size_t)n_tris;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  mega_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      pix, n_lanes, woop_t, t_stride, attr, light, cam, P, rad_r, rad_g, rad_b, rays);
  return (int)cudaGetLastError();
}
