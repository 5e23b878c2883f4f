// The per-lane path tracer shared by the two megakernels: K1 (mega.cu,
// brute-force intersection over a shared-memory Woop table) and K4
// (mega_bvh.cu, the preorder BVH walk of bvh.cuh).  They differ only in the
// intersector passed to render_lane, as the TPU kernels share
// gpuspectral_tpu/integrator/mega.py:make_bounce_body.
//
// One thread owns one pixel lane and runs its spp samples back to back: the
// camera ray, the closest hit, the 8-BSDF sample and eval (with optional
// texture modulation), NEE over the area lights mixed with the environment
// emitter, power-heuristic MIS, the firefly clamp, Russian roulette, and
// regeneration of the next sample the moment a path ends.  Path state lives
// in registers; device memory sees the pixel id going in, table reads, and
// four sums coming out.
//
// Semantics kept exactly (gpuspectral_tpu/integrator/mega.py line numbers):
// RNG channels (72-84); camera with rsqrt (1221-1242); orientation and
// two-faced flip (881-891); light sample (910-926); environment NEE mixture
// (928-981); shadow interval (eps, ldist - eps) (990-995); MIS (998-1034);
// environment miss shading (1041-1064); one ray per live lane plus one per
// NEE candidate (1081); the strict per-channel firefly test (1102); RR on
// bounce > rr_start_depth (1118-1128); termination at depth >= max_depth + 1
// (1133).  The environment functions repeat integrator/envmap.py op for op
// (the polynomial arccos, never acosf), and the power light pick is a binary
// search giving torch.searchsorted's side="left" index.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace gst {

// RNG channels (path_tracer.CH_*)
constexpr uint32_t CH_BSDF_SELECT = 0, CH_BSDF_U1 = 1, CH_BSDF_U2 = 2, CH_LIGHT_INDEX = 3,
                   CH_LIGHT_U1 = 4, CH_LIGHT_U2 = 5, CH_RR = 6, CH_JITTER_X = 7,
                   CH_JITTER_Y = 8, CH_ENV_U1 = 9, CH_ENV_U2 = 10, CH_ENV_SELECT = 11;

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

constexpr double kPiD = 3.14159265358979323846;  // Python's math.pi
constexpr int kLight = 12;  // light row: 9 vertex coordinates, 3 emission

// ------------------------------------------------ sampling / microfacet ---
__device__ __forceinline__ float safe_div(float a, float b) {
  const float mag = fmaxf(fabsf(b), 1e-12f);
  return a / (b < 0.0f ? -mag : mag);
}

__device__ inline V3 cosine_hemisphere(float u1, float u2) {
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

__device__ inline V3 half_beckmann(float u1, float u2, float alpha) {
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

__device__ inline float beckmann_d(V3 wh, float alpha) {
  const float cos2 = fmaxf(wh.z * wh.z, 1e-12f);
  const float tan2 = (wh.x * wh.x + wh.y * wh.y) / cos2;
  const float a = expf(-tan2 / fmaxf(alpha * alpha, 1e-12f));
  const float b = kPi * alpha * alpha * cos2 * cos2;
  return a / fmaxf(b, 1e-12f);
}

__device__ inline float ggx_d(V3 wh, float alpha) {
  const float cos2 = wh.z * wh.z;
  const bool grazing = cos2 <= 1e-12f;
  const float cos2s = fmaxf(cos2, 1e-12f);
  const float tan2 = (wh.x * wh.x + wh.y * wh.y) / cos2s;
  const float b = 1.0f + tan2 / fmaxf(alpha * alpha, 1e-12f);
  const float a = kPi * alpha * alpha * cos2s * cos2s * b * b;
  return grazing ? 0.0f : 1.0f / fmaxf(a, 1e-12f);
}

__device__ inline float ggx_lambda(V3 w, float alpha) {
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

__device__ inline float fresnel_dielectric_exact(float no, float cos_tho, float nt,
                                                 float cos_tht) {
  const float a = nt * cos_tho - no * cos_tht;
  const float ad = nt * cos_tho + no * cos_tht;
  const float b = no * cos_tho - nt * cos_tht;
  const float bd = no * cos_tho + nt * cos_tht;
  const float A = (a * a) / fmaxf(ad * ad, 1e-12f);
  const float B = (b * b) / fmaxf(bd * bd, 1e-12f);
  return 0.5f * (A + B);
}

__device__ inline float fresnel_dielectric(float cos_tho, float no, float nt) {
  cos_tho = fabsf(cos_tho);
  const float sin_tho = sqrtf(fmaxf(1.0f - cos_tho * cos_tho, 1e-24f));
  const float sqrt_term = 1.0f - ((no * no) / (nt * nt)) * (sin_tho * sin_tho);
  const bool tir = sqrt_term <= 0.0f;
  const float cos_tht = sqrtf(fmaxf(tir ? 1.0f : sqrt_term, 1e-24f));
  const float fr = fresnel_dielectric_exact(no, cos_tho, nt, cos_tht);
  return tir ? 1.0f : fr;
}

__device__ inline float fresnel_conductor_1(float cos_th, float eta, float k) {
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

__device__ inline float coupled_diffuse_term(float r0, float cos_tho, float cos_thi) {
  const float k = 21.0f / ((float)(20.0 * kPiD) * fmaxf(1.0f - r0, 1e-6f));
  const float a = 1.0f - cos_tho;
  const float b = 1.0f - cos_thi;
  const float a5 = a * a * a * a * a;
  const float b5 = b * b * b * b * b;
  return k * (1.0f - a5) * (1.0f - b5);
}

__device__ inline float fresnel_blend_diffuse_term(float r0, float cos_tho, float cos_thi) {
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

__device__ inline V3 rough_common_wi(V3 wo, float u_sel, float u1, float u2, float alpha) {
  V3 wh = half_beckmann(u1, u2, alpha);
  if (wh.z <= 0.0f) wh = neg(wh);
  const V3 wi_spec = normalize(add(neg(wo), scale(wh, 2.0f * dot(wh, wo))));
  const V3 wi_d = cosine_hemisphere(u1, u2);
  return u_sel < 0.5f ? wi_spec : wi_d;
}

__device__ inline void rough_plastic_f_pdf(const float* p, V3 wo, V3 wi, bool eval_clamp, V3& f,
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

__device__ inline void rough_floor_f_pdf(const float* p, V3 wo, V3 wi, V3& f, float& pdf) {
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

__device__ inline Sample sample_bsdf(int kind, const float* p, V3 wo, float u_sel, float u1,
                                     float u2) {
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

// f and pdf of the BSDF for a given direction pair (the NEE direction);
// bsdf/dispatch.py:eval_bsdf
__device__ inline V3 eval_bsdf(int kind, const float* p, V3 wo, V3 wi, float& pdf) {
  switch (kind) {
    case SMOOTH_DIELECTRIC:
    case SMOOTH_CONDUCTOR:
      pdf = 1.0f;
      return v3(0.0f, 0.0f, 0.0f);
    case SMOOTH_PLASTIC: {
      const float ior_in = p[3], ior_out = p[4], r0 = p[5];
      const float no = ior_out, nt = fmaxf(ior_in, 1e-6f);
      const float fri = fresnel_dielectric(fabsf(wo.z), no, nt);
      const float fro = fresnel_dielectric(fabsf(wi.z), no, nt);
      const float ri = internal_scatter_escape_fraction(r0, no, nt);
      const float eta = no / nt;
      const float sc = (1.0f - fri) * (1.0f - fro) * eta * eta;
      pdf = (1.0f - fri) * cosine_pdf(wi);
      return plastic_diffuse(p, sc, ri);
    }
    case ROUGH_CONDUCTOR: {
      const float alpha = p[9];
      const float aw = fabsf(wo.z);
      const V3 wh = normalize(add(wo, wi));
      const float denom = 4.0f * fabsf(wi.z) * aw;
      const float sc = ggx_d(wh, alpha) * ggx_masking(wo, wi, alpha) * safe_inv(denom);
      pdf = beckmann_d(wh, alpha) * fabsf(wh.z) * safe_inv(4.0f * fabsf(dot(wo, wh)));
      return v3(fresnel_conductor_1(aw, p[0], p[3]) * p[6] * sc,
                fresnel_conductor_1(aw, p[1], p[4]) * p[7] * sc,
                fresnel_conductor_1(aw, p[2], p[5]) * p[8] * sc);
    }
    case SMOOTH_FLOOR: {
      const float fr = schlick_fresnel(p[3], fabsf(wo.z));
      const float c = coupled_diffuse_term(p[3], fabsf(wo.z), fabsf(wi.z));
      pdf = (1.0f - fr) * cosine_pdf(wi);
      return v3(p[0] * c, p[1] * c, p[2] * c);
    }
    case ROUGH_FLOOR: {
      V3 f;
      rough_floor_f_pdf(p, wo, wi, f, pdf);
      return f;
    }
    case ROUGH_PLASTIC: {
      V3 f;
      rough_plastic_f_pdf(p, wo, wi, true, f, pdf);
      return f;
    }
    default:  // DIFFUSE
      pdf = cosine_pdf(wi);
      return v3(p[0] / kPi, p[1] / kPi, p[2] / kPi);
  }
}

// ------------------------------------------------------- environment -----
// integrator/envmap.py, op for op.  `rot` is the row-major world->env
// rotation; rgb (h*w, 3), cdf (h*w,) and pdf (h*w,) the texel tables
// (scene/data.py:_env_tables).  The texel CDF is inverted by binary search.
struct Env {
  const float* rot;
  const float* rgb;
  const float* cdf;
  const float* pdf;
  int h, w;
};

__device__ inline float acos_fast(float x) {
  const float ax = fabsf(x);
  float p = -0.0187293f;
  p = p * ax + 0.0742610f;
  p = p * ax - 0.2121144f;
  p = p * ax + 1.5707288f;
  const float r = sqrtf(fmaxf(1.0f - ax, 0.0f)) * p;
  return x < 0.0f ? kPi - r : r;
}

__device__ inline void env_uv(const Env& e, V3 d, float& u, float& v) {
  const float* r = e.rot;
  const float ex = r[0] * d.x + r[1] * d.y + r[2] * d.z;
  const float ey = r[3] * d.x + r[4] * d.y + r[5] * d.z;
  const float ez = r[6] * d.x + r[7] * d.y + r[8] * d.z;
  const float rr = sqrtf(ex * ex + ez * ez);
  const float c = fminf(fmaxf(-ez / fmaxf(rr, 1e-20f), -1.0f), 1.0f);
  const float phi = (ex < 0.0f ? -1.0f : 1.0f) * acos_fast(c);
  u = (1.0f + phi / kPi) * 0.5f;
  v = acos_fast(fminf(fmaxf(ey, -1.0f), 1.0f)) / kPi;
}

__device__ inline V3 env_eval(const Env& e, V3 d) {
  float u, v;
  env_uv(e, d, u, v);
  const float fx = u * (float)e.w - 0.5f;
  const float fy = v * (float)e.h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  int x0i = (int)x0 % e.w;
  if (x0i < 0) x0i += e.w;
  const int x1i = (x0i + 1) % e.w;
  const int y0u = (int)y0;
  const int y0i = min(max(y0u, 0), e.h - 1);
  const int y1i = min(max(y0u + 1, 0), e.h - 1);
  const float* c00 = e.rgb + 3 * (y0i * e.w + x0i);
  const float* c01 = e.rgb + 3 * (y0i * e.w + x1i);
  const float* c10 = e.rgb + 3 * (y1i * e.w + x0i);
  const float* c11 = e.rgb + 3 * (y1i * e.w + x1i);
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = c00[k] * (1.0f - tx) + c01[k] * tx;
    const float bot = c10[k] * (1.0f - tx) + c11[k] * tx;
    out[k] = top * (1.0f - ty) + bot * ty;
  }
  return v3(out[0], out[1], out[2]);
}

__device__ inline float env_pdf(const Env& e, V3 d) {
  float u, v;
  env_uv(e, d, u, v);
  const int x = min(max((int)(u * (float)e.w), 0), e.w - 1);
  const int y = min(max((int)(v * (float)e.h), 0), e.h - 1);
  return e.pdf[y * e.w + x];
}

// sample_envmap: texel by CDF inversion (searchsorted side="left"), the
// direction uniform in solid angle inside it; returns the world direction
__device__ inline V3 env_sample(const Env& e, float u1, float u2, float& pdf) {
  const int n = e.h * e.w;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e.cdf[mid] < u1) lo = mid + 1; else hi = mid;
  }
  const int idx = min(lo, n - 1);
  const float c_hi = e.cdf[idx];
  const float c_lo = idx > 0 ? e.cdf[idx - 1] : 0.0f;
  const float jv = fminf(fmaxf((u1 - c_lo) / fmaxf(c_hi - c_lo, 1e-12f), 0.0f), 1.0f);
  const int y = idx / e.w;
  const int x = idx - y * e.w;
  const float yf = (float)y;
  const float u = ((float)x + u2) / (float)e.w;
  const float phi = (2.0f * u - 1.0f) * kPi;
  const float c0 = cosf(kPi * yf / (float)e.h);
  const float c1 = cosf(kPi * (yf + 1.0f) / (float)e.h);
  const float cos_t = c0 + jv * (c1 - c0);
  const float ct = fminf(fmaxf(cos_t, -1.0f), 1.0f);
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float e0 = st * sinf(phi), e1 = ct, e2 = -st * cosf(phi);
  const float* r = e.rot;  // env->world is the transpose
  pdf = e.pdf[idx];
  return v3(e0 * r[0] + e1 * r[3] + e2 * r[6], e0 * r[1] + e1 * r[4] + e2 * r[7],
            e0 * r[2] + e1 * r[5] + e2 * r[8]);
}

// ------------------------------------------------------ lane tracer -----
// Integer parameters arrive as one int array in this order (the wrappers in
// integrator/mega.py and integrator/mega_bvh.py build it).
enum IParam {
  IP_WIDTH, IP_HEIGHT, IP_SPP, IP_MAX_DEPTH, IP_RR_START, IP_N_LIGHTS, IP_NEE, IP_JITTER,
  IP_MIS_EXACT, IP_POWER_PICK, IP_HAS_ENV, IP_HAS_AREA, IP_ENV_H, IP_ENV_W, IP_TEXTURED,
  IP_ATTR_STRIDE, IP_TS, IP_COUNT
};
enum FParam { FP_RR_CLAMP_MIN, FP_FIREFLY, FP_SHADOW_EPS, FP_ORIGIN_EPS, FP_COUNT };

struct Params {
  int width, height, spp, max_depth, rr_start_depth, n_lights;
  int nee, jitter, mis_exact, power_pick, has_env, has_area, textured, attr_stride;
  unsigned int ts;
  float rr_clamp_min, firefly_clamp, shadow_eps, origin_eps;
};

// Scene tables.  attr: (T, attr_stride) row-major, rows 0-8 corner normals,
// 9-11 emission, 12 twofaced, 13 light idx, 14 bsdf kind, 15-26 bsdf params,
// 27-29 geometric normal, 30 area, 31 light-selection pdf of the triangle's
// emitter, 32-40 per-corner texture colours (textured scenes).  light:
// (L, 12); light_cdf / light_prob (L,); cam (13,): rotation, origin, fov.
struct Tables {
  const float* attr;
  const float* light;
  const float* light_cdf;
  const float* light_prob;
  const float* cam;
  Env env;
};

// Host side: unpack the parameter arrays and the environment table
// ([rot 9 | rgb h*w*3 | cdf h*w | pdf h*w]).
inline Params make_params(const int* ip, const float* fp) {
  Params P;
  P.width = ip[IP_WIDTH];
  P.height = ip[IP_HEIGHT];
  P.spp = ip[IP_SPP];
  P.max_depth = ip[IP_MAX_DEPTH];
  P.rr_start_depth = ip[IP_RR_START];
  P.n_lights = ip[IP_N_LIGHTS];
  P.nee = ip[IP_NEE];
  P.jitter = ip[IP_JITTER];
  P.mis_exact = ip[IP_MIS_EXACT];
  P.power_pick = ip[IP_POWER_PICK];
  P.has_env = ip[IP_HAS_ENV];
  P.has_area = ip[IP_HAS_AREA];
  P.textured = ip[IP_TEXTURED];
  P.attr_stride = ip[IP_ATTR_STRIDE];
  P.ts = (unsigned int)ip[IP_TS];
  P.rr_clamp_min = fp[FP_RR_CLAMP_MIN];
  P.firefly_clamp = fp[FP_FIREFLY];
  P.shadow_eps = fp[FP_SHADOW_EPS];
  P.origin_eps = fp[FP_ORIGIN_EPS];
  return P;
}

inline Env make_env(const float* env, const int* ip) {
  Env e;
  e.h = ip[IP_ENV_H];
  e.w = ip[IP_ENV_W];
  const int n = e.h * e.w;
  e.rot = env;
  e.rgb = env + 9;
  e.cdf = env + 9 + 3 * n;
  e.pdf = env + 9 + 4 * n;
  return e;
}

// The hook of K1 and K4: none.  A hook with kActive false is never called,
// so K1 and K4 compile to the code they had before hooks existed.
struct NoHook {
  static constexpr bool kActive = false;
};

// How render_lane's thread takes its lanes.  OneLane (K4, K6): the lane it
// was called with, then it returns.  LaneCounter (K1, K5): when its lane's
// samples end, the thread writes the lane's sums and takes the next lane
// from a counter (zeroed on the stream before the launch; the first
// `first` lanes are the threads' own), so no thread waits on another's
// pixel and the grid can stay resident.  One thread still runs all of a
// pixel's samples in order, so each lane's sums are OneLane's bit for bit.
struct OneLane {
  static constexpr bool kDynamic = false;
};

struct LaneCounter {
  static constexpr bool kDynamic = true;
  int* next;  // lanes handed out past `first`
  int first;  // gridDim.x * blockDim.x

  // The next lane: one atomicAdd for the threads of the warp that ask
  // together (blockDim.x a multiple of 32).
  __device__ __forceinline__ int take() const {
    const unsigned mask = __activemask();
    const unsigned me = threadIdx.x & 31u;
    const int leader = __ffs(mask) - 1;
    int base = 0;
    if ((int)me == leader) base = atomicAdd(next, __popc(mask));
    base = __shfl_sync(mask, base, leader);
    return first + base + __popc(mask & ((1u << me) - 1u));
  }
};

// Trace lane `lane`'s pixel.  Isect provides
//   closest(o, d, t, prim, u, v): prim = -1 on a miss
//   any(o, d, t_lo, t_hi): an occluder strictly inside (t_lo, t_hi)
// Hook (kActive true: the fused-gradient kernels K5 and K6, grad.cuh) is
// called once per hit bounce where the TPU body calls grad_hook
// (gpuspectral_tpu/integrator/mega.py:1108-1116): after the bounce's
// contribution is final and before Russian roulette, with the throughput
// before this bounce's update.  It is taken by value, so its per-lane state
// lives in this function's registers.
// kSync: block-synchronous sample regeneration (cfg.mega_sync_regen): a
// block starts its next samples only once every lane finished the current
// one; each lane's samples, and so its result, are those of the default.
// With kSync every thread of the block must call this (lanes past n_lanes
// included).  Lanes (OneLane or LaneCounter, the latter without kSync) says
// whether the thread goes on to further lanes; a Hook with kActive hears
// `finish()` when a lane's samples end and `retarget(lane)` when the
// thread takes the next.
template <class Isect, bool kSync, class Hook = NoHook, class Lanes = OneLane>
__device__ void render_lane(const Isect& isect, const Tables& T, const Params& P, int lane,
                            int n_lanes, const int* __restrict__ pix, float* __restrict__ rad_r,
                            float* __restrict__ rad_g, float* __restrict__ rad_b,
                            int* __restrict__ rays_out, Hook hook = Hook(),
                            Lanes lanes = Lanes()) {
  static_assert(!(kSync && Lanes::kDynamic), "block-synchronous regeneration takes one lane");
  const bool valid = lane < n_lanes;
  if (!kSync && !valid) return;
  const float* cam = T.cam;
  // camera (scene/camera.py semantics, rsqrt form of mega.py:1221-1242)
  const float r00 = cam[0], r01 = cam[1], r02 = cam[2];
  const float r10 = cam[3], r11 = cam[4], r12 = cam[5];
  const float r20 = cam[6], r21 = cam[7], r22 = cam[8];
  const V3 cam_o = v3(cam[9], cam[10], cam[11]);
  const float zplane = (float)(max(P.width, P.height) / 2.0) / tanf(cam[12] / 2.0f);
  uint32_t pixel = valid ? (uint32_t)pix[lane] : 0u;
  float px0 = (float)(pixel % (uint32_t)P.width);
  float py0 = (float)(pixel / (uint32_t)P.width);
  const float half_w = (float)(P.width / 2.0), half_h = (float)(P.height / 2.0);
  const float sel_uniform = (float)(1.0 / P.n_lights);
  const bool env_nee = P.has_env && P.nee;
  const float p_env = env_nee ? (P.has_area ? 0.5f : 1.0f) : 0.0f;

  uint32_t sample = 0, depth = 0, seed;
  V3 o, d;
  auto fresh = [&]() {
    seed = pixel_seed(pixel, P.ts + sample);
    float px = px0, py = py0;
    if (P.jitter) {
      px = px + uniform(seed, 0xFFFFu, CH_JITTER_X);
      py = py + uniform(seed, 0xFFFFu, CH_JITTER_Y);
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
  bool prev_nee = false, prev_nee_any = false, was_delta = false, count_emitted = true;
  bool done = false;  // the current path ended (kSync: waiting for the block)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;

  while (true) {
    const bool exhausted = !valid || (done && sample + 1 >= (uint32_t)P.spp);
    if constexpr (Lanes::kDynamic) {
      if (exhausted) {  // the lane's samples ended: its sums out, the next lane in
        rad_r[lane] = acc_r;
        rad_g[lane] = acc_g;
        rad_b[lane] = acc_b;
        rays_out[lane] = rays;
        if constexpr (Hook::kActive) hook.finish();
        lane = lanes.take();
        if (lane >= n_lanes) return;
        if constexpr (Hook::kActive) hook.retarget(lane);
        pixel = (uint32_t)pix[lane];
        px0 = (float)(pixel % (uint32_t)P.width);
        py0 = (float)(pixel / (uint32_t)P.width);
        sample = 0;
        fresh();
        w = v3(1.0f, 1.0f, 1.0f);
        direct_weight = 1.0f;
        prev_pdf = 1.0f;
        prev_nee = false;
        prev_nee_any = false;
        was_delta = false;
        count_emitted = true;
        depth = 0;
        done = false;
        acc_r = acc_g = acc_b = 0.0f;
        rays = 0;
      }
    } else if (kSync ? __syncthreads_and(exhausted) : exhausted) {
      break;
    }
    if (!done) {
      const uint32_t bounce = depth;
      float t, bu, bv;
      int prim;
      isect.closest(o, d, t, prim, bu, bv);
      float e_r = 0.0f, e_g = 0.0f, e_b = 0.0f;
      if (prim < 0) {  // miss: environment radiance, MIS-discounted, ends the path
        rays += 1;
        done = true;
        if (P.has_env) {
          const V3 L = env_eval(T.env, d);
          float scale_env = 1.0f;
          if (P.nee) {
            const float pdf_e = env_pdf(T.env, d) * p_env;
            const float w_env =
                (prev_nee_any && !was_delta) ? power_heuristic(prev_pdf, pdf_e) : 1.0f;
            scale_env = count_emitted ? 1.0f : w_env;
          }
          e_r = scale_env * w.x * L.x;
          e_g = scale_env * w.y * L.y;
          e_b = scale_env * w.z * L.z;
        }
      } else {
        const float* a = T.attr + (size_t)prim * P.attr_stride;
        const V3 n0 = v3(a[0], a[1], a[2]), n1 = v3(a[3], a[4], a[5]),
                 n2 = v3(a[6], a[7], a[8]);
        const V3 emission = v3(a[9], a[10], a[11]);
        const bool twofaced = a[12] > 0.5f;
        const int kind = (int)rintf(a[14]);
        float p[12];
#pragma unroll
        for (int c = 0; c < 12; ++c) p[c] = a[15 + c];
        const float bw = 1.0f - bu - bv;
        if (P.textured) {
          // barycentric blend of the per-corner texture colours
          // (mega_bvh.py:659-667)
          p[0] = p[0] * (bw * a[32] + bu * a[35] + bv * a[38]);
          p[1] = p[1] * (bw * a[33] + bu * a[36] + bv * a[39]);
          p[2] = p[2] * (bw * a[34] + bu * a[37] + bv * a[40]);
        }
        V3 gn = v3(a[27], a[28], a[29]);
        const V3 position = v3(fmaf(d.x, t, o.x), fmaf(d.y, t, o.y), fmaf(d.z, t, o.z));

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

        const float u_sel = uniform(seed, bounce, CH_BSDF_SELECT);
        const float u1 = uniform(seed, bounce, CH_BSDF_U1);
        const float u2 = uniform(seed, bounce, CH_BSDF_U2);
        const Sample s = sample_bsdf(kind, p, wo, u_sel, u1, u2);
        const float now_ = fabsf(s.wi.z);
        const V3 wi_world = v3(tg.x * s.wi.x + bn.x * s.wi.y + nn.x * s.wi.z,
                               tg.y * s.wi.x + bn.y * s.wi.y + nn.y * s.wi.z,
                               tg.z * s.wi.x + bn.z * s.wi.y + nn.z * s.wi.z);
        const bool transmission = kind == SMOOTH_DIELECTRIC;

        // ---- light pick: uniform (the reference's) or power-proportional
        uint32_t lidx;
        float sel_pdf;
        if (P.power_pick) {
          const float u_l = uniform(seed, bounce, CH_LIGHT_INDEX);
          int lo = 0, hi = P.n_lights;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (T.light_cdf[mid] < u_l) lo = mid + 1; else hi = mid;
          }
          lidx = (uint32_t)min(lo, P.n_lights - 1);
          sel_pdf = T.light_prob[lidx];
        } else {
          lidx = random_bits(seed, bounce, CH_LIGHT_INDEX) % (uint32_t)P.n_lights;
          sel_pdf = sel_uniform;
        }
        // ---- light sample (sampling.sample_triangle_light)
        const float* lr = T.light + (size_t)lidx * kLight;
        const V3 lv0 = v3(lr[0], lr[1], lr[2]), lv1 = v3(lr[3], lr[4], lr[5]),
                 lv2 = v3(lr[6], lr[7], lr[8]);
        const V3 lemit = v3(lr[9], lr[10], lr[11]);
        const float lu1 = uniform(seed, bounce, CH_LIGHT_U1);
        const float lu2 = uniform(seed, bounce, CH_LIGHT_U2);
        const float su = sqrtf(fmaxf(lu1, 0.0f));
        const float lbu = 1.0f - su;
        const float lbv = lu2 * su;
        const float lbw = 1.0f - lbu - lbv;
        const float larea = 0.5f * fabsf(length(cross(sub(lv2, lv0), sub(lv1, lv0))));
        const V3 lnormal = normalize(cross(sub(lv1, lv0), sub(lv2, lv0)));
        const V3 light_pos = add(add(scale(lv0, lbu), scale(lv1, lbv)), scale(lv2, lbw));
        const V3 ldelta = sub(light_pos, position);
        float ldist = length(ldelta);
        V3 ldir = scale(ldelta, 1.0f / fmaxf(ldist, 1e-12f));
        const float cos_light = dot(neg(ldir), lnormal);
        const float lfront = cos_light > 0.0f ? 1.0f : 0.0f;
        V3 light_emitted = scale(lemit, lfront);
        float light_pdf = ldist * ldist / fmaxf(fabsf(cos_light) * larea, 1e-12f);
        light_pdf = light_pdf * sel_pdf;

        // ---- environment NEE strategy, picked with probability p_env
        bool env_pick = false;
        if (env_nee) {
          const float eu1 = uniform(seed, bounce, CH_ENV_U1);
          const float eu2 = uniform(seed, bounce, CH_ENV_U2);
          env_pick = P.has_area ? uniform(seed, bounce, CH_ENV_SELECT) < p_env : true;
          float env_pdf_v;
          const V3 env_dir = env_sample(T.env, eu1, eu2, env_pdf_v);
          const V3 env_l = env_eval(T.env, env_dir);
          if (env_pick) {
            ldir = env_dir;
            ldist = 1e30f;
            light_emitted = env_l;
            light_pdf = env_pdf_v * p_env;
          } else {
            light_pdf = light_pdf * (1.0f - p_env);
          }
        }

        const V3 w_light_local = v3(dot(ldir, tg), dot(ldir, bn), dot(ldir, nn));
        const float nol = fabsf(dot(sn, ldir));
        float lpdf_eval;
        const V3 f_light = eval_bsdf(kind, p, wo, w_light_local, lpdf_eval);

        const bool front_ok = (dot(gn, md) > 0.0f) && (dot(gn, ldir) > 0.0f);
        const bool nee_candidate = P.nee && !s.delta && (front_ok || transmission);
        const bool shadowed =
            nee_candidate && isect.any(position, ldir, P.shadow_eps, ldist - P.shadow_eps);
        const bool nee_done = nee_candidate && !shadowed && (light_pdf != 0.0f);

        // the environment strategy weighs against the exact eval pdf
        const float mis_bsdf_pdf = env_pick ? lpdf_eval : s.pdf;
        const float w_mis = power_heuristic(light_pdf, mis_bsdf_pdf);
        const float nee_s = w_mis * nol * safe_inv(light_pdf);
        e_r = nee_done ? nee_s * f_light.x * w.x * light_emitted.x : 0.0f;
        e_g = nee_done ? nee_s * f_light.y * w.y * light_emitted.y : 0.0f;
        e_b = nee_done ? nee_s * f_light.z * w.z * light_emitted.z : 0.0f;

        // emitter hit with MIS bookkeeping (rayhit.rchit:760-768)
        const float light_flag = dot(gn, md) > 0.0f ? 1.0f : 0.0f;
        float emit_w = 1.0f;
        if (P.nee && P.mis_exact) {
          const float cos_hit = fabsf(dot(gn, md));
          float sel_hit = P.power_pick ? a[31] : sel_uniform;
          sel_hit = sel_hit * (1.0f - p_env);
          const float pdf_hit = t * t / fmaxf(cos_hit * a[30], 1e-12f) * sel_hit;
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
        const bool bad_pdf = !isfinite(s.pdf) || !finite3(s.f) || (s.pdf == 0.0f);
        const bool terminate = invalid_hemi || self_isect || bad_pdf;

        if constexpr (Hook::kActive) {
          const bool acc = e_r < P.firefly_clamp && e_g < P.firefly_clamp &&
                           e_b < P.firefly_clamp;
          hook.bounce(bounce, a, w, acc, !terminate, nee_done, nee_s, f_light, lfront, lemit,
                      lidx, emit_w * light_flag, v3(e_r, e_g, e_b));
        }
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
          prev_nee_any = nee_candidate;
          was_delta = s.delta;
          count_emitted = false;
        }
        done = terminate;

        // Russian roulette (raygen.rgen:66-71)
        if (!done && bounce > (uint32_t)P.rr_start_depth) {
          const float q = fminf(fmaxf(fmaxf(fmaxf(w.x, w.y), w.z), P.rr_clamp_min), 1.0f);
          if (uniform(seed, bounce, CH_RR) > q) {
            done = true;
          } else {
            const float inv_q = 1.0f / q;
            w = v3(w.x * inv_q, w.y * inv_q, w.z * inv_q);
          }
        }
      }
      // firefly clamp: drop the bounce's contribution if any channel >= clamp
      if (e_r < P.firefly_clamp && e_g < P.firefly_clamp && e_b < P.firefly_clamp) {
        acc_r += e_r;
        acc_g += e_g;
        acc_b += e_b;
      }
      // depth advance and per-path cutoff
      depth = bounce + 1;
      if (depth >= (uint32_t)(P.max_depth + 1)) done = true;
    }

    // regeneration of the next sample
    const bool all_done = kSync ? __syncthreads_and(!valid || done) : done;
    if (all_done && done && sample + 1 < (uint32_t)P.spp) {
      sample += 1;
      fresh();
      w = v3(1.0f, 1.0f, 1.0f);
      direct_weight = 1.0f;
      prev_pdf = 1.0f;
      prev_nee = false;
      prev_nee_any = false;
      was_delta = false;
      count_emitted = true;
      depth = 0;
      done = false;
    }
  }
  if (valid) {
    rad_r[lane] = acc_r;
    rad_g[lane] = acc_g;
    rad_b[lane] = acc_b;
    rays_out[lane] = rays;
    if constexpr (Hook::kActive) hook.finish();
  }
}

}  // namespace gst
