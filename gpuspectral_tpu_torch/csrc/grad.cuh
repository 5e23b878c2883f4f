// The gradient hook of the fused forward-gradient kernels K5 (mega_grad.cu)
// and K6 (mega_bvh.cu): gpuspectral_tpu/integrator/mega_grad.py:
// make_diffuse_grad_hook, for bounce.cuh:render_lane.
//
// Counting identity: on a diffuse bounce of BSDF row b the throughput picks
// up one factor kd_b, so with n_b the number of prior row-b bounces of the
// path, d(contribution)/d kd_b = n_b * contribution / kd_b (the "suffix"
// term), plus this bounce's own NEE term, whose f_light = kd * tex / pi is
// multiplicative in kd (the "direct" term).  Emitter radiance enters each
// contribution linearly: the emitter-hit term of a hit light (gte) and the
// NEE term of the sampled light (gle).  The loss cotangent enters linearly
// too, so every lane keeps un-contracted partials and the backward pass is
// one contraction outside the kernel.
//
// Output: partial planes (NP, n_lanes), NP = 3R + 6Lg, in the order of
// integrator/mega_grad.py:grad_plane_keys: d kd (row i, channel c) at plane
// 3i + c, then tri_emission (light l, c) at 3R + 3l + c, then
// light_emission at 3R + 3Lg + 3l + c.  A lane adds to its own column only
// (no atomics), and only where the term is not zero; the wrapper zero-fills
// the planes.  GradHookT<false> (K6) adds in device memory (read-modify-
// write, coalesced across a warp of consecutive lanes); GradHookT<true>
// (K5) adds in the thread's column of a (NP, blockDim.x) shared-memory
// block and writes the lane's NP sums out when its samples end (finish):
// the same additions in the same order from the same zero, so the same
// sums, and one write a plane a lane whatever lanes a warp holds; it also
// skips the divides of a zero numerator (the quotient is that zero).  The
// per-row counts n_b live in registers (at most kMaxGradRows of them).
#pragma once

#include "common.cuh"

namespace gst {

constexpr int kMaxGradRows = 8;    // MAX_GRAD_BSDFS
constexpr int kMaxGradLights = 4;  // MAX_GRAD_LIGHTS
constexpr float kKdEps = 1e-4f;    // the removable kd = 0 singularity (_KD_EPS)

template <bool kShared>
struct GradHookT {
  static constexpr bool kActive = true;
  float* parts;       // (NP, n_lanes)
  float* mine;        // kShared: this thread's column of the (NP, blockDim.x) block
  const int* rows;    // (R,) BSDF rows differentiated
  const float* kd;    // (R, 3) their kd
  int n_lanes, lane;  // plane stride and this lane's column
  int R, Lg;          // rows and lights tracked (0 and 0 on padding lanes)
  int bidx_col;       // attribute column of the hit's BSDF row
  int n[kMaxGradRows];

  // The lane whose columns take the partials from now on (bounce.cuh's
  // LaneCounter); the per-row counts restart at its first bounce (depth 0).
  __device__ __forceinline__ void retarget(int l) { lane = l; }

  __device__ __forceinline__ void add(int plane, float x) {
    float* p = kShared ? mine + plane * (int)blockDim.x : parts + (size_t)plane * n_lanes + lane;
    *p = *p + x;
  }

  // The lane's samples ended: kShared writes its sums out and zeroes its
  // column for the next lane.
  __device__ __forceinline__ void finish() {
    if constexpr (kShared) {
      const int np = 3 * R + 6 * Lg;
      for (int p = 0; p < np; ++p) {
        parts[(size_t)p * n_lanes + lane] = mine[p * (int)blockDim.x];
        mine[p * (int)blockDim.x] = 0.0f;
      }
    }
  }

  // One hit bounce (mega_grad.py:130-172).  a: the hit's attribute row;
  // w: throughput before this bounce; acc: the contribution passed the
  // firefly clamp; cont: the path continues; emit_coeff: emit_w * light_flag.
  __device__ __forceinline__ void bounce(uint32_t depth, const float* a, V3 w, bool acc,
                                         bool cont, bool nee_done, float nee_s, V3 f_light,
                                         float lfront, V3 lemit, uint32_t lidx,
                                         float emit_coeff, V3 e) {
    const int bidx = (int)rintf(a[bidx_col]);
    const int lhit = (int)rintf(a[13]);
    const bool neem = acc && nee_done && lfront != 0.0f;
    const float W[3] = {w.x, w.y, w.z};
    const float E[3] = {e.x, e.y, e.z};
    const float FL[3] = {f_light.x, f_light.y, f_light.z};
    const float LE[3] = {lemit.x, lemit.y, lemit.z};
#pragma unroll
    for (int i = 0; i < kMaxGradRows; ++i) {
      if (i >= R) break;
      const bool selb = bidx == rows[i];
      const int nbi = depth == 0 ? 0 : n[i];  // counts are per path
      const float nb = (float)nbi;
      if (acc && ((neem && selb) || nbi != 0)) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float kdc = fmaxf(kd[3 * i + c], kKdEps);
          if constexpr (kShared) {
            // K5 skips the divides of a zero numerator, whose quotient is
            // that zero (kdc > 0): most of them, and 1.11x on K5
            float ratio = FL[c];
            if (neem && selb && ratio != 0.0f) ratio = ratio / kdc;
            const float direct = (neem && selb) ? nee_s * W[c] * LE[c] * ratio : 0.0f;
            float suffix = E[c] * nb;
            if (suffix != 0.0f) suffix = suffix / kdc;
            add(3 * i + c, direct + suffix);
          } else {
            const float direct = (neem && selb) ? nee_s * W[c] * LE[c] * (FL[c] / kdc) : 0.0f;
            const float suffix = E[c] * nb / kdc;
            add(3 * i + c, direct + suffix);
          }
        }
      }
      n[i] = nbi + ((cont && selb) ? 1 : 0);
    }
    const int base_te = 3 * R, base_le = 3 * R + 3 * Lg;
    if (acc && lhit >= 0 && lhit < Lg) {
#pragma unroll
      for (int c = 0; c < 3; ++c) add(base_te + 3 * lhit + c, emit_coeff * W[c]);
    }
    if (neem && (int)lidx < Lg) {
#pragma unroll
      for (int c = 0; c < 3; ++c) add(base_le + 3 * (int)lidx + c, nee_s * FL[c] * W[c]);
    }
  }
};

using GradHook = GradHookT<false>;

// The hook of lane `lane`, its counts zero (padding lanes track nothing);
// kShared: shared points at the CTA's (NP, blockDim.x) block, whose column
// of this thread is zeroed here.
template <bool kShared = false>
__device__ __forceinline__ GradHookT<kShared> make_grad_hook(float* parts, const int* rows,
                                                             const float* kd, int n_lanes,
                                                             int lane, int R, int Lg,
                                                             int bidx_col,
                                                             float* shared = nullptr) {
  GradHookT<kShared> h;
  const bool valid = lane < n_lanes;
  h.parts = parts;
  h.mine = kShared ? shared + threadIdx.x : nullptr;
  h.rows = rows;
  h.kd = kd;
  h.n_lanes = n_lanes;
  h.lane = lane;
  h.R = valid ? R : 0;
  h.Lg = valid ? Lg : 0;
  h.bidx_col = bidx_col;
#pragma unroll
  for (int i = 0; i < kMaxGradRows; ++i) h.n[i] = 0;
  if constexpr (kShared) {
    for (int p = 0; p < 3 * h.R + 6 * h.Lg; ++p) h.mine[p * (int)blockDim.x] = 0.0f;
  }
  return h;
}

}  // namespace gst
