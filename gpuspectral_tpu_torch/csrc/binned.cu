// K7a / K7b: the binned sweep, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/binned.py: _make_fused_closest_kernel (K7a,
// the pallas_call at binned.py:409, votes by _vote_words) and
// _make_fused_any_kernel (K7b, :449).  Wrapper:
// gpuspectral_tpu_torch/bvh/binned.py (binned_closest, binned_any).
//
// The scene's leaves are grouped into n_bins sweep bins: bin b covers the
// slots [b * slots, (b + 1) * slots) of the (12, n_slots) Woop table and has
// one box in bounds (6, c_pad) float (lo xyz, hi xyz), c_pad >= n_bins.
// Slots past the table are never tested (the TPU pads it with rows that
// never hit).  Rays come in blocks of kBlock = 32 consecutive rays; one CTA
// of 32 threads (one warp) takes one block, one thread per ray, the ray's
// state in registers.  The CTA walks the bins in ascending order:
//
//   * every thread slab-tests bin b's box (a uniform load) on its segment
//     [0, t_max] and so computes its vote for b; __syncthreads_or is the
//     block's union of votes.  The CTA skips a bin none of its rays voted
//     for.  Votes are made once, bin by bin, and need no storage: a ray
//     votes for up to 4096 bins (the stream band of scene/data.py).
//   * at a visited bin the CTA stages the bin's slots kChunk = 128 at a
//     time (12 Woop rows, 6 KB of shared memory), and each thread whose ray
//     voted for b tests its ray against them in slot order; the others
//     wait.  So a ray commits hits only from bins it voted for, as on the
//     TPU, where each lane is masked to its own votes.
//   K7a  commits t in (0, best) with a strict `<`: the closest hit, ties to
//        the lowest slot (bins and slots come in ascending order).  The
//        ray's best t does not cull its later votes (the TPU's votes are
//        fixed before its sweep).  Rays with t_max <= 0 never vote.
//   K7b  marks the ray occluded at its first hit in (t_min, t_max); an
//        occluded ray stops voting and testing, and rays with t_max <=
//        t_min never vote.  The CTA stops once every ray is occluded or
//        empty (__syncthreads_and), which cannot change the result.
// Threads of inactive rays (t_max = -1e30) and of padding rays past the
// last ray take part in every barrier and never vote.  __syncthreads_or
// at the top of a bin is also the barrier between the previous bin's
// readers and the next staging.
//
// What bounds it on the H100: operations.  A visited bin costs the warp
// `slots` Woop tests (~32 flops each, operands broadcast from shared
// memory) whether one ray or all 32 voted for it, so the union of the
// block's votes sets the time: coherent rays (primary rays, sorted bounce
// rays, shadow rays sorted by endpoint) visit few bins, a block of
// incoherent rays the union of its rays' bins.  The votes cost one slab
// test (12 flops) per ray and bin, the bin's bounds read once per CTA.
//
// Precision: built with --fmad=false like the other kernels.  The slab
// test is plain subtracts, multiplies, min / max and an IEEE division for
// the inverse direction (math3d.safe_div(1, d)), as the plain torch votes
// compute them, so the votes are equal.  The Woop test is
// csrc/common.cuh:woop_test, whose fmaf calls sit where ops/woop.py calls
// m3.fma.  So t, prim, u and v equal the plain version bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 32;  // rays per CTA = binned.BLOCK
constexpr int kChunk = 128;  // slots staged at a time

__global__ void __launch_bounds__(kBlock)
binned_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                      const float* __restrict__ t_max, int n_rays, const float* __restrict__ bounds,
                      int c_pad, int n_bins, int slots, const float* __restrict__ woop_t,
                      int n_slots, float* __restrict__ t_out, int* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float w[12][kChunk];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;  // padding rays: o 0, d 1, t_max -1e30
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = {gst::inv_dir(d.x), gst::inv_dir(d.y), gst::inv_dir(d.z)};
  const float hi = live ? t_max[r] : -gst::kBig;
  const bool tests = hi > 0.0f;  // t must lie in (0, t_max): else never hits
  float best = fminf(hi, gst::kBig);
  float best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  for (int b = 0; b < n_bins; ++b) {
    const bool voted = tests && gst::slab(bounds, c_pad, b, o, inv, 0.0f, hi);
    if (!__syncthreads_or(voted)) continue;
    const int base = b * slots;
    for (int c0 = 0; c0 < slots; c0 += kChunk) {
      const int n = min(kChunk, n_slots - (base + c0));
      if (n <= 0) break;  // the same for every thread of the CTA
      if (c0 > 0) __syncthreads();
      gst::stage<kBlock, kChunk>(w, woop_t, n_slots, base + c0, n);
      __syncthreads();
      if (!voted) continue;
      for (int c = 0; c < n; ++c) {
        float t, u, v;
        if (gst::woop_test(&w[0][c], kChunk, o, d, 0.0f, best, t, u, v)) {
          best = t;
          best_u = u;
          best_v = v;
          best_prim = base + c0 + c;
        }
      }
    }
  }
  if (!live) return;
  const bool hit = best_prim >= 0;
  t_out[r] = hit ? best : gst::kBig;
  prim_out[r] = best_prim;
  u_out[r] = hit ? best_u : 0.0f;
  v_out[r] = hit ? best_v : 0.0f;
}

__global__ void __launch_bounds__(kBlock)
binned_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                  const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                  const float* __restrict__ bounds, int c_pad, int n_bins, int slots,
                  const float* __restrict__ woop_t, int n_slots, bool* __restrict__ occ_out) {
  __shared__ float w[12][kChunk];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = {gst::inv_dir(d.x), gst::inv_dir(d.y), gst::inv_dir(d.z)};
  const float lo = live ? t_min[r] : 0.0f;
  const float hi = live ? t_max[r] : -gst::kBig;
  const bool empty = !(hi > lo);  // no t lies in (lo, hi): never occluded
  bool occ = false;
  const int end = __syncthreads_and(empty) ? 0 : n_bins;
  for (int b = 0; b < end; ++b) {
    const bool voted = !occ && !empty && gst::slab(bounds, c_pad, b, o, inv, 0.0f, hi);
    if (!__syncthreads_or(voted)) continue;
    const int base = b * slots;
    for (int c0 = 0; c0 < slots; c0 += kChunk) {
      const int n = min(kChunk, n_slots - (base + c0));
      if (n <= 0) break;
      if (c0 > 0) __syncthreads();
      gst::stage<kBlock, kChunk>(w, woop_t, n_slots, base + c0, n);
      __syncthreads();
      if (!voted || occ) continue;
      for (int c = 0; c < n; ++c) {
        float t, u, v;
        if (gst::woop_test(&w[0][c], kChunk, o, d, lo, hi, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
    // also the barrier before the next staging: the result is uniform
    if (__syncthreads_and(occ || empty)) break;
  }
  if (live) occ_out[r] = occ;
}

int blocks_for(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int gst_binned_closest(const float* origin, const float* direction, const float* t_max,
                                  int n_rays, const float* bounds, int c_pad, int n_bins,
                                  int slots, const float* woop_t, int n_slots, float* t_out,
                                  int* prim_out, float* u_out, float* v_out, void* stream) {
  if (n_rays == 0) return 0;
  binned_closest_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays, bounds, c_pad, n_bins, slots, woop_t, n_slots, t_out,
      prim_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_binned_any(const float* origin, const float* direction, const float* t_min,
                              const float* t_max, int n_rays, const float* bounds, int c_pad,
                              int n_bins, int slots, const float* woop_t, int n_slots,
                              bool* occ_out, void* stream) {
  if (n_rays == 0) return 0;
  binned_any_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, bounds, c_pad, n_bins, slots, woop_t, n_slots,
      occ_out);
  return (int)cudaGetLastError();
}
