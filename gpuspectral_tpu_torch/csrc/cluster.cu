// K7c / K7d / K7e: the cluster sweep, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/cluster_sweep.py: _votes_kernel (K7c, the
// pallas_call at cluster_sweep.py:316), _sweep_closest_kernel (K7d, :369)
// and _sweep_any_kernel (K7e, :418).  Wrapper:
// gpuspectral_tpu_torch/bvh/cluster_sweep.py (cluster_votes,
// cluster_closest, cluster_any), which also holds the supernode tables.
//
// A supernode is a run of `stride` consecutive triangle slots (K leaf
// clusters in Morton order) with one box; rays come in blocks of kBlock =
// 256 consecutive rays, and one CTA of 256 threads takes one block, one
// thread per ray.
//
//   K7c  the CTA stages its rays (origin, inverse direction, t_min, t_max)
//        in shared memory; thread i then takes supernodes i, i + 256, ...
//        and slab-tests each against the block's rays until one passes.
//        Output: one int32 vote per (block, supernode), no atomics.
//   K7d  the CTA walks the supernodes in order and skips those its block
//        did not vote for (a branch uniform across the CTA).  A voted
//        supernode's Woop rows are staged in shared memory kSweep slots at
//        a time (12 x 128 floats = 6 KB); every thread then tests its ray
//        against them in slot order, keeping the closest hit with a strict
//        `<`, so the lowest slot wins among exactly tied t (as K3, and as
//        the plain scan).  At the end each thread writes t, prim, u, v and
//        its winning slot's A attribute floats.
//   K7e  the same loop for occlusion in (t_min, t_max); the CTA stops once
//        every ray of the block is occluded or has an empty segment
//        (__syncthreads_and), which cannot change the result.
// Threads of inactive rays (t_max = -1e30) and of padding rays past the
// last ray take part in every barrier and never vote or hit.
//
// What bounds it on the H100: operations.  The sweep tests every slot of a
// voted supernode for every ray of the block: 256 slots x 256 rays per
// voted supernode, ~32 flops each, all operands in registers or broadcast
// from shared memory.  So the votes set the time: a block of rays that agree
// on few supernodes (sorted bounce rays, shadow rays sorted by endpoint,
// primary rays) votes few, a block of long random segments many, and a
// block that votes for all of them costs each ray every Woop test of the
// scene.  K3's per-ray walk tests a few dozen triangles per ray.
//
// Precision: built with --fmad=false like the other kernels.  The slab
// test is plain multiplies, subtracts, min / max and an IEEE division for
// the inverse direction (math3d.safe_div(1, d)), as the plain torch
// version computes them: the votes are equal.  The Woop test is
// csrc/common.cuh:woop_test, whose fmaf calls sit where ops/woop.py calls
// m3.fma: opz, dpz, the hit point and u, v are fused multiply-adds, the
// trailing `+ b` and the division are not.  So t, prim, u and v equal the
// plain scan bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;  // rays per CTA = cluster_sweep.BLOCK
constexpr int kSweep = 128;  // slots staged at a time = cluster_sweep.SWEEP

__global__ void __launch_bounds__(kBlock)
cluster_votes_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                     const float* __restrict__ t_min, const float* __restrict__ t_max,
                     int n_rays, const float* __restrict__ blo, const float* __restrict__ bhi,
                     int sp, int n_super, int* __restrict__ votes) {
  __shared__ float ray[8][kBlock];  // ox oy oz, 1/dx 1/dy 1/dz, t_min, t_max
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;  // padding rays: o 0, d 1, t_max -1e30
  for (int c = 0; c < 3; ++c) {
    ray[c][threadIdx.x] = live ? origin[3 * r + c] : 0.0f;
    ray[3 + c][threadIdx.x] = gst::inv_dir(live ? direction[3 * r + c] : 1.0f);
  }
  ray[6][threadIdx.x] = live ? t_min[r] : 0.0f;
  ray[7][threadIdx.x] = live ? t_max[r] : -gst::kBig;
  __syncthreads();
  for (int s = threadIdx.x; s < n_super; s += kBlock) {
    const float lx = blo[s], ly = blo[sp + s], lz = blo[2 * sp + s];
    const float hx = bhi[s], hy = bhi[sp + s], hz = bhi[2 * sp + s];
    int vote = 0;
    for (int j = 0; j < kBlock && !vote; ++j) {
      const float t0x = (lx - ray[0][j]) * ray[3][j], t1x = (hx - ray[0][j]) * ray[3][j];
      const float t0y = (ly - ray[1][j]) * ray[4][j], t1y = (hy - ray[1][j]) * ray[4][j];
      const float t0z = (lz - ray[2][j]) * ray[5][j], t1z = (hz - ray[2][j]) * ray[5][j];
      const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fmaxf(fminf(t0z, t1z), ray[6][j]));
      const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fminf(fmaxf(t0z, t1z), ray[7][j]));
      vote = t_far >= t_near;
    }
    votes[(size_t)blockIdx.x * n_super + s] = vote;
  }
}

__global__ void __launch_bounds__(kBlock)
cluster_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                       const float* __restrict__ t_max, int n_rays,
                       const int* __restrict__ votes, int n_super, int stride,
                       const float* __restrict__ woop_t, int n_slots,
                       const float* __restrict__ attr, int n_attr, float* __restrict__ t_out,
                       int* __restrict__ prim_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, float* __restrict__ attr_out) {
  __shared__ float w[12][kSweep];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  float best = live ? t_max[r] : -gst::kBig;
  float best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  const int* block_votes = votes + (size_t)blockIdx.x * n_super;
  for (int s = 0; s < n_super; ++s) {
    if (block_votes[s] == 0) continue;  // the same for every thread of the CTA
    const int end = min((s + 1) * stride, n_slots);
    for (int base = s * stride; base < end; base += kSweep) {
      const int n = min(kSweep, end - base);
      __syncthreads();
      gst::stage<kBlock, kSweep>(w, woop_t, n_slots, base, n);
      __syncthreads();
      for (int c = 0; c < n; ++c) {
        float t, u, v;
        if (gst::woop_test(&w[0][c], kSweep, o, d, 0.0f, best, t, u, v)) {
          best = t;
          best_u = u;
          best_v = v;
          best_prim = base + c;
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
  for (int a = 0; a < n_attr; ++a)
    attr_out[(size_t)r * n_attr + a] = hit ? attr[(size_t)best_prim * n_attr + a] : 0.0f;
}

__global__ void __launch_bounds__(kBlock)
cluster_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                   const int* __restrict__ votes, int n_super, int stride,
                   const float* __restrict__ woop_t, int n_slots, bool* __restrict__ occ_out) {
  __shared__ float w[12][kSweep];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const float lo = live ? t_min[r] : 0.0f;
  const float hi = live ? t_max[r] : -gst::kBig;
  bool occ = false;
  const bool empty = !(hi > lo);  // no t lies in (lo, hi): never occluded
  const int* block_votes = votes + (size_t)blockIdx.x * n_super;
  bool all_done = false;
  for (int s = 0; s < n_super && !all_done; ++s) {
    if (block_votes[s] == 0) continue;
    const int end = min((s + 1) * stride, n_slots);
    for (int base = s * stride; base < end; base += kSweep) {
      // also the barrier before restaging: the result is uniform
      if (__syncthreads_and(occ || empty)) {
        all_done = true;
        break;
      }
      const int n = min(kSweep, end - base);
      gst::stage<kBlock, kSweep>(w, woop_t, n_slots, base, n);
      __syncthreads();
      if (occ || empty) continue;
      for (int c = 0; c < n; ++c) {
        float t, u, v;
        if (gst::woop_test(&w[0][c], kSweep, o, d, lo, hi, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
  }
  if (live) occ_out[r] = occ;
}

int blocks_for(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int gst_cluster_votes(const float* origin, const float* direction, const float* t_min,
                                 const float* t_max, int n_rays, const float* blo,
                                 const float* bhi, int sp, int n_super, int* votes,
                                 void* stream) {
  if (n_rays == 0) return 0;
  cluster_votes_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, blo, bhi, sp, n_super, votes);
  return (int)cudaGetLastError();
}

extern "C" int gst_cluster_closest(const float* origin, const float* direction,
                                   const float* t_max, int n_rays, const int* votes,
                                   int n_super, int stride, const float* woop_t, int n_slots,
                                   const float* attr, int n_attr, float* t_out, int* prim_out,
                                   float* u_out, float* v_out, float* attr_out, void* stream) {
  if (n_rays == 0) return 0;
  cluster_closest_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays, votes, n_super, stride, woop_t, n_slots, attr, n_attr,
      t_out, prim_out, u_out, v_out, attr_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_cluster_any(const float* origin, const float* direction, const float* t_min,
                               const float* t_max, int n_rays, const int* votes, int n_super,
                               int stride, const float* woop_t, int n_slots, bool* occ_out,
                               void* stream) {
  if (n_rays == 0) return 0;
  cluster_any_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, votes, n_super, stride, woop_t, n_slots,
      occ_out);
  return (int)cudaGetLastError();
}
