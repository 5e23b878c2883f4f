// K2: brute-force closest-hit and any-hit over every triangle, for sm_90a.
//
// Replaces gpuspectral_tpu/ops/pallas_isect.py: closest_pallas
// (_closest_kernel) and any_pallas (_any_kernel).  Wrapper:
// gpuspectral_tpu_torch/ops/cuda_isect.py (closest_cuda, any_cuda).
//
// What bounds it on the H100: arithmetic.  Each ray-triangle test is ~20
// float operations and the (12, T) Woop table is read by every ray, so the
// work is R * T tests against 48 B of table per triangle; with T <= a few
// thousand the table sits in L2 and device-memory traffic is the rays
// (28 B in, 8 B out each).  The design keeps the table traffic on chip:
// one thread per ray, and each block stages the table in shared memory one
// chunk of kChunk triangles at a time (12 coalesced row loads), after which
// every thread of the block walks the chunk with broadcast shared-memory
// reads.  The TPU kernel's (BLOCK, 128) t-planes and min/argmin reductions
// become a running best per thread.
//
// Closest hit commits on strict t < best_t in index order, so among exactly
// tied t the lowest prim id wins (the tie rule of pallas_isect.py:74-78 and
// of the torch scan).  Any-hit stops once every ray of the block is
// occluded.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;

__device__ __forceinline__ void stage_chunk(float* sw, const float* __restrict__ woop_t,
                                            int n_tris, int base, int count) {
  for (int i = threadIdx.x; i < 12 * kChunk; i += blockDim.x) {
    const int row = i / kChunk, col = i % kChunk;
    sw[i] = col < count ? woop_t[(size_t)row * n_tris + base + col] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
               const float* __restrict__ woop_t, int n_tris,
               const float* __restrict__ t_min, const float* __restrict__ t_max,
               int n_rays, float* __restrict__ t_out, int* __restrict__ prim_out) {
  __shared__ float sw[12 * kChunk];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < n_rays;
  gst::V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 1.f};
  float lo = 0.f, hi = -gst::kBig;
  if (valid) {
    o = {origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
    d = {direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
    lo = t_min[r];
    hi = t_max[r];
  }
  float best_t = gst::kBig;
  int best_prim = -1;
  for (int base = 0; base < n_tris; base += kChunk) {
    const int count = min(kChunk, n_tris - base);
    __syncthreads();
    stage_chunk(sw, woop_t, n_tris, base, count);
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      float t, u, v;
      if (gst::woop_test(sw + j, kChunk, o, d, lo, hi, t, u, v) && t < best_t) {
        best_t = t;
        best_prim = base + j;
      }
    }
  }
  if (valid) {
    t_out[r] = best_t;
    prim_out[r] = best_t < gst::kBig ? best_prim : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
           const float* __restrict__ woop_t, int n_tris,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           int n_rays, bool* __restrict__ occ_out) {
  __shared__ float sw[12 * kChunk];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < n_rays;
  gst::V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 1.f};
  float lo = 0.f, hi = -gst::kBig;
  if (valid) {
    o = {origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
    d = {direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
    lo = t_min[r];
    hi = t_max[r];
  }
  // rays past the end and empty intervals never occlude: count them done
  bool occ = false;
  bool done = !valid || !(hi > lo);
  for (int base = 0; base < n_tris; base += kChunk) {
    if (__syncthreads_and(done)) break;
    const int count = min(kChunk, n_tris - base);
    stage_chunk(sw, woop_t, n_tris, base, count);
    __syncthreads();
    for (int j = 0; j < count && !done; ++j) {
      float t, u, v;
      if (gst::woop_test(sw + j, kChunk, o, d, lo, hi, t, u, v)) {
        occ = true;
        done = true;
      }
    }
  }
  if (valid) occ_out[r] = occ;
}

}  // namespace

extern "C" int gst_closest(const float* origin, const float* direction, const float* woop_t,
                           int n_tris, const float* t_min, const float* t_max, int n_rays,
                           float* t_out, int* prim_out, void* stream) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, woop_t, n_tris, t_min, t_max, n_rays, t_out, prim_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_any(const float* origin, const float* direction, const float* woop_t,
                       int n_tris, const float* t_min, const float* t_max, int n_rays,
                       bool* occ_out, void* stream) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  any_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, woop_t, n_tris, t_min, t_max, n_rays, occ_out);
  return (int)cudaGetLastError();
}
