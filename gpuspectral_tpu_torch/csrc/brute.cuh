// The brute-force intersector of K1 (mega.cu) and K5 (mega_grad.cu): every
// triangle of a (12, n) Woop table staged in shared memory.
#pragma once

#include "common.cuh"

namespace gst {

// Stage the (12, n_tris) Woop rows of a (12, t_stride) table into shared
// memory; every thread of the block takes part.
__device__ __forceinline__ void stage_woop(float* sw, const float* __restrict__ woop_t,
                                           int t_stride, int n_tris) {
  for (int i = threadIdx.x; i < 12 * n_tris; i += blockDim.x) {
    sw[i] = woop_t[(size_t)(i / n_tris) * t_stride + (i % n_tris)];
  }
  __syncthreads();
}

// closest / any hit over every triangle of the shared-memory Woop table;
// strict t < best in index order: the lowest id wins among tied t
struct BruteIsect {
  const float* sw;  // (12, n)
  int n;

  __device__ void closest(V3 o, V3 d, float& best_t, int& prim, float& bu,
                          float& bv) const {
    best_t = kBig;
    prim = -1;
    bu = 0.0f;
    bv = 0.0f;
    for (int i = 0; i < n; ++i) {
      float t, u, v;
      if (woop_test(sw + i, n, o, d, 0.0f, kBig, t, u, v) && t < best_t) {
        best_t = t;
        prim = i;
        bu = u;
        bv = v;
      }
    }
  }

  __device__ bool any(V3 o, V3 d, float t_lo, float t_hi) const {
    for (int i = 0; i < n; ++i) {
      float t, u, v;
      if (woop_test(sw + i, n, o, d, t_lo, t_hi, t, u, v)) return true;
    }
    return false;
  }
};

}  // namespace gst
