// The brute-force intersector of K1 (mega.cu) and K5 (mega_grad.cu), and
// their launch: every triangle of the scene's (n, 12) Woop rows
// (ops/woop.py's order, SceneData.tri_woop), staged in shared memory as
// three float4 a triangle, so that a test reads its 12 floats with three
// 128-bit broadcasts (every lane of a warp tests the same triangle at once).
// The loop is unrolled kBruteUnroll triangles a turn over rows padded with
// zero rows, which never pass (dpz = 0 fails woop_eval's |dpz| > 1e-12).
// The order of the tests, the closest hit's strict `t < best` (the lowest
// index wins a tie, F3) and the any hit's stop at its first occluder are
// the plain scans'; every test is common.cuh:woop_eval, op for op.
//
// The variant study (tools/torch_mega_variants.py) sets kBruteUnroll; the
// decided variants build from that tool at commit 75e263c (the (12, n)
// scalar rows, 12 loads a test; the rows in the constant bank; a pre-test
// that skips a test's divide where no lane of the warp can pass) and
// 291bede (the any hit leaving after a whole unrolled turn).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace gst {

constexpr int kBruteUnroll = 4;  // triangles a loop turn

// Rows staged for n triangles: a multiple of kBruteUnroll.
__host__ __device__ constexpr int brute_pad(int n) {
  return (n + kBruteUnroll - 1) / kBruteUnroll * kBruteUnroll;
}

// Shared-memory bytes of the staged rows.
inline size_t brute_smem(int n_tris) { return (size_t)brute_pad(n_tris) * 12 * sizeof(float); }

// Stage the (n_tris, 12) rows into shared memory, zero rows up to n_pad;
// every thread of the block takes part.
__device__ __forceinline__ void stage_woop_rows(float4* sw, const float4* __restrict__ rows,
                                                int n_tris, int n_pad) {
  for (int i = threadIdx.x; i < 3 * n_pad; i += blockDim.x) {
    sw[i] = i < 3 * n_tris ? rows[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
}

// closest / any hit over every triangle of the staged Woop rows; strict
// t < best in index order: the lowest id wins among tied t
struct BruteIsect {
  const float4* sw;  // (n, 3 float4)
  int n;             // staged rows, brute_pad(n_tris)

  // woop_eval on row i
  __device__ __forceinline__ bool test(int i, V3 o, V3 d, float t_lo, float t_hi, float& t,
                                       float& u, float& v) const {
    const float4 a = sw[3 * i], b = sw[3 * i + 1], c = sw[3 * i + 2];
    return woop_eval(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, o, d, t_lo,
                     t_hi, t, u, v);
  }

  __device__ void closest(V3 o, V3 d, float& best_t, int& prim, float& bu, float& bv) const {
    best_t = kBig;
    prim = -1;
    bu = 0.0f;
    bv = 0.0f;
    for (int i = 0; i < n; i += kBruteUnroll) {
#pragma unroll
      for (int k = 0; k < kBruteUnroll; ++k) {
        float t, u, v;
        if (test(i + k, o, d, 0.0f, kBig, t, u, v) && t < best_t) {
          best_t = t;
          prim = i + k;
          bu = u;
          bv = v;
        }
      }
    }
  }

  __device__ bool any(V3 o, V3 d, float t_lo, float t_hi) const {
    for (int i = 0; i < n; i += kBruteUnroll) {
#pragma unroll
      for (int k = 0; k < kBruteUnroll; ++k) {
        float t, u, v;
        if (test(i + k, o, d, t_lo, t_hi, t, u, v)) return true;
      }
    }
    return false;
  }
};

// Launch one of the two brute-force megakernels: kernel(args...) over
// n_lanes lanes, kThreads a CTA, with the staged rows of n_tris triangles
// and extra_smem more bytes of dynamic shared memory.  The grid is the CTAs
// the card holds at once (or max_ctas > 0 of them), never more than one CTA
// a kThreads lanes, its threads taking lanes from the counter `next`
// (bounce.cuh's LaneCounter), which is zeroed on the stream first.
template <int kThreads, class... Params, class... Args>
inline int brute_launch(void (*kernel)(Params...), int n_lanes, int n_tris, size_t extra_smem,
                        int* next, int max_ctas, cudaStream_t stream, Args... args) {
  const size_t smem = brute_smem(n_tris) + extra_smem;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(next, 0, sizeof(int), stream)) != cudaSuccess) {
    return (int)err;
  }
  const int resident = max_ctas > 0 ? max_ctas : std::max(sms * per_sm, 1);
  const int grid = std::min((n_lanes + kThreads - 1) / kThreads, resident);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace gst
