// K2: brute-force closest-hit and any-hit over the leading rows of the Woop
// table, for sm_90a.
//
// Replaces gpuspectral_tpu/ops/pallas_isect.py: closest_pallas
// (_closest_kernel) and any_pallas (_any_kernel).  Wrapper:
// gpuspectral_tpu_torch/ops/cuda_isect.py (closest_cuda, any_cuda).
//
// One thread a ray, kThreads a CTA.  The CTA stages the table kChunk
// triangles at a time in shared memory as three float4 a triangle
// (brute.cuh's layout, transposed from the (12, T) columns while staging:
// 12 coalesced loads a chunk), and every live lane walks the chunk with
// three 128-bit broadcast loads a test (BruteIsect, common.cuh's woop_eval
// op for op), kBruteUnroll tests a loop turn over zero-padded rows.  Only
// the first n_rows slots are tested: the scene's count of the rows that
// hold triangles (SceneData.tri_rows); the rows past it are zero and can
// never pass.
//
// A lane whose segment is empty or NaN (!(t_max > t_min)), or past the
// last ray, is dead: woop_eval's interval test passes no t there, so it
// gives a miss (no occlusion) whether it tests or not.  A dead lane skips
// the tests, so a warp with no live lane runs none, but it still stages
// its share and meets every barrier; a CTA with no live lane stages
// nothing.
//
// Closest hit commits on strict t < best_t in index order, so among exactly
// tied t the lowest prim id wins (the tie rule of pallas_isect.py:74-78 and
// of the torch scan, F3).  Any hit: a lane leaves its loop at its first
// occluder and skips the chunks after it, and the CTA stops staging once
// none of its rays is searching.
#include <cuda_runtime.h>

#include "brute.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // rays a CTA
constexpr int kChunk = 256;    // triangles staged at a time (48 B each)

// Stage triangles base .. base + count - 1 of the (12, n_slots) table as
// three float4 each in ops/woop.py's row order, zero rows up to
// brute_pad(count): consecutive threads take consecutive triangles, so
// each of a triangle's 12 loads is coalesced.
__device__ __forceinline__ void stage(float4* sw, const float* __restrict__ woop_t,
                                      int n_slots, int base, int count) {
  const int n = gst::brute_pad(count);
  const size_t row = (size_t)n_slots;
  for (int i = threadIdx.x; i < 3 * n; i += kThreads) {
    const int j = i % n, q = i / n;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < count) {
      const float* col = woop_t + 4 * q * row + base + j;
      w = make_float4(col[0], col[row], col[2 * row], col[3 * row]);
    }
    sw[3 * j + q] = w;
  }
}

struct Ray {
  gst::V3 o, d;
  float lo, hi;
  bool live;
};

// Ray r, or for a lane past the last ray an empty segment.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        const float* __restrict__ t_min,
                                        const float* __restrict__ t_max, int r, int n_rays) {
  Ray ray{{0.f, 0.f, 0.f}, {0.f, 0.f, 1.f}, 0.f, -gst::kBig, false};
  if (r < n_rays) {
    ray.o = {origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
    ray.d = {direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
    ray.lo = t_min[r];
    ray.hi = t_max[r];
  }
  ray.live = ray.hi > ray.lo;
  return ray;
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
               const float* __restrict__ woop_t, int n_slots, int n_rows,
               const float* __restrict__ t_min, const float* __restrict__ t_max,
               int n_rays, float* __restrict__ t_out, int* __restrict__ prim_out) {
  extern __shared__ float4 sw[];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const Ray ray = load_ray(origin, direction, t_min, t_max, r, n_rays);
  float best_t = gst::kBig;
  int best_prim = -1;
  if (__syncthreads_or(ray.live)) {
    for (int base = 0; base < n_rows; base += kChunk) {
      const int count = min(kChunk, n_rows - base);
      if (base > 0) __syncthreads();  // every warp is done with the last chunk
      stage(sw, woop_t, n_slots, base, count);
      __syncthreads();
      if (!ray.live) continue;
      const gst::BruteIsect rows{sw, gst::brute_pad(count)};
      for (int j = 0; j < rows.n; j += gst::kBruteUnroll) {
#pragma unroll
        for (int k = 0; k < gst::kBruteUnroll; ++k) {
          float t, u, v;
          if (rows.test(j + k, ray.o, ray.d, ray.lo, ray.hi, t, u, v) && t < best_t) {
            best_t = t;
            best_prim = base + j + k;
          }
        }
      }
    }
  }
  if (r < n_rays) {
    t_out[r] = best_t;
    prim_out[r] = best_t < gst::kBig ? best_prim : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
           const float* __restrict__ woop_t, int n_slots, int n_rows,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           int n_rays, bool* __restrict__ occ_out) {
  extern __shared__ float4 sw[];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const Ray ray = load_ray(origin, direction, t_min, t_max, r, n_rays);
  bool occ = false;
  bool searching = ray.live;
  for (int base = 0; base < n_rows; base += kChunk) {
    // the barrier before the staging: every warp is done with the last
    // chunk, and the CTA leaves once none of its rays is searching
    if (!__syncthreads_or(searching)) break;
    const int count = min(kChunk, n_rows - base);
    stage(sw, woop_t, n_slots, base, count);
    __syncthreads();
    const gst::BruteIsect rows{sw, gst::brute_pad(count)};
    if (searching && rows.any(ray.o, ray.d, ray.lo, ray.hi)) {
      occ = true;
      searching = false;
    }
  }
  if (r < n_rays) occ_out[r] = occ;
}

// kernel over n_rays rays, one thread a ray, with the shared memory of the
// largest chunk of n_rows rows
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int n_rays, int n_rows, cudaStream_t stream,
           Args... args) {
  if (n_rays == 0) return 0;
  const size_t smem = gst::brute_smem(std::min(n_rows, kChunk));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// The (12, n_slots) table, its first n_rows slots tested (0 <= n_rows <=
// n_slots, checked by the wrapper).
extern "C" int gst_closest(const float* origin, const float* direction, const float* woop_t,
                           int n_slots, int n_rows, const float* t_min, const float* t_max,
                           int n_rays, float* t_out, int* prim_out, void* stream) {
  return launch(closest_kernel, n_rays, n_rows, (cudaStream_t)stream, origin, direction, woop_t,
                n_slots, n_rows, t_min, t_max, n_rays, t_out, prim_out);
}

extern "C" int gst_any(const float* origin, const float* direction, const float* woop_t,
                       int n_slots, int n_rows, const float* t_min, const float* t_max,
                       int n_rays, bool* occ_out, void* stream) {
  return launch(any_kernel, n_rays, n_rows, (cudaStream_t)stream, origin, direction, woop_t,
                n_slots, n_rows, t_min, t_max, n_rays, occ_out);
}
