// K1: the persistent path-tracing megakernel, for sm_90a.
//
// Replaces gpuspectral_tpu/integrator/mega.py: render_mega_rows (the
// pallas_call built by _make_kernel around make_bounce_body), environment
// emitters included.  Wrapper: gpuspectral_tpu_torch/integrator/mega.py
// (render_mega_rows).  The per-lane tracer is bounce.cuh:render_lane,
// shared with K4, with the brute-force intersector of brute.cuh (shared with
// K5).
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
// attributes are one 128-byte row gathered from L1/L2 per hit.  The
// environment map (at most 2048 texels, the JAX package's fused-kernel cap)
// is read with plain loads from L1/L2, its CDF inverted by binary search.
// Register pressure is reported by the build (-Xptxas -v).
//
// What the TPU design needed and this one does not: (16,128) state planes,
// SMEM scalar broadcasts, select-chain gathers and one-hot texel
// contractions become registers and plain loads; the Mosaic-safe
// uint32->float conversion, modulo and division become __uint2float_rn, %
// and /; int32 bool carries become bool.
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "brute.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mega_kernel(const int* __restrict__ pix, int n_lanes, const float* __restrict__ woop_t,
            int t_stride, int n_tris, gst::Tables T, gst::Params P, float* __restrict__ rad_r,
            float* __restrict__ rad_g, float* __restrict__ rad_b, int* __restrict__ rays_out) {
  extern __shared__ float sw[];  // (12, n_tris) Woop rows
  gst::stage_woop(sw, woop_t, t_stride, n_tris);
  const gst::BruteIsect isect{sw, n_tris};
  gst::render_lane<gst::BruteIsect, false>(isect, T, P, blockIdx.x * blockDim.x + threadIdx.x,
                                           n_lanes, pix, rad_r, rad_g, rad_b, rays_out);
}

}  // namespace

// ip / fp: host arrays in bounce.cuh's IParam / FParam order; env: the
// environment table [rot 9 | rgb | cdf | pdf] (read only when IP_HAS_ENV).
extern "C" int gst_mega(const int* pix, int n_lanes, const float* woop_t, int t_stride,
                        int n_tris, const float* attr, const float* light, const float* cam,
                        const float* env, const int* ip, const float* fp, float* rad_r,
                        float* rad_g, float* rad_b, int* rays, void* stream) {
  if (n_lanes == 0) return 0;
  const gst::Params P = gst::make_params(ip, fp);
  const gst::Tables T{attr, light, nullptr, nullptr, cam, gst::make_env(env, ip)};
  const size_t smem = sizeof(float) * 12 * (size_t)n_tris;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  mega_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      pix, n_lanes, woop_t, t_stride, n_tris, T, P, rad_r, rad_g, rad_b, rays);
  return (int)cudaGetLastError();
}
