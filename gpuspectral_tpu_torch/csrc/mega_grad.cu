// K5: the fused forward-gradient megakernel (brute force), for sm_90a.
//
// Replaces gpuspectral_tpu/integrator/mega_grad.py: _mega_fwdgrad_blocks
// (the pallas_call around _make_grad_kernel, hook make_diffuse_grad_hook).
// Wrapper: gpuspectral_tpu_torch/integrator/mega_grad.py
// (render_mega_fwdgrad_rows).  It is K1 (mega.cu) with the gradient hook of
// grad.cuh: one launch renders the pixel rows and leaves, per lane, the
// un-contracted gradient partials of diffuse albedo and emitter radiance;
// the backward pass is a contraction outside the kernel.
//
// What bounds it on the H100: what bounds K1, the brute-force loops (every
// bounce tests all n_tris triangles, then again for the shadow ray), plus
// the hook's partial planes: up to 3R + 6 read-modify-writes of the lane's
// own columns per bounce (R <= 8 rows), coalesced across a warp and far
// below the intersection work at Cornell's 36 triangles.  The design keeps
// the partials in device memory rather than registers (48 floats on top of
// K1's 122 registers would spill) and the per-row bounce counts in
// registers; no atomics, since each lane owns its columns.
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "brute.cuh"
#include "grad.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mega_grad_kernel(const int* __restrict__ pix, int n_lanes, const float* __restrict__ woop_t,
                 int t_stride, int n_tris, gst::Tables T, gst::Params P,
                 const int* __restrict__ rows, const float* __restrict__ kd, int n_rows,
                 int n_glights, float* __restrict__ rad_r, float* __restrict__ rad_g,
                 float* __restrict__ rad_b, int* __restrict__ rays_out, float* parts) {
  extern __shared__ float sw[];  // (12, n_tris) Woop rows
  gst::stage_woop(sw, woop_t, t_stride, n_tris);
  const gst::BruteIsect isect{sw, n_tris};
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  gst::render_lane<gst::BruteIsect, false>(
      isect, T, P, lane, n_lanes, pix, rad_r, rad_g, rad_b, rays_out,
      gst::make_grad_hook(parts, rows, kd, n_lanes, lane, n_rows, n_glights,
                          P.attr_stride - 1));
}

}  // namespace

// As gst_mega, plus: rows (n_rows,) BSDF rows, kd (n_rows, 3), n_glights
// lights tracked, parts (3 n_rows + 6 n_glights, n_lanes) zero-filled
// partial planes.  attr carries the BSDF row in its last column.
extern "C" int gst_mega_grad(const int* pix, int n_lanes, const float* woop_t, int t_stride,
                             int n_tris, const float* attr, const float* light,
                             const float* cam, const float* env, const int* ip, const float* fp,
                             const int* rows, const float* kd, int n_rows, int n_glights,
                             float* rad_r, float* rad_g, float* rad_b, int* rays, float* parts,
                             void* stream) {
  if (n_lanes == 0) return 0;
  if (n_rows > gst::kMaxGradRows || n_glights > gst::kMaxGradLights) {
    return (int)cudaErrorInvalidValue;
  }
  const gst::Params P = gst::make_params(ip, fp);
  const gst::Tables T{attr, light, nullptr, nullptr, cam, gst::make_env(env, ip)};
  const size_t smem = sizeof(float) * 12 * (size_t)n_tris;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mega_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  mega_grad_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      pix, n_lanes, woop_t, t_stride, n_tris, T, P, rows, kd, n_rows, n_glights, rad_r, rad_g,
      rad_b, rays, parts);
  return (int)cudaGetLastError();
}
