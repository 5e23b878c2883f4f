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
// the hook's partials: up to 3R + 6 read-modify-writes of the lane's own
// columns per bounce (R <= 8 rows).  In device memory those cost K5 2x K1
// once a warp's lanes are scattered pixels (each add a sector of its own),
// so the design keeps them in shared memory: a (NP, 128) block a CTA,
// NP = 3R + 6Lg floats a thread (<= 24 KB beside <= 96 KB of Woop rows),
// each thread adding to its own column (no bank conflicts, no atomics) and
// writing a lane's NP sums to the planes once, when its samples end
// (grad.cuh's GradHookT<true>).  The rest is K1's: brute.cuh's staged
// float4 rows and the resident grid whose threads take their next pixel
// lane from a counter; the per-row bounce counts stay in registers, and
// the registers are capped at 128 so that 4 CTAs fit an SM.  The variant
// study (tools/torch_mega_variants.py) sets kGradCtasPerSm (1: no cap);
// the partials in device memory (1.16x slower) and one CTA a 128 lanes
// (1.17x) build from that tool at commit e03242e.
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "brute.cuh"
#include "grad.cuh"

namespace {

constexpr int kThreads = 128;
// __launch_bounds__'s minimum CTAs an SM: 4 caps K5 at 128 registers (no
// spill), which K1's design and the hook would otherwise take to ~148, 3
// CTAs an SM
constexpr int kGradCtasPerSm = 4;

__global__ void __launch_bounds__(kThreads, kGradCtasPerSm)
mega_grad_kernel(const int* __restrict__ pix, int n_lanes, const float4* __restrict__ woop,
                 int n_tris, gst::Tables T, gst::Params P, const int* __restrict__ rows,
                 const float* __restrict__ kd, int n_rows, int n_glights,
                 float* __restrict__ rad_r, float* __restrict__ rad_g,
                 float* __restrict__ rad_b, int* __restrict__ rays_out, float* parts,
                 int* next) {
  extern __shared__ float4 sw[];  // the staged Woop rows (brute.cuh), then the partials
  const int n_pad = gst::brute_pad(n_tris);
  gst::stage_woop_rows(sw, woop, n_tris, n_pad);
  const gst::BruteIsect isect{sw, n_pad};
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  gst::render_lane<gst::BruteIsect, false>(
      isect, T, P, lane, n_lanes, pix, rad_r, rad_g, rad_b, rays_out,
      gst::make_grad_hook<true>(parts, rows, kd, n_lanes, lane, n_rows, n_glights,
                                P.attr_stride - 1, reinterpret_cast<float*>(sw + 3 * n_pad)),
      gst::LaneCounter{next, (int)(gridDim.x * blockDim.x)});
}

}  // namespace

// As gst_mega, plus: rows (n_rows,) BSDF rows, kd (n_rows, 3), n_glights
// lights tracked, parts (3 n_rows + 6 n_glights, n_lanes) zero-filled
// partial planes.  attr carries the BSDF row in its last column.
extern "C" int gst_mega_grad(const int* pix, int n_lanes, const float* woop, int n_tris,
                             const float* attr, const float* light, const float* cam,
                             const float* env, const int* ip, const float* fp, const int* rows,
                             const float* kd, int n_rows, int n_glights, float* rad_r,
                             float* rad_g, float* rad_b, int* rays, float* parts, int* next,
                             int max_ctas, void* stream) {
  if (n_lanes == 0) return 0;
  if (n_rows > gst::kMaxGradRows || n_glights > gst::kMaxGradLights) {
    return (int)cudaErrorInvalidValue;
  }
  const gst::Params P = gst::make_params(ip, fp);
  const gst::Tables T{attr, light, nullptr, nullptr, cam, gst::make_env(env, ip)};
  const size_t shared_parts = sizeof(float) * (3 * n_rows + 6 * n_glights) * kThreads;
  return gst::brute_launch<kThreads>(
      mega_grad_kernel, n_lanes, n_tris, shared_parts, next, max_ctas, (cudaStream_t)stream, pix,
      n_lanes, reinterpret_cast<const float4*>(woop), n_tris, T, P, rows, kd, n_rows,
      n_glights, rad_r, rad_g, rad_b, rays, parts, next);
}
