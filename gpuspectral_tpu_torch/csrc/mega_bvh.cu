// K4: the persistent path-tracing megakernel with BVH traversal, for sm_90a.
//
// Replaces gpuspectral_tpu/integrator/mega_bvh.py: render_mega_bvh_blocks
// (the fused front-to-back BVH megakernel).  Wrapper:
// gpuspectral_tpu_torch/integrator/mega_bvh.py (render_mega_bvh_rows).
// The per-lane tracer is bounce.cuh:render_lane, shared with K1, here with
// the child-pair walk of bvh.cuh (K3's traversal) as its intersector; on
// top of K1 it runs the power light pick, the per-corner texture blend and
// block-synchronous regeneration (cfg.mega_sync_regen).
//
// What bounds it on the H100: the walk, twice per bounce (closest and
// shadow ray), inside a kernel that also holds the whole shading state:
// the SIMT efficiency of lanes whose walks diverge after the first bounce
// and the latency of their scattered reads; the tests' arithmetic is a few
// percent of the frame.  The design takes bvh.cuh's walk (child pairs on
// 128-bit rows, near child first, while-while, a cluster's Woop loop
// unrolled, the stack in local memory, no shared memory, so the SM's 256 KB
// all serve the L1 cache), 16 warps an SM at up to 128 registers a
// thread, and keeps one pixel's path on one thread from its first ray to
// its last sample, so nothing goes back to device memory between bounces.
// The TPU schedule is not carried over: no VMEM residency or streaming
// DMA, no 1024-ray blocks or traversal subgroups, no per-round bin picks
// or one-hot gathers.  The RNG is keyed by (pixel, sample), so the launch
// layout does not change the image.
#include <cuda_runtime.h>

#include "bounce.cuh"
#include "bvh.cuh"
#include "grad.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCtasPerSm = 512 / kThreads;  // 16 warps an SM

struct BvhIsect {
  gst::WalkTables B;

  __device__ void closest(gst::V3 o, gst::V3 d, float& t, int& prim, float& u, float& v) const {
    gst::walk_closest(B, o, d, gst::kBig, t, prim, u, v);
  }

  __device__ bool any(gst::V3 o, gst::V3 d, float t_lo, float t_hi) const {
    return gst::walk_any(B, o, d, t_lo, t_hi);
  }
};

template <bool kSync>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mega_bvh_kernel(const int* __restrict__ pix, int n_lanes, gst::WalkTables B, gst::Tables T,
                gst::Params P, float* __restrict__ rad_r, float* __restrict__ rad_g,
                float* __restrict__ rad_b, int* __restrict__ rays_out) {
  const BvhIsect isect{B};
  gst::render_lane<BvhIsect, kSync>(isect, T, P, blockIdx.x * blockDim.x + threadIdx.x, n_lanes,
                                    pix, rad_r, rad_g, rad_b, rays_out);
}

// K6: K4 with the gradient hook of grad.cuh (the counterpart of
// gpuspectral_tpu/integrator/mega_grad.py:_mega_bvh_fwdgrad_blocks; wrapper
// integrator/mega_grad.py:render_mega_bvh_fwdgrad_rows).  What bounds it is
// what bounds K4, the per-ray walk; the partial planes add at most 3R + 6
// read-modify-writes of the lane's own columns per bounce.
template <bool kSync>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mega_bvh_grad_kernel(const int* __restrict__ pix, int n_lanes, gst::WalkTables B, gst::Tables T,
                     gst::Params P, const int* __restrict__ rows, const float* __restrict__ kd,
                     int n_rows, int n_glights, float* __restrict__ rad_r,
                     float* __restrict__ rad_g, float* __restrict__ rad_b,
                     int* __restrict__ rays_out, float* parts) {
  const BvhIsect isect{B};
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  gst::render_lane<BvhIsect, kSync>(
      isect, T, P, lane, n_lanes, pix, rad_r, rad_g, rad_b, rays_out,
      gst::make_grad_hook(parts, rows, kd, n_lanes, lane, n_rows, n_glights,
                          P.attr_stride - 1));
}

}  // namespace

// walk_ip: the ints of bvh.cuh:make_walk_tables; ip / fp: host arrays in
// bounce.cuh's IParam / FParam order; env as for gst_mega.
extern "C" int gst_mega_bvh(const int* pix, int n_lanes, const float* pairs, const float* woop,
                            const int* walk_ip, const float* attr, const float* light,
                            const float* light_cdf, const float* light_prob, const float* cam,
                            const float* env, const int* ip, const float* fp, int sync_regen,
                            float* rad_r, float* rad_g, float* rad_b, int* rays, void* stream) {
  if (n_lanes == 0) return 0;
  const gst::WalkTables B = gst::make_walk_tables(pairs, woop, walk_ip);
  const gst::Params P = gst::make_params(ip, fp);
  const gst::Tables T{attr, light, light_cdf, light_prob, cam, gst::make_env(env, ip)};
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  auto kernel = sync_regen ? mega_bvh_kernel<true> : mega_bvh_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pix, n_lanes, B, T, P, rad_r, rad_g,
                                                       rad_b, rays);
  return (int)cudaGetLastError();
}

// As gst_mega_bvh, plus the gradient arguments of gst_mega_grad (attr carries
// the BSDF row in its last column).
extern "C" int gst_mega_bvh_grad(const int* pix, int n_lanes, const float* pairs,
                                 const float* woop, const int* walk_ip, const float* attr,
                                 const float* light, const float* light_cdf,
                                 const float* light_prob, const float* cam, const float* env,
                                 const int* ip, const float* fp, int sync_regen, const int* rows,
                                 const float* kd, int n_rows, int n_glights, float* rad_r,
                                 float* rad_g, float* rad_b, int* rays, float* parts,
                                 void* stream) {
  if (n_lanes == 0) return 0;
  if (n_rows > gst::kMaxGradRows || n_glights > gst::kMaxGradLights) {
    return (int)cudaErrorInvalidValue;
  }
  const gst::WalkTables B = gst::make_walk_tables(pairs, woop, walk_ip);
  const gst::Params P = gst::make_params(ip, fp);
  const gst::Tables T{attr, light, light_cdf, light_prob, cam, gst::make_env(env, ip)};
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  auto kernel = sync_regen ? mega_bvh_grad_kernel<true> : mega_bvh_grad_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pix, n_lanes, B, T, P, rows, kd, n_rows,
                                                       n_glights, rad_r, rad_g, rad_b, rays,
                                                       parts);
  return (int)cudaGetLastError();
}
