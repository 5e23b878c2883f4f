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
// again (shadow ray), ~30 float operations each, so the work is about
// 2 * n_tris tests per bounce and no memory stream at all.  The design
// keeps that loop on chip and its lanes busy:
//   * the block stages the scene's (n_tris, 12) Woop rows in shared memory
//     once (<= 96 KB at the 2048-triangle limit) as three float4 a
//     triangle; every thread of a warp walks the same triangle at the same
//     time, so a test is three 128-bit shared-memory broadcasts
//     (brute.cuh, the loop unrolled over zero-padded rows);
//   * the grid stays resident (the CTAs the card holds at once) and a
//     thread whose pixel's samples end takes the next pixel lane from a
//     counter (bounce.cuh's LaneCounter), so no warp waits on its slowest
//     pixel and no SM idles in a last partial wave; one thread still runs
//     all of a pixel's samples in order, so its sums do not change.
// The loop is written as "one bounce per iteration, regenerate finished
// lanes", as the TPU kernel's while loop is, so the live threads of a warp
// reach the intersection loops together.  Shading diverges by BSDF kind (a
// switch over 8 kinds); per-triangle attributes are one 128-byte row
// gathered from L1/L2 per hit.  The environment map (at most 2048 texels,
// the JAX package's fused-kernel cap) is read with plain loads from L1/L2,
// its CDF inverted by binary search.  Register pressure is reported by the
// build (-Xptxas -v).  The variant study (tools/torch_mega_variants.py)
// sets kCtasPerSm (__launch_bounds__'s minimum CTAs an SM; 1 caps
// nothing); one CTA a 128 lanes with a thread a lane, the earlier schedule,
// builds from that tool at commit e03242e (1.11x slower).
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
constexpr int kCtasPerSm = 1;

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mega_kernel(const int* __restrict__ pix, int n_lanes, const float4* __restrict__ woop,
            int n_tris, gst::Tables T, gst::Params P, float* __restrict__ rad_r,
            float* __restrict__ rad_g, float* __restrict__ rad_b, int* __restrict__ rays_out,
            int* next) {
  extern __shared__ float4 sw[];  // the staged Woop rows (brute.cuh)
  const int n_pad = gst::brute_pad(n_tris);
  gst::stage_woop_rows(sw, woop, n_tris, n_pad);
  const gst::BruteIsect isect{sw, n_pad};
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  gst::render_lane<gst::BruteIsect, false>(isect, T, P, lane, n_lanes, pix, rad_r, rad_g, rad_b,
                                           rays_out, gst::NoHook(),
                                           gst::LaneCounter{next, (int)(gridDim.x * blockDim.x)});
}

}  // namespace

// woop: the (n_tris, 12) Woop rows, 16-byte aligned; ip / fp: host arrays in
// bounce.cuh's IParam / FParam order; env: the environment table [rot 9 |
// rgb | cdf | pdf] (read only when IP_HAS_ENV); next: one int of device
// memory, the lane counter (zeroed here on the stream); max_ctas > 0 caps
// the resident grid (tests), 0 takes what the card holds.
extern "C" int gst_mega(const int* pix, int n_lanes, const float* woop, int n_tris,
                        const float* attr, const float* light, const float* cam,
                        const float* env, const int* ip, const float* fp, float* rad_r,
                        float* rad_g, float* rad_b, int* rays, int* next, int max_ctas,
                        void* stream) {
  if (n_lanes == 0) return 0;
  const gst::Params P = gst::make_params(ip, fp);
  const gst::Tables T{attr, light, nullptr, nullptr, cam, gst::make_env(env, ip)};
  return gst::brute_launch<kThreads>(
      mega_kernel, n_lanes, n_tris, 0, next, max_ctas, (cudaStream_t)stream, pix, n_lanes,
      reinterpret_cast<const float4*>(woop), n_tris, T, P, rad_r, rad_g, rad_b, rays, next);
}
