// K3: BVH closest-hit and any-hit, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/ftb.py: _ftb_closest_arrays (K3a, the
// front-to-back binned closest hit) and ftb_any (K3b).  Wrapper:
// gpuspectral_tpu_torch/bvh/ftb.py (ftb_closest, ftb_any).
//
// What bounds it on the H100: the SIMT efficiency of a divergent per-ray
// walk and the latency of its scattered reads.  One thread walks one ray
// down the child-pair rows of bvh.cuh (near child first, while-while): per
// visited inner node 64 B of two boxes, per visited cluster 16 x 48 B of
// Woop rows, in an order that differs from ray to ray.  The design reads
// every row with 128-bit loads and keeps the tables in the 50 MB L2 (the
// sphere field's Woop table as stored, 262,144 slots x 48 B, is 12.6 MB;
// its pair rows 9,224 x 64 B, 590 KB) and the SM's 256 KB of L1 and shared
// memory all to the L1 cache, at K4's 16 warps an SM (32 gave no gain on
// primary rays, 0.698 against 0.692 ms in PERF.md's study, round 3; 16 keep
// the threads' local stacks to half as much of L1).  Divergence between the
// rays of a warp is the open cost: the TPU kernel's block-wide
// front-to-back rounds (ftb.py:15-40) share one sweep across 128 rays,
// which a per-ray walk gives up.
//
// gst_bvh_count is no part of the render path: it runs the preorder walk
// of bvh.cuh (bvh_closest / bvh_any) with a TestCount and writes each
// ray's box and Woop tests (bvh/ftb.py: ftb_walk_tests).
// gst_bvh_walk_count counts the pair walk's own tests the same way
// (ftb.walk_tests).  A BVH kernel's least time on the card is counted from
// the fewer of the two walks' operations, ray by ray.
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerSm = 16;
constexpr int kCtasPerSm = kWarpsPerSm * 32 / kThreads;

__device__ __forceinline__ gst::V3 ray3(const float* p, int r) {
  return gst::V3{p[3 * r], p[3 * r + 1], p[3 * r + 2]};
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bvh_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ t_max, int n_rays, gst::WalkTables B,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float t, u, v;
  int prim;
  gst::walk_closest(B, ray3(origin, r), ray3(direction, r), t_max[r], t, prim, u, v);
  t_out[r] = t;
  prim_out[r] = prim;
  u_out[r] = u;
  v_out[r] = v;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bvh_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
               const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
               gst::WalkTables B, bool* __restrict__ occ_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  occ_out[r] = gst::walk_any(B, ray3(origin, r), ray3(direction, r), t_min[r], t_max[r]);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
walk_count_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                  const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                  gst::WalkTables B, int any_hit, int* __restrict__ boxes_out,
                  int* __restrict__ woops_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  gst::TestCount count;
  if (any_hit) {
    gst::walk_any(B, ray3(origin, r), ray3(direction, r), t_min[r], t_max[r], count);
  } else {
    float t, u, v;
    int prim;
    gst::walk_closest(B, ray3(origin, r), ray3(direction, r), t_max[r], t, prim, u, v, count);
  }
  boxes_out[r] = count.boxes;
  woops_out[r] = count.woops;
}

__global__ void __launch_bounds__(kThreads)
bvh_count_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                 const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                 gst::BvhTables B, int any_hit, int* __restrict__ boxes_out,
                 int* __restrict__ woops_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o = ray3(origin, r), d = ray3(direction, r);
  gst::TestCount count;
  if (any_hit) {
    gst::bvh_any(B, o, d, t_min[r], t_max[r], count);
  } else {
    float t, u, v;
    int prim;
    gst::bvh_closest(B, o, d, t_max[r], t, prim, u, v, count);
  }
  boxes_out[r] = count.boxes;
  woops_out[r] = count.woops;
}

int blocks(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

// walk_ip: the ints of bvh.cuh:make_walk_tables (bvh/ftb.py:walk_tables)
extern "C" int gst_bvh_closest(const float* origin, const float* direction, const float* t_max,
                               int n_rays, const float* pairs, const float* woop,
                               const int* walk_ip, float* t_out, int* prim_out, float* u_out,
                               float* v_out, void* stream) {
  if (n_rays == 0) return 0;
  bvh_closest_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays, gst::make_walk_tables(pairs, woop, walk_ip), t_out,
      prim_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_bvh_any(const float* origin, const float* direction, const float* t_min,
                           const float* t_max, int n_rays, const float* pairs, const float* woop,
                           const int* walk_ip, bool* occ_out, void* stream) {
  if (n_rays == 0) return 0;
  bvh_any_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, gst::make_walk_tables(pairs, woop, walk_ip),
      occ_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_bvh_walk_count(const float* origin, const float* direction,
                                  const float* t_min, const float* t_max, int n_rays,
                                  const float* pairs, const float* woop, const int* walk_ip,
                                  int any_hit, int* boxes_out, int* woops_out, void* stream) {
  if (n_rays == 0) return 0;
  walk_count_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, gst::make_walk_tables(pairs, woop, walk_ip),
      any_hit, boxes_out, woops_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_bvh_count(const float* origin, const float* direction, const float* t_min,
                             const float* t_max, int n_rays, const float* nodes, const int* meta,
                             const float* clusters, const float* woop_t, const int* bvh_ip,
                             int any_hit, int* boxes_out, int* woops_out, void* stream) {
  if (n_rays == 0) return 0;
  bvh_count_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays,
      gst::make_bvh_tables(nodes, meta, clusters, woop_t, bvh_ip), any_hit, boxes_out, woops_out);
  return (int)cudaGetLastError();
}
