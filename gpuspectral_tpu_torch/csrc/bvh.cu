// K3: BVH closest-hit and any-hit, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/ftb.py: _ftb_closest_arrays (K3a, the
// front-to-back binned closest hit) and ftb_any (K3b).  Wrapper:
// gpuspectral_tpu_torch/bvh/ftb.py (ftb_closest, ftb_any).
//
// What bounds it on the H100: scattered reads.  One thread walks one ray
// down the preorder tables (bvh.cuh): per visited node 24 B of box, per
// visited cluster 24 B of box and 16 x 48 B of Woop rows, all gathered from
// global memory in an order that differs from ray to ray.  The design keeps
// the tables in the 50 MB L2 (a 150k-triangle scene's Woop table is ~7 MB,
// its node and cluster boxes under 1 MB) and lets the cluster boxes cull
// most of a leaf's 128 slots before any Woop test; the walk is stackless,
// so a thread holds nothing but its ray and its best hit.  Divergence
// between the rays of a warp is the open cost: the TPU kernel's block-wide
// front-to-back rounds (ftb.py:15-40) exist to share one sweep across 128
// rays, which a per-ray walk gives up for simplicity.
//
// gst_bvh_count is no part of the render path: it runs the same walks with a
// TestCount and writes each ray's box and Woop tests, the work that a BVH
// kernel's least time on the card is counted from (bvh/ftb.py:
// ftb_walk_tests).
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bvh_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ t_max, int n_rays, gst::BvhTables B,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o{origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
  const gst::V3 d{direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
  float t, u, v;
  int prim;
  gst::bvh_closest(B, o, d, t_max[r], t, prim, u, v);
  t_out[r] = t;
  prim_out[r] = prim;
  u_out[r] = u;
  v_out[r] = v;
}

__global__ void __launch_bounds__(kThreads)
bvh_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
               const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
               gst::BvhTables B, bool* __restrict__ occ_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o{origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
  const gst::V3 d{direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
  occ_out[r] = gst::bvh_any(B, o, d, t_min[r], t_max[r]);
}

__global__ void __launch_bounds__(kThreads)
bvh_count_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                 const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                 gst::BvhTables B, int any_hit, int* __restrict__ boxes_out,
                 int* __restrict__ woops_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o{origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
  const gst::V3 d{direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
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

}  // namespace

extern "C" int gst_bvh_closest(const float* origin, const float* direction, const float* t_max,
                               int n_rays, const float* nodes, const int* meta,
                               const float* clusters, const float* woop_t, const int* bvh_ip,
                               float* t_out, int* prim_out, float* u_out, float* v_out,
                               void* stream) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  bvh_closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays,
      gst::make_bvh_tables(nodes, meta, clusters, woop_t, bvh_ip), t_out, prim_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_bvh_any(const float* origin, const float* direction, const float* t_min,
                           const float* t_max, int n_rays, const float* nodes, const int* meta,
                           const float* clusters, const float* woop_t, const int* bvh_ip,
                           bool* occ_out, void* stream) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  bvh_any_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays,
      gst::make_bvh_tables(nodes, meta, clusters, woop_t, bvh_ip), occ_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_bvh_count(const float* origin, const float* direction, const float* t_min,
                             const float* t_max, int n_rays, const float* nodes, const int* meta,
                             const float* clusters, const float* woop_t, const int* bvh_ip,
                             int any_hit, int* boxes_out, int* woops_out, void* stream) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  bvh_count_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays,
      gst::make_bvh_tables(nodes, meta, clusters, woop_t, bvh_ip), any_hit, boxes_out, woops_out);
  return (int)cudaGetLastError();
}
