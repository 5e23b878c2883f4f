// K7f / K7g: the gated depth-first walk, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/dfs_sweep.py: _make_closest_kernel (K7f,
// the pallas_call at dfs_sweep.py:427) and _make_any_kernel (K7g, :474).
// Wrapper: gpuspectral_tpu_torch/bvh/dfs_sweep.py (dfs_closest, dfs_any).
//
// Rays come in blocks of kBlock = 32 consecutive rays; one CTA of 32
// threads (one warp) takes one block, one thread per ray, the ray's state
// in registers.  32 was the fastest CTA of 32 / 64 / 128 / 256 for both
// kernels on random and primary rays (tools/torch_dfs_block.py): a smaller
// block enters fewer leaves for its rays.  The CTA walks the scene's
// preorder tables from node 0: bounds (6, N) float (lo xyz, hi xyz) and
// meta (2, N) int (the skip pointer past the node's subtree; a leaf's first
// slot, -1 for an internal node).
//
//   * Every thread slab-tests the node's box (a uniform load) on its
//     segment [t_min, horizon]; __syncthreads_or is the block's vote.  The
//     CTA enters the node (ptr + 1) if any ray passes, else jumps the
//     subtree (ptr = skip).  The branch is uniform across the CTA.
//   * At an entered leaf the CTA stages the leaf's kSweep = 128 slots' 12
//     Woop rows in shared memory (6 KB), and every thread tests its ray
//     against all of them, in slot order, rays whose own slab test failed
//     included.
//   K7f  commits t in (0, best) with a strict `<`, so among exactly tied t
//        the lowest slot wins (leaves come in ascending slot order); the
//        ray's horizon is its best t, which culls the rest of the walk.
//        At the end each thread writes t, prim, u, v and its winning
//        slot's A attribute floats.
//   K7g  marks the ray occluded at its first hit in (t_min, t_max); an
//        occluded ray's horizon falls to -1e30, so it stops voting.  The
//        CTA stops once every ray is occluded or has an empty segment
//        (__syncthreads_and), which cannot change the result.
// Threads of inactive rays (t_max = -1e30) and of padding rays past the
// last ray take part in every barrier and never vote or hit; they skip the
// Woop tests.  The __syncthreads_or at the top of an iteration is also the
// barrier between the previous leaf's readers and the next staging.
//
// What bounds it on the H100: operations.  An entered leaf costs every ray
// of the block 128 Woop tests (~32 flops each, operands broadcast from
// shared memory), so the block's votes set the time: rays that agree on
// few leaves (primary rays, sorted bounce rays, shadow rays sorted by
// endpoint) walk few, and a block of incoherent rays enters the union of
// its rays' leaves.  The walk itself is one slab test (12 flops) per node
// visited by the block, with the node's bounds read once per CTA from L1.
//
// Precision: built with --fmad=false like the other kernels.  The slab
// test is plain subtracts, multiplies, min / max and an IEEE division for
// the inverse direction (math3d.safe_div(1, d)), as the plain torch walk
// computes them, so the votes are equal.  The Woop test is
// csrc/common.cuh:woop_test, whose fmaf calls sit where ops/woop.py calls
// m3.fma.  So t, prim, u and v equal the plain walk bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 32;  // rays per CTA = dfs_sweep.BLOCK
constexpr int kSweep = 128;  // slots of a leaf = dfs_sweep.SWEEP

__global__ void __launch_bounds__(kBlock)
dfs_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ t_max, int n_rays, const float* __restrict__ bounds,
                   const int* __restrict__ meta, int n_nodes, const float* __restrict__ woop_t,
                   int n_slots, const float* __restrict__ attr, int n_attr,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   float* __restrict__ attr_out) {
  __shared__ float w[12][kSweep];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;  // padding rays: o 0, d 1, t_max -1e30
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = {gst::inv_dir(d.x), gst::inv_dir(d.y), gst::inv_dir(d.z)};
  float best = live ? t_max[r] : -gst::kBig;  // also the voting horizon
  const bool tests = best > 0.0f;  // t must lie in (0, best): else never hits
  float best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  int ptr = 0;
  while (ptr < n_nodes) {
    if (!__syncthreads_or(gst::slab(bounds, n_nodes, ptr, o, inv, 0.0f, best))) {
      ptr = meta[ptr];  // the same for every thread of the CTA
      continue;
    }
    const int off = meta[n_nodes + ptr];
    ++ptr;
    if (off < 0) continue;
    const int n = min(kSweep, n_slots - off);
    gst::stage<kBlock, kSweep>(w, woop_t, n_slots, off, n);
    __syncthreads();
    if (!tests) continue;
    for (int c = 0; c < n; ++c) {
      float t, u, v;
      if (gst::woop_test(&w[0][c], kSweep, o, d, 0.0f, best, t, u, v)) {
        best = t;
        best_u = u;
        best_v = v;
        best_prim = off + c;
      }
    }
  }
  if (!live) return;
  const bool hit = best_prim >= 0;
  t_out[r] = hit ? best : gst::kBig;
  prim_out[r] = best_prim;
  u_out[r] = hit ? best_u : 0.0f;
  v_out[r] = hit ? best_v : 0.0f;
  for (int a = 0; a < n_attr; ++a)
    attr_out[(size_t)r * n_attr + a] = hit ? attr[(size_t)best_prim * n_attr + a] : 0.0f;
}

__global__ void __launch_bounds__(kBlock)
dfs_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
               const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
               const float* __restrict__ bounds, const int* __restrict__ meta, int n_nodes,
               const float* __restrict__ woop_t, int n_slots, bool* __restrict__ occ_out) {
  __shared__ float w[12][kSweep];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = {gst::inv_dir(d.x), gst::inv_dir(d.y), gst::inv_dir(d.z)};
  const float lo = live ? t_min[r] : 0.0f;
  const float hi = live ? t_max[r] : -gst::kBig;
  const bool empty = !(hi > lo);  // no t lies in (lo, hi): never occluded
  float horizon = hi;
  bool occ = false;
  int ptr = __syncthreads_and(empty) ? n_nodes : 0;
  while (ptr < n_nodes) {
    if (!__syncthreads_or(gst::slab(bounds, n_nodes, ptr, o, inv, lo, horizon))) {
      ptr = meta[ptr];
      continue;
    }
    const int off = meta[n_nodes + ptr];
    ++ptr;
    if (off < 0) continue;
    const int n = min(kSweep, n_slots - off);
    gst::stage<kBlock, kSweep>(w, woop_t, n_slots, off, n);
    __syncthreads();
    if (!occ && !empty) {
      for (int c = 0; c < n; ++c) {
        float t, u, v;
        if (gst::woop_test(&w[0][c], kSweep, o, d, lo, hi, t, u, v)) {
          occ = true;
          horizon = -gst::kBig;
          break;
        }
      }
    }
    // also the barrier before the next staging: the result is uniform
    if (__syncthreads_and(occ || empty)) break;
  }
  if (live) occ_out[r] = occ;
}

int blocks_for(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int gst_dfs_closest(const float* origin, const float* direction, const float* t_max,
                               int n_rays, const float* bounds, const int* meta, int n_nodes,
                               const float* woop_t, int n_slots, const float* attr, int n_attr,
                               float* t_out, int* prim_out, float* u_out, float* v_out,
                               float* attr_out, void* stream) {
  if (n_rays == 0) return 0;
  dfs_closest_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays, bounds, meta, n_nodes, woop_t, n_slots, attr, n_attr,
      t_out, prim_out, u_out, v_out, attr_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_dfs_any(const float* origin, const float* direction, const float* t_min,
                           const float* t_max, int n_rays, const float* bounds, const int* meta,
                           int n_nodes, const float* woop_t, int n_slots, bool* occ_out,
                           void* stream) {
  if (n_rays == 0) return 0;
  dfs_any_kernel<<<blocks_for(n_rays), kBlock, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, bounds, meta, n_nodes, woop_t, n_slots, occ_out);
  return (int)cudaGetLastError();
}
