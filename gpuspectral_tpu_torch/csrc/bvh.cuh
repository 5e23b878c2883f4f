// Per-ray BVH walk shared by K3 (bvh.cu) and K4 (mega_bvh.cu).
//
// The tree is the scene build's preorder table with skip pointers
// (SceneData.bvh_dfs_bounds / bvh_dfs_meta, bvh/tables.py:build_dfs_tables):
// a stackless walk visits node i, descends to i + 1 when the ray's segment
// enters its box and jumps to skip[i] when it does not.  A leaf covers
// leaf_span clusters of leaf_size triangle slots; each cluster's own box
// (the implicit tree's leaf level) is tested before its slots are.
//
// Exactness: the result equals the brute-force Woop scan over every slot
// (ops/woop.py:closest_scan / any_scan) bit for bit.  Box tests only ever
// skip work, never change the answer: a node is culled only when the entry
// distance of its box lies beyond the committed t, with the slab interval
// widened by a relative margin so that rounding in the slab arithmetic
// cannot cull a box whose triangle the Woop test would accept.  Closest hit
// commits on t < best || (t == best && slot < best_slot): the lowest slot
// among exactly tied t wins, as in the brute scan, whatever order the walk
// visits them in.
#pragma once

#include "common.cuh"

namespace gst {

struct BvhTables {
  const float* nodes;     // (6, n_nodes): rows 0-2 lo, 3-5 hi
  const int* meta;        // (2, n_nodes): skip index, first slot of a leaf or -1
  const float* clusters;  // (6, n_clusters): cluster boxes, inverted when empty
  const float* woop_t;    // (12, n_slots)
  int n_nodes, n_clusters, n_slots, leaf_size, leaf_span;
};

// bvh_ip (host): n_nodes, n_clusters, n_slots, leaf_size, leaf_span
inline BvhTables make_bvh_tables(const float* nodes, const int* meta, const float* clusters,
                                 const float* woop_t, const int* bvh_ip) {
  return BvhTables{nodes,     meta,      clusters,  woop_t,   bvh_ip[0],
                   bvh_ip[1], bvh_ip[2], bvh_ip[3], bvh_ip[4]};
}

constexpr float kSlabMargin = 1.0f / 16384.0f;

__device__ __forceinline__ float inv_dir1(float x) {
  const float mag = fmaxf(fabsf(x), 1e-12f);
  return 1.0f / (x < 0.0f ? -mag : mag);
}

// Whether the ray's segment [lo, hi] enters box i of a (6, stride) table.
__device__ __forceinline__ bool box_entered(const float* __restrict__ b, int stride, int i, V3 o,
                                            V3 inv, float lo, float hi) {
  const float t0x = (b[i] - o.x) * inv.x;
  const float t1x = (b[3 * stride + i] - o.x) * inv.x;
  const float t0y = (b[stride + i] - o.y) * inv.y;
  const float t1y = (b[4 * stride + i] - o.y) * inv.y;
  const float t0z = (b[2 * stride + i] - o.z) * inv.z;
  const float t1z = (b[5 * stride + i] - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), lo));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), hi));
  return tn - kSlabMargin * fabsf(tn) <= tf + kSlabMargin * fabsf(tf);
}

struct NoCount {
  __device__ __forceinline__ void box() {}
  __device__ __forceinline__ void woop() {}
};

struct TestCount {
  int boxes = 0, woops = 0;
  __device__ __forceinline__ void box() { ++boxes; }
  __device__ __forceinline__ void woop() { ++woops; }
};

__device__ __forceinline__ bool cluster_empty(const BvhTables& B, int c) {
  return B.clusters[c] > B.clusters[3 * B.n_clusters + c];
}

// Closest hit with t in (0, t_max): prim = -1, t = 1e30, u = v = 0 on a miss.
template <class Count = NoCount>
__device__ inline void bvh_closest(const BvhTables& B, V3 o, V3 d, float t_max, float& best_t,
                                   int& best_prim, float& best_u, float& best_v,
                                   Count&& count = Count()) {
  const V3 inv = v3(inv_dir1(d.x), inv_dir1(d.y), inv_dir1(d.z));
  best_t = fminf(t_max, kBig);
  best_prim = -1;
  best_u = 0.0f;
  best_v = 0.0f;
  int ptr = 0;
  while (ptr < B.n_nodes) {
    count.box();
    if (!box_entered(B.nodes, B.n_nodes, ptr, o, inv, 0.0f, best_t)) {
      ptr = B.meta[ptr];
      continue;
    }
    const int leaf = B.meta[B.n_nodes + ptr];
    ptr += 1;
    if (leaf < 0) continue;
    const int c0 = leaf / B.leaf_size;
    const int c1 = min(c0 + B.leaf_span, B.n_clusters);
    for (int c = c0; c < c1; ++c) {
      if (cluster_empty(B, c)) continue;
      count.box();
      if (!box_entered(B.clusters, B.n_clusters, c, o, inv, 0.0f, best_t)) continue;
      const int s1 = min((c + 1) * B.leaf_size, B.n_slots);
      for (int s = c * B.leaf_size; s < s1; ++s) {
        float t, u, v;
        count.woop();
        if (woop_test(B.woop_t + s, B.n_slots, o, d, 0.0f, t_max, t, u, v) &&
            (t < best_t || (t == best_t && s < best_prim))) {
          best_t = t;
          best_prim = s;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
  if (best_prim < 0) best_t = kBig;
}

// Any hit with t in (t_lo, t_hi): stops at the first occluder.
template <class Count = NoCount>
__device__ inline bool bvh_any(const BvhTables& B, V3 o, V3 d, float t_lo, float t_hi,
                               Count&& count = Count()) {
  if (!(t_hi > t_lo)) return false;
  const V3 inv = v3(inv_dir1(d.x), inv_dir1(d.y), inv_dir1(d.z));
  int ptr = 0;
  while (ptr < B.n_nodes) {
    count.box();
    if (!box_entered(B.nodes, B.n_nodes, ptr, o, inv, t_lo, t_hi)) {
      ptr = B.meta[ptr];
      continue;
    }
    const int leaf = B.meta[B.n_nodes + ptr];
    ptr += 1;
    if (leaf < 0) continue;
    const int c0 = leaf / B.leaf_size;
    const int c1 = min(c0 + B.leaf_span, B.n_clusters);
    for (int c = c0; c < c1; ++c) {
      if (cluster_empty(B, c)) continue;
      count.box();
      if (!box_entered(B.clusters, B.n_clusters, c, o, inv, t_lo, t_hi)) continue;
      const int s1 = min((c + 1) * B.leaf_size, B.n_slots);
      for (int s = c * B.leaf_size; s < s1; ++s) {
        float t, u, v;
        count.woop();
        if (woop_test(B.woop_t + s, B.n_slots, o, d, t_lo, t_hi, t, u, v)) return true;
      }
    }
  }
  return false;
}

}  // namespace gst
