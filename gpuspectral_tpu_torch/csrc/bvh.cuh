// Per-ray BVH walk shared by K3 (bvh.cu), K4 and K6 (mega_bvh.cu).  The
// cluster sweep's K7d / K7e (cluster.cu) take its widened slab test
// (slab_entered) and its Woop rows (woop_row).
//
// The tree is the implicit tree of the scene build as child pairs
// (SceneData.bvh_pairs, bvh/tables.py:build_pair_rows): one 64-byte row per
// inner node, in breadth-first order, holding both children's boxes and
// codes (a row index, or ~c for a leaf, one cluster c of leaf_size triangle
// slots; empty clusters and the subtrees over them are pruned).  A thread
// tests both children of its node at once, goes on to the nearer one that
// its segment enters and pushes the farther onto a stack (near first: the
// committed t falls sooner, so later boxes cull more; the any hit, which
// stops at its first occluder, takes the left child first).  Each lane descends
// to its next leaf before the warp tests leaves (while-while), so the lanes
// of a warp test their clusters' Woop rows (SceneData.tri_woop, 48 bytes a
// slot) together instead of one lane's leaf at a time.  Every row is read
// with 128-bit read-only loads.
//
// What bounds it on the H100: the SIMT efficiency of a divergent walk and
// the latency of its scattered reads.  Once the rays of a warp leave their
// first hits they stand at different nodes, each load of a warp touches up
// to 32 cache lines, and each lane's walk has its own length; the tests'
// arithmetic is milliseconds a frame against hundreds.  The design keeps
// the lanes' leaf tests in step (while-while: one walk step a loop turn
// took K4 1.45x as long), visits near children first (left first: 1.2x),
// tests one cluster a leaf (leaves of 2-8 clusters over rows of their own
// cluster boxes: 1.03-1.22x), unrolls a cluster's Woop loop by 4 so that its rows'
// loads overlap, and leaves the SM's 256 KB of L1 and shared memory all to
// the L1 cache (the stack is a per-thread local array; the top of the tree
// staged in shared memory, or the stack kept there, lost).  The variants
// and their times: tools/torch_mega_bvh_variants.py and PERF.md.
//
// Exactness: the result equals the brute-force Woop scan over every slot
// (ops/woop.py:closest_scan / any_scan) bit for bit.  Box tests only ever
// skip work, never change the answer: a node is culled only when the entry
// distance of its box lies beyond the committed t, with the slab interval
// widened by a relative margin so that rounding in the slab arithmetic
// cannot cull a box whose triangle the Woop test would accept.  A stacked
// child is culled when popped only by its widened entry distance against
// the committed t, widened the same way: that culls no box that the full
// slab test would enter (still_entered).  Closest hit commits on t < best
// || (t == best && slot < best_slot): the lowest slot among exactly tied t
// wins, as in the brute scan, whatever order the walk visits them in.
//
// The preorder walk with skip pointers (SceneData.bvh_dfs_bounds /
// bvh_dfs_meta, bvh_closest / bvh_any below) stays as the counting walk of
// the BVH kernels' bound (bvh.cu: gst_bvh_count); the pair walk counts its
// own tests in gst_bvh_walk_count.
#pragma once

#include "common.cuh"

namespace gst {

// A cluster's Woop tests are unrolled by this factor;
// tools/torch_mega_bvh_variants.py builds copies with other values.
constexpr int kWoopUnroll = 4;
// Stack entries: a path from the root holds at most log2(n_clusters) < 31
// pair rows (a cluster's code ~c is an int).
constexpr int kMaxDepth = 32;

constexpr float kSlabMargin = 1.0f / 16384.0f;

__device__ __forceinline__ float inv_dir1(float x) {
  const float mag = fmaxf(fabsf(x), 1e-12f);
  return 1.0f / (x < 0.0f ? -mag : mag);
}

// Whether the ray's segment [lo, hi] enters the box [bl, bh], the slab
// interval widened by kSlabMargin; `near` is the widened entry distance, the
// left side of the comparison.
__device__ __forceinline__ bool slab_entered(V3 bl, V3 bh, V3 o, V3 inv, float lo, float hi,
                                             float& near) {
  const float t0x = (bl.x - o.x) * inv.x;
  const float t1x = (bh.x - o.x) * inv.x;
  const float t0y = (bl.y - o.y) * inv.y;
  const float t1y = (bh.y - o.y) * inv.y;
  const float t0z = (bl.z - o.z) * inv.z;
  const float t1z = (bh.z - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), lo));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), hi));
  near = tn - kSlabMargin * fabsf(tn);
  return near <= tf + kSlabMargin * fabsf(tf);
}

// Whether a box whose widened entry distance is `near` may still be entered
// by the segment cut at a smaller hi.  slab_entered's right side is
// x + kSlabMargin * |x| at x = min(far, hi) <= hi, and that rises with x,
// so a box this culls the full test culls too.
__device__ __forceinline__ bool still_entered(float near, float hi) {
  return near <= hi + kSlabMargin * fabsf(hi);
}

// ------------------------------------------------- the walk of K3 / K4 ----
struct WalkTables {
  const float4* pairs;  // (n_pairs, 4 float4): [a.lo, code a], [a.hi, code b], [b.lo, 0], [b.hi, 0]
  const float4* woop;   // (n_slots, 3 float4): a slot's 12 Woop floats
  int n_slots, leaf_size, root;
};

// ip (host): n_slots, leaf_size, root code (bvh/ftb.py:walk_tables)
inline WalkTables make_walk_tables(const float* pairs, const float* woop, const int* ip) {
  return WalkTables{reinterpret_cast<const float4*>(pairs), reinterpret_cast<const float4*>(woop),
                    ip[0], ip[1], ip[2]};
}

__device__ __forceinline__ V3 xyz(float4 q) { return v3(q.x, q.y, q.z); }

// One Woop test on a slot's row: the 12 floats of common.cuh:woop_test in
// the order of ops/woop.py's (T, 12) table.
__device__ __forceinline__ bool woop_row(const float4* __restrict__ w, V3 o, V3 d, float t_lo,
                                         float t_hi, float& t, float& u, float& v) {
  const float4 a = __ldg(w), b = __ldg(w + 1), c = __ldg(w + 2);
  return woop_eval(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, o, d, t_lo, t_hi,
                   t, u, v);
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

// The walk's leaf filter: whether it tests cluster c's slots once it
// reaches the cluster.  K3, K4 and K6 test every cluster; K7a / K7b
// (binned.cu) only those of the bins their ray votes for.
struct AllClusters {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// The closest hit among cluster c's slots, committed into best_*.
template <class Count>
__device__ __forceinline__ void cluster_closest(const WalkTables& B, int c, V3 o, V3 d,
                                                float t_max, float& best_t, int& best_prim,
                                                float& best_u, float& best_v, Count& count) {
  const int s1 = min((c + 1) * B.leaf_size, B.n_slots);
#pragma unroll(kWoopUnroll)
  for (int s = c * B.leaf_size; s < s1; ++s) {
    float t, u, v;
    count.woop();
    if (woop_row(B.woop + 3 * s, o, d, 0.0f, t_max, t, u, v) &&
        (t < best_t || (t == best_t && s < best_prim))) {
      best_t = t;
      best_prim = s;
      best_u = u;
      best_v = v;
    }
  }
}

// Whether a triangle of cluster c lies in (t_lo, t_hi).
template <class Count>
__device__ __forceinline__ bool cluster_any(const WalkTables& B, int c, V3 o, V3 d, float t_lo,
                                            float t_hi, Count& count) {
  const int s1 = min((c + 1) * B.leaf_size, B.n_slots);
#pragma unroll(kWoopUnroll)
  for (int s = c * B.leaf_size; s < s1; ++s) {
    float t, u, v;
    count.woop();
    if (woop_row(B.woop + 3 * s, o, d, t_lo, t_hi, t, u, v)) return true;
  }
  return false;
}

// A thread's stack of (code, widened entry distance) in a local array.
struct WalkStack {
  int2 e[kMaxDepth];
  int sp = 0;
  __device__ __forceinline__ void push(int2 x) { e[sp++] = x; }
  __device__ __forceinline__ int2 pop() { return e[--sp]; }
};

// A code that is neither a pair row nor a leaf: the walk is over (and the
// root of a tree without a triangle).
constexpr int kPop = 0x7fffffff;

__device__ __forceinline__ bool inner(int code) { return code >= 0 && code != kPop; }

// One step of the walk at pair row `code`: test both children on [lo, hi];
// returns the code to visit next, or kPop when the segment enters neither.
// When it enters both, the other child is pushed with its widened entry
// distance: the closest hit visits the nearer child first, the any hit the
// left one (near first slowed it, PERF.md's study).
template <bool kClosest, class Count>
__device__ __forceinline__ int pair_step(const WalkTables& B, int code, V3 o, V3 inv, float lo,
                                         float hi, WalkStack& st, Count& count) {
  const float4* row = B.pairs + 4 * code;
  const float4 a_lo = __ldg(row), a_hi = __ldg(row + 1), b_lo = __ldg(row + 2),
               b_hi = __ldg(row + 3);
  float na, nb;
  count.box();
  count.box();
  const bool ea = slab_entered(xyz(a_lo), xyz(a_hi), o, inv, lo, hi, na);
  const bool eb = slab_entered(xyz(b_lo), xyz(b_hi), o, inv, lo, hi, nb);
  const int ca = __float_as_int(a_lo.w), cb = __float_as_int(a_hi.w);
  if (ea && eb) {
    const bool b_first = kClosest && nb < na;
    st.push(make_int2(b_first ? ca : cb, __float_as_int(b_first ? na : nb)));
    return b_first ? cb : ca;
  }
  return ea ? ca : (eb ? cb : kPop);
}

// The next stacked child that the segment may still enter, or kPop: the
// closest hit culls an entry by its entry distance against the committed t.
__device__ __forceinline__ int pop_entered(WalkStack& st, float best_t) {
  while (st.sp > 0) {
    const int2 e = st.pop();
    if (still_entered(__int_as_float(e.y), best_t)) return e.x;
  }
  return kPop;
}

// Closest hit with t in (0, t_max) among the clusters `keep` accepts:
// prim = -1, t = 1e30, u = v = 0 on a miss.
template <class Count = NoCount, class Filter = AllClusters>
__device__ inline void walk_closest(const WalkTables& B, V3 o, V3 d, float t_max, float& best_t,
                                    int& best_prim, float& best_u, float& best_v,
                                    Count&& count = Count(), Filter&& keep = Filter()) {
  const V3 inv = v3(inv_dir1(d.x), inv_dir1(d.y), inv_dir1(d.z));
  best_t = fminf(t_max, kBig);
  best_prim = -1;
  best_u = 0.0f;
  best_v = 0.0f;
  WalkStack st;
  int code = B.root;
  while (code != kPop) {
    while (inner(code)) {
      code = pair_step<true>(B, code, o, inv, 0.0f, best_t, st, count);
      if (code == kPop) code = pop_entered(st, best_t);
    }
    if (code < 0) {
      if (keep(~code)) {
        cluster_closest(B, ~code, o, d, t_max, best_t, best_prim, best_u, best_v, count);
      }
      code = pop_entered(st, best_t);
    }
  }
  if (best_prim < 0) best_t = kBig;
}

// Any hit with t in (t_lo, t_hi) among the clusters `keep` accepts: stops
// at the first occluder.  t_hi never falls, so a stacked child is entered
// when popped.
template <class Count = NoCount, class Filter = AllClusters>
__device__ inline bool walk_any(const WalkTables& B, V3 o, V3 d, float t_lo, float t_hi,
                                Count&& count = Count(), Filter&& keep = Filter()) {
  if (!(t_hi > t_lo)) return false;
  const V3 inv = v3(inv_dir1(d.x), inv_dir1(d.y), inv_dir1(d.z));
  WalkStack st;
  int code = B.root;
  while (code != kPop) {
    while (inner(code)) {
      code = pair_step<false>(B, code, o, inv, t_lo, t_hi, st, count);
      if (code == kPop && st.sp > 0) code = st.pop().x;
    }
    if (code < 0) {
      if (keep(~code) && cluster_any(B, ~code, o, d, t_lo, t_hi, count)) return true;
      code = st.sp > 0 ? st.pop().x : kPop;
    }
  }
  return false;
}

// ------------------------------------------ the counting (preorder) walk ----
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

// Whether the ray's segment [lo, hi] enters box i of a (6, stride) table.
__device__ __forceinline__ bool box_entered(const float* __restrict__ b, int stride, int i, V3 o,
                                            V3 inv, float lo, float hi) {
  float near;
  return slab_entered(v3(b[i], b[stride + i], b[2 * stride + i]),
                      v3(b[3 * stride + i], b[4 * stride + i], b[5 * stride + i]), o, inv, lo, hi,
                      near);
}

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
