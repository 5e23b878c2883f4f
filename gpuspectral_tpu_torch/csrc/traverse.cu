// K7h: packet traversal of the implicit cluster tree, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/kernels.py:traverse_pallas (the pallas_call at
// kernels.py:269, body _traversal_kernel :58, triangle table _pack_tris :37).
// Wrapper: gpuspectral_tpu_torch/bvh/kernels.py (traverse_closest,
// traverse_any).  Plain version: bvh/traverse.py (intersect_closest_bvh_ref,
// intersect_any_bvh_ref), which the kernels equal bit for bit.
//
// The tree is bvh/build.py's: C clusters (a power of two) of leaf_size
// slots, node n's children 2n + 1 and 2n + 2, leaves from C - 1 on; leaf
// C - 1 + c holds the rows [c * leaf_size, (c + 1) * leaf_size) of the
// (C * leaf_size, 12) table of kernels.pack_tris, [v0, e1 = p1 - v0,
// e2 = p2 - v0, 0, 0, 0] (zero rows, which never hit, past the scene's
// triangles).  K7h reads the boxes from kernels.pack_nodes' (2C - 1, 8) rows
// [min.xyz, empty, max.xyz, 0], two 16-byte loads a node: `empty` marks a
// subtree whose box is inverted (an empty padding cluster, or a node over
// such clusters only), and pack_nodes has checked that its rows are all zero.
//
// The rule: K7h enters the leaves the plain version enters, in its order,
// less those under a marked subtree.  The plain version's packet enters a
// node when any of its rays passes the slab test on [t_min, best] (no slab
// widening: a ray may find its hit in a leaf that only another ray's vote
// let the packet in), visits the left subtree first and tests every row of
// an entered leaf for every ray of the packet, so exact-t ties go to the
// lowest prim.  What K7h may change, and nothing else:
//   (a) it enters no marked subtree: its zero rows never hit, so no ray's
//       best, prim, u, v or occlusion changes there;
//   (b) a vote taken before it is due, with a larger best, only prunes:
//       best only falls and t_min is fixed (an occluded ray stops voting),
//       so an early "no" stays "no"; an early "yes" is voted again when the
//       node is reached;
//   (c) which threads, CTAs and SMs hold which rays of a packet.
// So no front-to-back order, no widened vote, no other packet size.
//
// The walk, uniform over the packet (every thread holds the same node):
//   * at an internal node the packet entered, each thread slab-tests its
//     rays against both children's boxes and, where the children are
//     internal, the four grandchildren's (a marked box is never voted for);
//     one reduction gives the packet every vote.  Between a node's vote and
//     the plain version's votes on its left-first descendants no leaf is
//     tested until the packet enters one, so those votes are exact: the
//     packet descends to the first grandchild, left first, that passes
//     under a child that passes (or, where the children are leaves, to the
//     first child that passes).  The later ones that passed are remembered,
//     hints by (b): a grandchild's right sibling, and the right child only
//     if one of its own children passed.  Two levels a reduction halve the
//     reductions of a descent.
//   * a remembered node, reached again after the left subtree, is voted
//     again on its own box in the same reduction as its descendants' votes.
//   * an entered leaf: every ray with a non-empty window (t_min, best) tests
//     its rows in slot order with a strict `<` against its running best (the
//     plain version's argmin over the leaf, then `t_new < best` across
//     leaves).  The rows were staged in shared memory by the reduction that
//     voted on the leaf (two children's or four grandchildren's leaves): a
//     leaf is tested either right after that reduction or, a remembered
//     leaf, right after its own vote, with no staging between.  Two staging
//     buffers in turn, so a buffer is rewritten only after a later barrier.
//     An entered leaf costs no barrier of its own.
//   * the remembered right children are one bit per level of the tree
//     (`pending`): the deepest set bit is the next to visit, the right
//     sibling of the current node's ancestor at that level.  No stack
//     memory, nothing to fence.
//   any hit: an occluded ray stops voting and testing, a ray stops at its
//     first hit in (t_min, t_max), and the packet stops at the first
//     reduction that finds every ray of it, padding included, occluded.
// A reduction: each warp ORs its threads' vote bits (__reduce_or_sync) and
// stores them in its warp's slot (in a cluster: lane r stores into CTA r's
// copy of the slots, through distributed shared memory), then one barrier
// (__syncthreads, or the cluster barrier); then lane i of every warp reads
// slot i and the warp ORs them again.  No atomics; two rows of slots in
// turn, so a row is rewritten only after the next barrier.
//
// Launch shape: a thread block cluster of kClusterCtas = 8 CTAs on
// neighbouring SMs per packet of `packet` consecutive rays (the ragged last
// packet padded with rays that never hit, as traverse._packets pads it),
// each CTA holding an eighth of the packet's rays; packets under 32 rays a
// CTA take one CTA.  A CTA has T = min(its rays / kRaysPerThread rounded up
// to a warp, 1024 / kClusterCtas) threads, so the cluster's warps fit the 32
// slots of a reduction, each holding kPer = 1 or 2 rays (ray j of the CTA
// on thread j % T), their state in registers.  At the CLI's packets of
// 1,024, a 65,536-ray batch is 64 clusters of 8 x 128 threads: 512 CTAs for
// 132 SMs, where one CTA of 1,024 threads a packet gave 64.
// tools/torch_traverse_variants.py builds this file at the other shapes
// (one CTA of 1,024 or 512 threads, clusters of 2 or 4) and with the merged
// votes or the leaf staging switched off, and times them.
//
// What bounds it on the H100: operations (the tests a packet's walk needs,
// kernels.traverse_tests with skip_empty; every ray of a packet tests every
// entered leaf, ~55 instructions a Moller-Trumbore test) and the walk's
// serial chain: one reduction per two levels descended and per remembered
// node, each behind the load of the boxes it votes on and a cluster
// barrier (~1 us more a round than a CTA barrier).  The cluster spreads a
// packet's leaf tests over 8 SMs; one CTA of 1,024 threads a packet cannot
// hold the grandchildren's boxes in its 64 registers a thread and spills.
// Two ways around the barrier lost
// (tools/torch_traverse_variants.py, PERF.md): loading the next round's
// boxes inside a split cluster barrier (registers), and posting the votes
// into every CTA's slots with release stores and polling them in place of
// the barrier (the polling warps take issue slots from the leaf tests).  No
// wgmma or TMA: the tests are scalar float32.
//
// Precision: built with --fmad=false like the other kernels.  fmaf stands
// exactly where ops/intersect.py:_mt_edges calls m3.fma (math3d.cross_fma,
// dot_fma); f = 1 / a and the inverse direction are IEEE divisions; every
// other operation rounds on its own.  The slab test keeps torch's NaN rule:
// torch.minimum / amax propagate NaN, so a NaN among the six slab distances
// fails the test, and the inverse direction of a NaN component stays NaN
// (math3d.safe_div's clamp propagates it, where fmaxf in common.cuh:inv_dir
// drops it).  So a packet with NaN rays enters the nodes the plain version
// enters, and t, prim, u, v and occ equal it bit for bit.
//
// gst_traverse_count keeps PR 8's walk (a vote per node popped from a
// stack, on the (2C - 1, 3) min / max tables, marked or not) with each
// ray's slab and Moller-Trumbore tests counted: kernels.traverse_tests, the
// count K7h's bound is taken from.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// The launch shape and walk (tools/torch_traverse_variants.py rewrites these).
constexpr int kClusterCtas = 8;       // CTAs of a cluster holding one packet: 1 to 8
constexpr int kRaysPerThread = 1;     // rays a thread holds (2 where a packet needs them)
constexpr bool kMergedVotes = true;   // children's and grandchildren's votes in one reduction
constexpr bool kStageLeaves = true;   // leaf rows staged by the reduction that votes on them

constexpr int kMaxThreads = 1024;
constexpr int kMaxStack = 64;  // the counting walk's right children pending: at most log2(C)
constexpr int kMaxPacket = 2 * kMaxThreads;
constexpr int kMaxLevels = 31;  // log2(C) + 1: `pending` has a bit per level

// vote bits of a reduction
constexpr unsigned kSelf = 1u;   // the node reached again passes
constexpr unsigned kLeft = 2u;   // its left child passes
constexpr unsigned kRight = 4u;  // its right child passes
constexpr unsigned kLive = 8u;   // any hit: a ray of the packet is not occluded
constexpr unsigned kGrand = 16u;  // kGrand << i: grandchild i (heap 4h + i) passes

struct Ray {
  gst::V3 o, d, inv;
  float lo, best, u, v;
  int prim;
  bool occ;
  int boxes, tests;  // the tests made, kept by the counting walk only
};

// The plain version's node test (bvh/traverse.py:_ray_aabb and node_hit):
// t_enter = max of the per-axis min, t_exit = min of the per-axis max,
// (t_exit >= t_enter) & (t_exit >= t_min) & (t_enter <= best).  A NaN slab
// distance makes t_enter and t_exit NaN, and every comparison false.
__device__ __forceinline__ bool slab_hit(float lx, float ly, float lz, float hx, float hy,
                                         float hz, const Ray& r) {
  const float t0x = (lx - r.o.x) * r.inv.x;
  const float t0y = (ly - r.o.y) * r.inv.y;
  const float t0z = (lz - r.o.z) * r.inv.z;
  const float t1x = (hx - r.o.x) * r.inv.x;
  const float t1y = (hy - r.o.y) * r.inv.y;
  const float t1z = (hz - r.o.z) * r.inv.z;
  const float t_enter = gst::max_nan(gst::max_nan(gst::min_nan(t0x, t1x), gst::min_nan(t0y, t1y)),
                                     gst::min_nan(t0z, t1z));
  const float t_exit = gst::min_nan(gst::min_nan(gst::max_nan(t0x, t1x), gst::max_nan(t0y, t1y)),
                                    gst::max_nan(t0z, t1z));
  return (t_exit >= t_enter) && (t_exit >= r.lo) && (t_enter <= r.best);
}

// A node of pack_nodes' table: lo = (min.xyz, empty), hi = (max.xyz, 0).
struct Box {
  float4 lo, hi;
};

__device__ __forceinline__ Box load_box(const float4* __restrict__ nodes, unsigned heap) {
  return {__ldg(nodes + 2 * (heap - 1)), __ldg(nodes + 2 * (heap - 1) + 1)};
}

__device__ __forceinline__ bool box_hit(const Box& b, const Ray& r) {
  return slab_hit(b.lo.x, b.lo.y, b.lo.z, b.hi.x, b.hi.y, b.hi.z, r);
}

// One Moller-Trumbore test (ops/intersect.py:_mt_edges, op for op) of ray r
// against packed row w on (r.lo, hi).
__device__ __forceinline__ bool mt_test(const float* w, const Ray& r, float hi, float& t_out,
                                        float& u_out, float& v_out) {
  const float v0x = w[0], v0y = w[1], v0z = w[2];
  const float e1x = w[3], e1y = w[4], e1z = w[5];
  const float e2x = w[6], e2y = w[7], e2z = w[8];
  const gst::V3 d = r.d;
  const float hx = fmaf(d.y, e2z, -(d.z * e2y));  // h = cross_fma(d, e2)
  const float hy = fmaf(d.z, e2x, -(d.x * e2z));
  const float hz = fmaf(d.x, e2y, -(d.y * e2x));
  const float a = fmaf(e1z, hz, fmaf(e1y, hy, e1x * hx));  // dot_fma(e1, h)
  const bool parallel = fabsf(a) < 1e-12f;
  const float f = 1.0f / (parallel ? 1.0f : a);
  const float sx = r.o.x - v0x, sy = r.o.y - v0y, sz = r.o.z - v0z;
  const float u = f * fmaf(sz, hz, fmaf(sy, hy, sx * hx));
  const float qx = fmaf(sy, e1z, -(sz * e1y));  // q = cross_fma(s, e1)
  const float qy = fmaf(sz, e1x, -(sx * e1z));
  const float qz = fmaf(sx, e1y, -(sy * e1x));
  const float v = f * fmaf(d.z, qz, fmaf(d.y, qy, d.x * qx));
  const float t = f * fmaf(e2z, qz, fmaf(e2y, qy, e2x * qx));
  t_out = t;
  u_out = u;
  v_out = v;
  return !parallel && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > r.lo) && (t < hi);
}

// Ray j of a packet starting at global ray `first`: its state, or with
// `in_packet` false a thread slot past the packet (no ray, never holds the
// packet back).  Rays past n_rays pad the last packet: o = 0, d = 1,
// t_min = 0, t_max = -1e30, which never hit.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        const float* __restrict__ t_min,
                                        const float* __restrict__ t_max, long long i,
                                        bool in_packet, int n_rays) {
  const bool live = in_packet && i < n_rays;
  Ray r;
  r.o = live ? gst::V3{origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]}
             : gst::V3{0.0f, 0.0f, 0.0f};
  r.d = live ? gst::V3{direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]}
             : gst::V3{1.0f, 1.0f, 1.0f};
  r.inv = {gst::inv_dir_nan(r.d.x), gst::inv_dir_nan(r.d.y), gst::inv_dir_nan(r.d.z)};
  r.lo = live ? t_min[i] : 0.0f;
  const float hi = live ? t_max[i] : -gst::kBig;
  r.best = hi > r.lo ? hi : -gst::kBig;  // the ray's search window (lo, best)
  r.u = 0.0f;
  r.v = 0.0f;
  r.prim = -1;
  r.occ = !in_packet;
  r.boxes = 0;
  r.tests = 0;
  return r;
}

template <bool kAny>
__device__ __forceinline__ void store_ray(const Ray& r, long long i, float* __restrict__ t_out,
                                          int* __restrict__ prim_out, float* __restrict__ u_out,
                                          float* __restrict__ v_out, bool* __restrict__ occ_out) {
  if (kAny) {
    occ_out[i] = r.occ;
  } else {
    const float t = r.prim >= 0 ? r.best : gst::kBig;
    t_out[i] = t;
    prim_out[i] = t < gst::kBig ? r.prim : -1;
    u_out[i] = r.u;
    v_out[i] = r.v;
  }
}

// Leaf `cluster`'s rows (in global or shared memory) against ray r, in slot
// order (the caller has checked that the ray is not occluded and its window
// is not empty).
template <bool kAny, bool kCount>
__device__ __forceinline__ void test_leaf(const float* __restrict__ rows, int cluster,
                                          int leaf_size, Ray& r) {
  for (int s = 0; s < leaf_size; ++s) {
    const float4* row = reinterpret_cast<const float4*>(rows + 12 * s);
    const float4 p = row[0], q = row[1];
    const float w[9] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, rows[12 * s + 8]};
    float t, u, v;
    if (kCount) ++r.tests;
    if (mt_test(w, r, r.best, t, u, v)) {
      if (kAny) {
        r.occ = true;
        return;
      }
      r.best = t;
      r.u = u;
      r.v = v;
      r.prim = cluster * leaf_size + s;
    }
  }
}

// The packet's OR of `bits` (see the header): warp OR into the warp's slot
// of row `row` (in every CTA of the cluster, at this CTA's rank: lane r
// stores into CTA r), one barrier, then the OR of the slots.
template <int kG>
__device__ __forceinline__ unsigned packet_or(unsigned bits, unsigned (*slots)[32], int rank,
                                              int& row) {
  bits = __reduce_or_sync(0xffffffffu, bits);
  const unsigned lane = threadIdx.x & 31u, warps = blockDim.x >> 5;
  const unsigned slot = rank * warps + (threadIdx.x >> 5);
  if constexpr (kG == 1) {
    if (lane == 0) slots[row][slot] = bits;
    __syncthreads();
  } else {
    if (lane < (unsigned)kG) cg::this_cluster().map_shared_rank(slots[row], lane)[slot] = bits;
    cg::this_cluster().sync();
  }
  const unsigned out = lane < kG * warps ? slots[row][lane] : 0u;
  row ^= 1;
  return __reduce_or_sync(0xffffffffu, out);
}

// Rows [0, n) of float4 from src to dst, by the CTA's threads.
__device__ __forceinline__ void stage(float4* dst, const float4* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// K7h: one packet per CTA (kG = 1) or per cluster of kG CTAs, each CTA
// holding cta_rays of its rays, kPer a thread.
template <int kPer, int kG, bool kAny>
__global__ void __launch_bounds__(kMaxThreads / kG)
packet_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
              const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
              int packet, int cta_rays, const float4* __restrict__ nodes,
              const float* __restrict__ tris, int n_clusters, int leaf_size, bool stage_rows,
              float* __restrict__ t_out, int* __restrict__ prim_out, float* __restrict__ u_out,
              float* __restrict__ v_out, bool* __restrict__ occ_out) {
  __shared__ unsigned slots[2][32];    // the reductions' warp slots, two rows in turn
  extern __shared__ float4 staged[];  // 2 buffers x 4 leaves x leaf_size x 12 floats
  int rank = 0;
  if constexpr (kG > 1) rank = (int)cg::this_cluster().block_rank();
  const int first = rank * cta_rays;  // this CTA's first ray in the packet
  const int mine = min(cta_rays, packet - first);
  const long long base = (long long)(blockIdx.x / kG) * packet + first;
  Ray ray[kPer];
  bool in_packet[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * blockDim.x + threadIdx.x;
    in_packet[k] = j < mine;
    ray[k] = load_ray(origin, direction, t_min, t_max, base + j, in_packet[k], n_rays);
  }
  if constexpr (kG > 1) cg::this_cluster().sync();  // every CTA of the cluster has started

  const unsigned first_leaf = (unsigned)n_clusters;  // heap index of leaf 0
  unsigned heap = 1;      // the current node, heap-numbered: children 2h and 2h + 1
  int depth = 0;          // its level; the root's is 0
  unsigned pending = 0;   // bit l: the right child at level l is remembered
  bool vote_self = true;  // the current node is voted on (the root, a remembered node)
  int row = 0;            // the reduction's row of slots
  int buffer = 1;         // the staging buffer of the last leaves staged
  unsigned staged_first = 0;  // and the heap index of the first of them
  const int leaf_vec = leaf_size * 3;  // float4 of a leaf's rows
  // an empty tree: the root is marked, and nothing can hit
  bool walking = __ldg(nodes).w == 0.0f;
  while (walking) {
    const bool internal = heap < first_leaf;
    bool entered = true;
    if (internal || vote_self) {
      Box self{}, left{}, right{}, grand[4];
      if (vote_self) self = load_box(nodes, heap);
      bool left_open = false, right_open = false;  // not marked empty
      if (internal) {
        left = load_box(nodes, 2 * heap);
        right = load_box(nodes, 2 * heap + 1);
        left_open = left.lo.w == 0.0f;
        right_open = right.lo.w == 0.0f;
      }
      // two levels a reduction where the children are internal
      const bool two = kMergedVotes && internal && 2 * heap < first_leaf;
      if (two) {
#pragma unroll
        for (int i = 0; i < 4; ++i) grand[i] = load_box(nodes, 4 * heap + i);
      }
      // the leaves the packet may test before its next reduction
      const unsigned stage_first = two ? 4 * heap : 2 * heap;
      if (kStageLeaves && stage_rows && internal && stage_first >= first_leaf) {
        buffer ^= 1;
        staged_first = stage_first;
        stage(staged + 4 * buffer * leaf_vec,
              reinterpret_cast<const float4*>(tris) + (size_t)(stage_first - first_leaf) * leaf_vec,
              (two ? 4 : 2) * leaf_vec);
      }
      unsigned bits = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const Ray& r = ray[k];
        if (!in_packet[k] || (kAny && r.occ)) continue;
        if (kAny) bits |= kLive;
        if (vote_self && box_hit(self, r)) bits |= kSelf;
        if (kMergedVotes && left_open && box_hit(left, r)) bits |= kLeft;
        if (kMergedVotes && right_open && box_hit(right, r)) bits |= kRight;
        if (two) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (grand[i].lo.w == 0.0f && box_hit(grand[i], r)) bits |= kGrand << i;
          }
        }
      }
      bits = packet_or<kG>(bits, slots, rank, row);
      if (kAny && !(bits & kLive)) break;  // every ray of the packet is occluded
      if (vote_self && !(bits & kSelf)) {
        entered = false;
      } else if (two) {
        // the first grandchild, left first, under a child that passes: its
        // vote and its parent's are exact (no leaf test lies between them
        // and the plain version's); a later one is remembered as a hint, a
        // right child only if one of its children passed
        const bool l = (bits & kLeft) != 0, r = (bits & kRight) != 0;
        const bool a0 = l && (bits & kGrand), a1 = l && (bits & (kGrand << 1));
        const bool a2 = r && (bits & (kGrand << 2)), a3 = r && (bits & (kGrand << 3));
        const bool keep_right = a2 || a3;
        vote_self = false;
        if (a0 || a1 || a2 || a3) {
          if (a0 || a1) {
            if (keep_right) pending |= 1u << (depth + 1);
            if (a0 && a1) pending |= 1u << (depth + 2);
            heap = 4 * heap + (a0 ? 0 : 1);
          } else {
            if (a2 && a3) pending |= 1u << (depth + 2);
            heap = 4 * heap + (a2 ? 2 : 3);
          }
          depth += 2;
          continue;
        }
        entered = false;
      } else if (internal) {
        // without merged votes a child is voted on when reached
        const bool go_left = kMergedVotes ? (bits & kLeft) != 0 : left_open;
        const bool go_right = kMergedVotes ? (bits & kRight) != 0 : right_open;
        vote_self = !kMergedVotes;
        if (go_left) {
          if (go_right) pending |= 1u << (depth + 1);
          heap = 2 * heap;
          ++depth;
          continue;
        }
        if (go_right) {
          heap = 2 * heap + 1;
          ++depth;
          continue;
        }
        entered = false;
      }
    }
    if (entered) {  // a leaf
      const int cluster = (int)(heap - first_leaf);
      // staged by the reduction that voted on the leaf (the root has none)
      const float* rows =
          kStageLeaves && stage_rows && heap > 1
              ? reinterpret_cast<const float*>(staged +
                                               (4 * buffer + (heap - staged_first)) * leaf_vec)
              : tris + (size_t)cluster * leaf_size * 12;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        Ray& r = ray[k];
        // an empty window (lo, best) holds no hit: such a ray tests nothing
        if (in_packet[k] && !(kAny && r.occ) && r.best > r.lo) {
          test_leaf<kAny, false>(rows, cluster, leaf_size, r);
        }
      }
    }
    if (pending == 0) break;
    const int l = 31 - __clz(pending);  // the deepest remembered right child
    pending &= ~(1u << l);
    heap = (heap >> (depth - l)) | 1u;  // the right sibling of the ancestor at level l
    depth = l;
    vote_self = true;
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + k * blockDim.x + threadIdx.x;
    if (in_packet[k] && i < n_rays) store_ray<kAny>(ray[k], i, t_out, prim_out, u_out, v_out,
                                                   occ_out);
  }
}

// PR 8's walk with each ray's slab and Moller-Trumbore tests counted
// (kernels.traverse_tests): one CTA per packet, a vote by __syncthreads_or
// at every node popped from a shared stack, on the (2C - 1, 3) min / max
// tables, an entered leaf's rows staged in shared memory.  A push is always
// followed by the vote on the left child, whose barrier fences it; the
// vote's barrier also keeps the previous leaf's readers ahead of the next
// staging.
template <int kPer, bool kAny>
__global__ void __launch_bounds__(kMaxThreads)
count_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
             const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
             int packet, const float* __restrict__ node_min, const float* __restrict__ node_max,
             const float* __restrict__ tris, int n_clusters, int leaf_size,
             float* __restrict__ t_out, int* __restrict__ prim_out, float* __restrict__ u_out,
             float* __restrict__ v_out, bool* __restrict__ occ_out, int* __restrict__ boxes_out,
             int* __restrict__ tests_out) {
  extern __shared__ float4 leaf_rows[];  // leaf_size x 12 floats
  __shared__ int stack[kMaxStack];
  const int first_leaf = n_clusters - 1;
  const long long base = (long long)blockIdx.x * packet;
  Ray ray[kPer];
  bool in_packet[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * blockDim.x + threadIdx.x;
    in_packet[k] = j < packet;
    ray[k] = load_ray(origin, direction, t_min, t_max, base + j, in_packet[k], n_rays);
  }

  int node = 0, sp = 0;
  while (true) {
    const float* lo = node_min + 3 * (size_t)node;
    const float* hi = node_max + 3 * (size_t)node;
    bool vote = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (in_packet[k] && !(kAny && ray[k].occ)) {
        vote |= slab_hit(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], ray[k]);
        ++ray[k].boxes;
      }
    }
    if (__syncthreads_or(vote)) {
      if (node < first_leaf) {
        if (threadIdx.x == 0) stack[sp] = 2 * node + 2;
        ++sp;
        node = 2 * node + 1;
        continue;
      }
      const int cluster = node - first_leaf;
      const float4* src = reinterpret_cast<const float4*>(tris) + (size_t)cluster * leaf_size * 3;
      for (int e = threadIdx.x; e < leaf_size * 3; e += blockDim.x) leaf_rows[e] = src[e];
      __syncthreads();
      bool done = true;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        Ray& r = ray[k];
        if (in_packet[k] && !(kAny && r.occ) && r.best > r.lo) {
          test_leaf<kAny, true>(reinterpret_cast<const float*>(leaf_rows), cluster, leaf_size, r);
        }
        done = done && r.occ;
      }
      if (kAny && __syncthreads_and(done)) break;
    }
    if (sp == 0) break;
    node = stack[--sp];
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + k * blockDim.x + threadIdx.x;
    if (!in_packet[k] || i >= n_rays) continue;
    boxes_out[i] = ray[k].boxes;
    tests_out[i] = ray[k].tests;
    store_ray<kAny>(ray[k], i, t_out, prim_out, u_out, v_out, occ_out);
  }
}

// Launch `kernel` on grid x threads with `smem` bytes of dynamic shared
// memory, in clusters of `cluster` CTAs.
template <typename... Params, typename... Args>
int launch_kernel(void (*kernel)(Params...), long long grid, int threads, size_t smem,
                  int cluster, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {  // above the default: opt in
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (rc == cudaSuccess) rc = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

bool bad_tree(int n_rays, int packet, int n_clusters, int leaf_size) {
  return packet < 1 || packet > kMaxPacket || leaf_size < 1 || leaf_size > 1024 ||
         n_clusters < 1 ||
         (n_clusters & (n_clusters - 1)) != 0 || n_clusters > (1 << (kMaxLevels - 1)) ||
         n_rays < 0;
}

// K7h's launch shape for packets of `packet` rays (1 to kMaxPacket).
struct Shape {
  int ctas;     // CTAs a packet: a cluster only where each holds a warp of rays or more
  int rays;     // rays a CTA holds (the last CTA of a cluster may hold fewer)
  int threads;  // threads a CTA
  int per;      // rays a thread: 1 or 2
};

Shape packet_shape(int packet) {
  Shape s;
  s.ctas = packet >= 32 * kClusterCtas ? kClusterCtas : 1;
  s.rays = (packet + s.ctas - 1) / s.ctas;
  s.threads = min(kMaxThreads / s.ctas,  // the cluster's warps fill at most 32 slots
                  ((s.rays + kRaysPerThread - 1) / kRaysPerThread + 31) / 32 * 32);
  s.per = (s.rays + s.threads - 1) / s.threads;
  return s;
}

template <bool kAny>
int launch_packets(const float* origin, const float* direction, const float* t_min,
                   const float* t_max, int n_rays, int packet, const float* nodes,
                   const float* tris, int n_clusters, int leaf_size, float* t_out,
                   int* prim_out, float* u_out, float* v_out, bool* occ_out, void* stream) {
  if (bad_tree(n_rays, packet, n_clusters, leaf_size)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Shape sh = packet_shape(packet);
  const int g = sh.ctas, cta_rays = sh.rays, threads = sh.threads, per = sh.per;
  const long long grid = ((long long)n_rays + packet - 1) / packet * g;
  const float4* boxes = reinterpret_cast<const float4*>(nodes);
  // two buffers of four leaves' rows, where they fit (the 16-slot leaves of
  // bvh/build.py take 6 KB)
  const size_t staging = (size_t)8 * leaf_size * 12 * sizeof(float);
  const bool stage_rows = kStageLeaves && staging <= 200 * 1024;
  const size_t smem = stage_rows ? staging : 0;
#define GST_PACKETS(P, G)                                                                     \
  launch_kernel(packet_kernel<P, G, kAny>, grid, threads, smem, G, stream, origin, direction, \
                t_min, t_max, n_rays, packet, cta_rays, boxes, tris, n_clusters, leaf_size,  \
                stage_rows,                                                                  \
                t_out, prim_out, u_out, v_out, occ_out)
  if (g == 1) return per == 1 ? GST_PACKETS(1, 1) : GST_PACKETS(2, 1);
  if constexpr (kClusterCtas > 1) {
    return per == 1 ? GST_PACKETS(1, kClusterCtas) : GST_PACKETS(2, kClusterCtas);
  }
#undef GST_PACKETS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gst_traverse_closest(const float* origin, const float* direction,
                                    const float* t_min, const float* t_max, int n_rays,
                                    int packet, const float* nodes, const float* tris,
                                    int n_clusters, int leaf_size, float* t_out, int* prim_out,
                                    float* u_out, float* v_out, void* stream) {
  return launch_packets<false>(origin, direction, t_min, t_max, n_rays, packet, nodes, tris,
                               n_clusters, leaf_size, t_out, prim_out, u_out, v_out, nullptr,
                               stream);
}

extern "C" int gst_traverse_any(const float* origin, const float* direction, const float* t_min,
                                const float* t_max, int n_rays, int packet, const float* nodes,
                                const float* tris, int n_clusters, int leaf_size, bool* occ_out,
                                void* stream) {
  return launch_packets<true>(origin, direction, t_min, t_max, n_rays, packet, nodes, tris,
                              n_clusters, leaf_size, nullptr, nullptr, nullptr, nullptr, occ_out,
                              stream);
}

// K7h's launch shape at packets of `packet` rays: shape = {CTAs a packet
// (a thread block cluster if more than 1), threads a CTA, rays a thread}.
extern "C" int gst_traverse_shape(int packet, int* shape) {
  if (packet < 1 || packet > kMaxPacket) return (int)cudaErrorInvalidValue;
  const Shape sh = packet_shape(packet);
  shape[0] = sh.ctas;
  shape[1] = sh.threads;
  shape[2] = sh.per;
  return 0;
}

// PR 8's walk with each ray's slab and Moller-Trumbore tests counted
// (kernels.traverse_tests): the closest hit's outputs, or with any_hit occ.
extern "C" int gst_traverse_count(const float* origin, const float* direction,
                                  const float* t_min, const float* t_max, int n_rays, int packet,
                                  const float* node_min, const float* node_max,
                                  const float* tris, int n_clusters, int leaf_size, int any_hit,
                                  float* t_out, int* prim_out, float* u_out, float* v_out,
                                  bool* occ_out, int* boxes_out, int* tests_out, void* stream) {
  if (bad_tree(n_rays, packet, n_clusters, leaf_size)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int threads = min(kMaxThreads, (packet + 31) / 32 * 32);
  const int per = (packet + threads - 1) / threads;
  const long long grid = ((long long)n_rays + packet - 1) / packet;
  const size_t smem = (size_t)leaf_size * 12 * sizeof(float);
#define GST_COUNT(P, A)                                                                       \
  launch_kernel(count_kernel<P, A>, grid, threads, smem, 1, stream, origin, direction, t_min,  \
                t_max, n_rays, packet, node_min, node_max, tris, n_clusters, leaf_size,       \
                t_out, prim_out, u_out, v_out, occ_out, boxes_out, tests_out)
  if (any_hit) return per == 1 ? GST_COUNT(1, true) : GST_COUNT(2, true);
  return per == 1 ? GST_COUNT(1, false) : GST_COUNT(2, false);
#undef GST_COUNT
}
