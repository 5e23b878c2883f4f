// K7f / K7g: the block-gated depth-first walk, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/dfs_sweep.py: _make_closest_kernel (K7f,
// the pallas_call at dfs_sweep.py:427) and _make_any_kernel (K7g, :474).
// Wrapper: gpuspectral_tpu_torch/bvh/dfs_sweep.py (dfs_closest, dfs_any).
//
// The function.  Rays come in blocks of kBlock = 32 consecutive rays.  A
// block walks the scene's preorder tables from node 0: bounds (6, N) float
// (lo xyz, hi xyz) and meta (2, N) int (the skip pointer past the node's
// subtree; a leaf's first slot, -1 for an internal node).  It enters a node
// (ptr + 1) when some ray's plain slab test of the node's box passes on the
// ray's segment [t_min, horizon], and jumps the subtree (ptr = skip) when
// none does.  At an entered leaf each ray takes its hits among the leaf's
// kSweep = 128 slots [off, off + min(128, n_slots - off)).
//   K7f  the closest hit with t in (0, best), best the closest t so far and
//        the ray's horizon, the lowest slot winning among exactly tied t.
//        Each lane writes t, prim, u, v and its winning slot's A attribute
//        floats.
//   K7g  whether a hit lies in (t_min, t_max); an occluded ray's horizon
//        falls to -1e30, so it stops voting.
// A hit in a subtree that no ray of the block voted for is lost, as on the
// TPU; dfs_sweep.dfs_closest_ref / dfs_any_ref compute the same function.
//
// The design.  One warp is one block, one lane a ray, the ray's state in
// registers; kWarps warps a CTA, each walking on its own: no shared memory
// and no CTA barrier.
//   * The node vote is __any_sync over the lanes' slab tests, taken as the
//     plain walk takes them, with torch's NaN rule (common.cuh:slab_nan on
//     inv_dir_nan): a lane with a NaN origin, direction or segment end votes
//     for nothing.  Padding lanes past the last ray (t_max -1e30) and
//     inactive lanes take part in every vote and never vote or hit; a warp
//     wholly past the last ray exits at once.
//   * At an entered leaf nothing is staged.  Its slots are split into the
//     leaf clusters of leaf_size slots they belong to (their boxes the rows
//     of the node tables from the first leaf cluster on, as K7d reads them;
//     an empty cluster's box is inverted).  A lane tests a cluster's slots
//     only where its own widened slab test (bvh.cuh:slab_entered) enters the
//     cluster's box, on (0, best) for K7f and on (t_min, t_max) for K7g,
//     and the warp skips a cluster no lane enters.  The Woop rows are read
//     from the (T, 12) table as three float4 __ldg a slot (all lanes the
//     same slot: one L1 line), in slot order, with a strict `<` against
//     best, the loop unrolled by kUnroll.
//   * K7g: a warp whose lanes all have an empty segment never walks, a lane
//     stops at its first occluder, and the warp ends once every lane is
//     occluded or empty (__any_sync), which cannot change the result.
//
// Why the gate changes no result.  A lane whose widened slab test misses a
// cluster's box holds no Woop hit inside it with t in the lane's segment
// (csrc/bvh.cuh, header: K3 equals the brute scan bit for bit that way),
// and an empty cluster or a slot past the last cluster is a zero row, which
// never hits (the wrapper checks both).  K7f's skipped slots could only
// give t >= best, which a strict `<` never takes, so best after a leaf, and
// with it every later vote, is the plain walk's.  The node walk itself is
// the plain walk's, node for node.
//
// What bounds it on the H100: the walk's chain of dependent steps.  A node
// visit is a load of its box, a slab test and a vote before the next
// pointer is known, so a warp's time is its node visits times that
// latency, plus the Woop tests of the clusters its lanes enter (~40
// instructions each).  The block's votes still set the nodes it visits (a
// block of incoherent rays enters the union of its rays' leaves), but in
// an entered leaf a lane tests only the clusters its own ray enters, where
// the design before this one Woop-tested all 128 slots for every ray of
// the block, after staging them in shared memory behind two CTA barriers
// a node.
//
// Precision: built with --fmad=false like the other kernels.  The vote is
// plain subtracts, multiplies, min / max and an IEEE division for the
// inverse direction (math3d.safe_div(1, d)), as the plain torch walk
// computes them, so the votes are equal.  The Woop test is
// csrc/common.cuh:woop_eval, whose fmaf calls sit where ops/woop.py calls
// m3.fma.  So t, prim, u and v equal the plain walk bit for bit.
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

constexpr int kBlock = 32;  // rays a warp = dfs_sweep.BLOCK
constexpr int kSweep = 128;  // slots of a leaf = dfs_sweep.SWEEP
constexpr unsigned kAll = 0xffffffffu;
// Warps a CTA and the Woop loop's unroll;
// tools/torch_dfs_variants.py builds copies with other values.
constexpr int kWarps = 4;
constexpr int kUnroll = gst::kWoopUnroll;

// The tables of one walk: the preorder node tables, the leaf clusters'
// boxes ((n_clusters, 3) rows of the node_min / node_max tables) and the
// (n_slots, 12) Woop rows.
struct Tree {
  const float* bounds;
  const int* meta;
  int n_nodes;
  const float *cmin, *cmax;
  int n_clusters, leaf_size;
  const float4* woop;
  int n_slots;
};

struct Node {
  gst::V3 lo, hi;
  int skip, leaf;
};

__device__ __forceinline__ Node node(const Tree& T, int i) {
  const float* b = T.bounds;
  const int n = T.n_nodes;
  return {gst::v3(__ldg(b + i), __ldg(b + n + i), __ldg(b + 2 * n + i)),
          gst::v3(__ldg(b + 3 * n + i), __ldg(b + 4 * n + i), __ldg(b + 5 * n + i)),
          __ldg(T.meta + i), __ldg(T.meta + n + i)};
}

// The warp's vote on node x: whether some lane's plain slab test passes on
// its segment [lo, hi].
__device__ __forceinline__ bool voted(const Node& x, gst::V3 o, gst::V3 inv, float lo,
                                      float hi) {
  return __any_sync(kAll, gst::slab_nan(x.lo, x.hi, o, inv, lo, hi));
}

// Whether the lane's widened slab test enters leaf cluster c on [lo, hi];
// an empty cluster (inverted box, zero rows) is never entered: the slab
// test alone would pass every ray through its +inf / -inf bounds.
__device__ __forceinline__ bool cluster_entered(const Tree& T, int c, gst::V3 o, gst::V3 inv,
                                                float lo, float hi) {
  const gst::V3 bl = gst::v3(__ldg(T.cmin + 3 * c), __ldg(T.cmin + 3 * c + 1),
                             __ldg(T.cmin + 3 * c + 2));
  const gst::V3 bh = gst::v3(__ldg(T.cmax + 3 * c), __ldg(T.cmax + 3 * c + 1),
                             __ldg(T.cmax + 3 * c + 2));
  float near;
  return !(bl.x > bh.x) && gst::slab_entered(bl, bh, o, inv, lo, hi, near);
}

// The slots a lane Woop-tests in the leaf whose first slot is `off`, while
// it searches (`go`): those of each of the leaf's clusters that the lane's
// own test enters, clusters some lane of the warp enters only.
// `visit(slot, test)` runs for each slot in order, `test` whether this lane
// tests it, and returns whether the lane goes on searching (false after an
// any hit's occluder).  With kStops the warp leaves a cluster, and the
// leaf, once no lane goes on in it.
template <bool kStops, class Visit>
__device__ __forceinline__ void sweep_leaf(const Tree& T, int off, bool go, gst::V3 o,
                                           gst::V3 inv, float lo, const float& hi,
                                           Visit&& visit) {
  const int end = off + min(kSweep, T.n_slots - off);
  const int c1 = min((end + T.leaf_size - 1) / T.leaf_size, T.n_clusters);
  for (int c = off / T.leaf_size; c < c1 && __any_sync(kAll, go); ++c) {
    bool cin = go && cluster_entered(T, c, o, inv, lo, hi);
    if (!__any_sync(kAll, cin)) continue;
    const int e = min((c + 1) * T.leaf_size, end);
#pragma unroll(kUnroll)
    for (int slot = c * T.leaf_size; slot < e; ++slot) {
      go = visit(slot, cin) && go;
      cin = cin && go;
      if (kStops && !__any_sync(kAll, cin)) break;
    }
  }
}

__global__ void __launch_bounds__(kBlock * kWarps)
dfs_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ t_max, int n_rays, Tree T,
                   const float* __restrict__ attr, int n_attr, float* __restrict__ t_out,
                   int* __restrict__ prim_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, float* __restrict__ attr_out) {
  const int lane = threadIdx.x % kBlock;
  const int r0 = (blockIdx.x * kWarps + threadIdx.x / kBlock) * kBlock;  // the warp's first ray
  if (r0 >= n_rays) return;  // a whole warp past the last ray
  const int r = r0 + lane;
  const bool live = r < n_rays;  // padding rays: o 0, d 1, t_max -1e30
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = gst::v3(gst::inv_dir_nan(d.x), gst::inv_dir_nan(d.y), gst::inv_dir_nan(d.z));
  float best = live ? t_max[r] : -gst::kBig;  // also the voting horizon
  const bool act = best > 0.0f;  // t must lie in (0, best): else never hits
  float best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  int ptr = 0;
  while (ptr < T.n_nodes) {
    const Node x = node(T, ptr);
    if (!voted(x, o, inv, 0.0f, best)) {
      ptr = x.skip;  // the same for every lane of the warp
      continue;
    }
    ++ptr;
    if (x.leaf < 0) continue;
    sweep_leaf<false>(T, x.leaf, act, o, inv, 0.0f, best, [&](int slot, bool test) {
      float t, u, v;
      // strict `<` against best (woop_eval's t < t_hi), slots in order:
      // the lowest slot wins among exactly tied t
      if (gst::woop_row(T.woop + 3 * slot, o, d, 0.0f, best, t, u, v) && test) {
        best = t;
        best_u = u;
        best_v = v;
        best_prim = slot;
      }
      return true;
    });
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

__global__ void __launch_bounds__(kBlock * kWarps)
dfs_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
               const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
               Tree T, bool* __restrict__ occ_out) {
  const int lane = threadIdx.x % kBlock;
  const int r0 = (blockIdx.x * kWarps + threadIdx.x / kBlock) * kBlock;
  if (r0 >= n_rays) return;
  const int r = r0 + lane;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = gst::v3(gst::inv_dir_nan(d.x), gst::inv_dir_nan(d.y), gst::inv_dir_nan(d.z));
  const float lo = live ? t_min[r] : 0.0f;
  const float hi = live ? t_max[r] : -gst::kBig;
  bool todo = hi > lo;  // no t lies in an empty (lo, hi): never occluded
  bool occ = false;
  float horizon = hi;  // an empty segment may still vote, as in the plain walk
  int ptr = __any_sync(kAll, todo) ? 0 : T.n_nodes;
  while (ptr < T.n_nodes) {
    const Node x = node(T, ptr);
    if (!voted(x, o, inv, lo, horizon)) {
      ptr = x.skip;
      continue;
    }
    ++ptr;
    if (x.leaf < 0) continue;
    sweep_leaf<true>(T, x.leaf, todo, o, inv, lo, hi, [&](int slot, bool test) {
      float t, u, v;
      if (gst::woop_row(T.woop + 3 * slot, o, d, lo, hi, t, u, v) && test) {
        occ = true;  // the lane's first occluder: it stops, and stops voting
        todo = false;
        horizon = -gst::kBig;
      }
      return todo;
    });
    if (!__any_sync(kAll, todo)) break;
  }
  if (live) occ_out[r] = occ;
}

// A launch of K7f / K7g: one warp a block of kBlock rays, kWarps warps a CTA.
int ctas_for(int n_rays) {
  const int warps = (n_rays + kBlock - 1) / kBlock;
  return (warps + kWarps - 1) / kWarps;
}

Tree tree(const float* bounds, const int* meta, int n_nodes, const float* cmin,
          const float* cmax, int n_clusters, int leaf_size, const float* woop, int n_slots) {
  return Tree{bounds, meta, n_nodes, cmin, cmax, n_clusters, leaf_size,
              reinterpret_cast<const float4*>(woop), n_slots};
}

}  // namespace

// cmin / cmax: the first leaf cluster's row of the (2C - 1, 3) node tables;
// woop: the (n_slots, 12) Woop rows, 16-byte aligned.
extern "C" int gst_dfs_closest(const float* origin, const float* direction, const float* t_max,
                               int n_rays, const float* bounds, const int* meta, int n_nodes,
                               const float* cmin, const float* cmax, int n_clusters,
                               int leaf_size, const float* woop, int n_slots, const float* attr,
                               int n_attr, float* t_out, int* prim_out, float* u_out,
                               float* v_out, float* attr_out, void* stream) {
  if (n_rays == 0) return 0;
  dfs_closest_kernel<<<ctas_for(n_rays), kBlock * kWarps, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays,
      tree(bounds, meta, n_nodes, cmin, cmax, n_clusters, leaf_size, woop, n_slots), attr,
      n_attr, t_out, prim_out, u_out, v_out, attr_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_dfs_any(const float* origin, const float* direction, const float* t_min,
                           const float* t_max, int n_rays, const float* bounds, const int* meta,
                           int n_nodes, const float* cmin, const float* cmax, int n_clusters,
                           int leaf_size, const float* woop, int n_slots, bool* occ_out,
                           void* stream) {
  if (n_rays == 0) return 0;
  dfs_any_kernel<<<ctas_for(n_rays), kBlock * kWarps, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays,
      tree(bounds, meta, n_nodes, cmin, cmax, n_clusters, leaf_size, woop, n_slots), occ_out);
  return (int)cudaGetLastError();
}
