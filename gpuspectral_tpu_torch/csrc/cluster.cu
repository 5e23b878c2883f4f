// K7c / K7d / K7e: the cluster sweep, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/cluster_sweep.py: _votes_kernel (K7c, the
// pallas_call at cluster_sweep.py:316), _sweep_closest_kernel (K7d, :369)
// and _sweep_any_kernel (K7e, :418).  Wrapper:
// gpuspectral_tpu_torch/bvh/cluster_sweep.py (cluster_votes,
// cluster_closest, cluster_any), which also holds the supernode tables.
//
// A supernode is a run of `stride` consecutive triangle slots (K leaf
// clusters of leaf_size slots, in Morton order) with one box; rays come in
// blocks of kBlock = 256 consecutive rays, and the votes gate the sweep
// per (block, supernode).
//
//   K7c  one vote per (block, supernode): 1 where some ray of the block
//        passes the plain slab test (common.cuh:slab_nan) of the
//        supernode's box on its own segment [t_min, t_max].  The design is
//        below ("K7c").
//   K7d  one warp a 32 consecutive rays (one lane a ray), kWarps warps a
//        CTA, each warp on its own: no shared memory and no CTA barrier.
//        The warp reads its block's votes 32 at a time (a ballot) and,
//        for each voted supernode in order, each lane runs the widened slab
//        test of csrc/bvh.cuh (slab_entered, kSlabMargin) on its own
//        segment (0, best); the warp skips the supernode when no lane
//        enters it.  The same two-level gate then runs on the supernode's
//        leaf clusters (their boxes from the BVH's node tables; an empty
//        cluster's inverted box is never entered), and only the slots of
//        entered clusters are tested.  A lane whose own test failed takes
//        no hit there.  The Woop rows are read as 3 float4 __ldg a slot (all
//        lanes the same slot: one L1 line), in slot order, with a strict `<`
//        against best, so the lowest slot wins among exactly tied t (as K3
//        and the plain scan).  At the end each lane writes t, prim, u, v
//        and its winning slot's A attribute floats.
//   K7e  the same sweep for occlusion in (t_min, t_max): a lane stops at
//        its first occluder or at once on an empty segment, and the warp
//        stops when no lane is left (__any_sync).
// Lanes of inactive rays (t_max = -1e30) and of padding rays past the last
// ray vote nothing and hit nothing; a warp wholly past the last ray exits.
//
// Why the two gates change no result: the sweep computes the closest hit
// (or any hit) over the slots of the supernodes that the ray's BLOCK voted
// for, which the plain versions compute by Woop-testing every such slot.
// The widened slab test culls no box whose triangle the Woop test would
// accept with t in the segment (csrc/bvh.cuh, header: K3 equals the brute
// scan bit for bit that way), a supernode's box holds its clusters' boxes,
// and a hit lies in a non-empty cluster (padding rows are zero and never
// hit).  The closest hit gates on (0, best): a skipped triangle could only
// give t >= best, which a strict `<` in slot order never takes.
//
// What bounds it on the H100: the Woop tests of the slots a warp's lanes
// let through, ~40 instructions each, the rows hit in L1 / L2 (the sphere
// field's 147k slots are 7 MB).  The block sweep before it Woop-tested
// every slot of every supernode its 256-ray block voted for, for every
// ray; most of those boxes a ray misses.  The warps balance over the
// card's SMs one at a time, where a CTA waited on its block's slowest ray
// and its barriers.
//
// K7c.  A CTA takes one block of kBlock = 256 rays and a range of at most
// kRange supernodes (the grid's y: a block's supernodes split over CTAs, so
// that a few hundred blocks fill the card).  It stages the range's boxes in
// shared memory once, as two rows a box, and zeroes one flag a supernode.
// A warp takes 32 consecutive rays, a lane one ray: its origin, inverse
// direction (inv_dir_nan) and segment sit in registers, read once.
//   * A warp with no live lane (cluster_votes.cuh:live_ray: a NaN in its
//     origin, direction or segment, t_max < t_min; inactive lanes carry
//     t_max = -1e30, padding lanes past the last ray too) makes no test.
//   * A warp of more than kDirect live lanes reduces them by shuffles into
//     one bundle: per axis the least and greatest origin and inverse
//     direction, the least t_min and the greatest t_max.  It culls by the
//     bundle unless the inverse directions take both signs on every axis
//     (cluster_votes.cuh:bundle_useful), as 32 incoherent rays do.
//   * The warp takes the supernodes 32 at a time, lane i supernode s0 + i
//     (its box in registers).  With a bundle, lane i tests it against its
//     supernode (cluster_votes.cuh:bundle_culls) and keeps it unless culled;
//     without one it keeps it.  Then the exact votes (slab_nan), in the
//     cheaper of two ways: where at most as many supernodes are kept as the
//     warp has live rays, each kept one against every lane's own ray (its
//     box read from shared memory, two at a time, a lane's passes gathered
//     by bit and OR-reduced over the warp); else each live ray, taken from
//     its lane by shuffles, against every lane's own supernode.  A lane
//     stores 1 into its supernode's flag where the warp voted for it (a
//     plain store: every writer writes 1).
//   * After one barrier the CTA writes its range's votes, coalesced.
// No atomics; the flags need no order: the block's vote is the OR of its
// warps' votes.
//
// Why the cull drops no vote.  The cull is interval arithmetic on the exact
// test's own float operations.  Take a live lane with origin o, inverse
// direction v and segment [lo, hi] in a bundle B, and a box plane c on one
// axis.  (a) Under round to nearest, fl(c - x) does not increase as x does,
// so fl(c - o) lies in [fl(c - omax), fl(c - omin)].  (b) The exact product
// x * y over a rectangle lies between its values at the four corners (it is
// linear in each argument, whatever their signs), and rounding is monotone,
// so the lane's t = fl(fl(c - o) * v) lies between the least and the
// greatest rounded corner product, for both planes: its per-axis min and
// max (near and far) lie in [near_lo, far_hi] of bundle_axis.  (c) min and
// max are monotone, so the lane's t_near >= max(near_lo x y z, min t_min)
// and its t_far <= min(far_hi x y z, max t_max); where the bundle's t_far
// bound lies below its t_near bound, every live lane has t_far < t_near and
// fails.  A NaN (an infinite box or origin, the zero inverse of an infinite
// direction) is carried to the end by min_nan / max_nan and compares false:
// no cull.  (d) A lane that is not live fails every slab test, so leaving it
// out of the bundle, and a warp of such lanes out of the block, changes no
// vote.  +0 and -0 compare equal and change no comparison.  Both ways of
// the exact votes test each live ray against each kept supernode.  So the
// votes equal those of every ray tested against every box, which
// cluster_sweep.cluster_votes_ref computes: bundle_vote_tests models this
// schedule in torch and tests/test_torch_cluster_host.py checks the cull.
//
// What bounds K7c on the H100: the exact tests where a warp's rays are
// incoherent and all live (random rays, a frame's first bounces): the bundle
// then culls nothing, and a warp-wide test is ~40 instructions, 12 of them
// NaN-keeping min / max.  A row of camera rays is a tight bundle that keeps
// a few dozen of 1,024 supernodes; a warp of a few live lanes (a frame's
// late bounces) tests only its live rays.  The design before this one ran
// a thread a supernode against the block's 256 rays one by one, out of
// shared memory, until one passed, which almost never happens: every lane
// test was made, dead lanes' as dear as live ones.
//
// Precision: built with --fmad=false like the other kernels.  K7c's slab
// test is plain multiplies, subtracts, min / max and an IEEE division for
// the inverse direction (math3d.safe_div(1, d)), as the plain torch version
// computes them, with torch's NaN rule (common.cuh:slab_nan): a lane with
// a NaN origin, direction or segment end votes for nothing, as on the CPU
// and in JAX's _prepare, where fminf / fmaxf would drop the NaN and let it
// vote.  So the votes are equal.  The Woop test is
// csrc/common.cuh:woop_eval, whose fmaf calls sit where ops/woop.py calls
// m3.fma: opz, dpz, the hit point and u, v are fused multiply-adds, the
// trailing `+ b` and the division are not.  So t, prim, u and v equal the
// plain scan bit for bit.
#include <cuda_runtime.h>

#include "bvh.cuh"
#include "cluster_votes.cuh"

namespace {

constexpr int kBlock = 256;  // rays per vote block = cluster_sweep.BLOCK
constexpr unsigned kAll = 0xffffffffu;
// K7c: warps a CTA (each takes kBlock / 32 / kVoteWarps warps of rays in turn),
// supernodes a CTA (the grid's split of a block's supernodes), whether a
// warp culls by its bundle, the most live rays of a warp that makes no
// bundle test (= cluster_sweep.DIRECT) and the CTAs an SM that K7c's
// registers must allow; tools/torch_cluster_variants.py builds copies with
// other values.
constexpr int kVoteWarps = 8;
constexpr int kRange = 256;
constexpr bool kCull = true;
constexpr int kDirect = 8;
constexpr int kVoteCtas = 4;
// K7d / K7e: warps a CTA and the Woop loop's unroll;
// tools/torch_cluster_variants.py builds copies with other values.
constexpr int kWarps = 4;
constexpr int kUnroll = 4;

// The bundle of the warp's live lanes (each lane gets it).
__device__ __forceinline__ gst::Bundle warp_bundle(gst::Bundle b) {
  for (int k = 16; k; k >>= 1) {
    gst::Bundle o;
    o.omin = gst::v3(__shfl_xor_sync(kAll, b.omin.x, k), __shfl_xor_sync(kAll, b.omin.y, k),
                     __shfl_xor_sync(kAll, b.omin.z, k));
    o.omax = gst::v3(__shfl_xor_sync(kAll, b.omax.x, k), __shfl_xor_sync(kAll, b.omax.y, k),
                     __shfl_xor_sync(kAll, b.omax.z, k));
    o.imin = gst::v3(__shfl_xor_sync(kAll, b.imin.x, k), __shfl_xor_sync(kAll, b.imin.y, k),
                     __shfl_xor_sync(kAll, b.imin.z, k));
    o.imax = gst::v3(__shfl_xor_sync(kAll, b.imax.x, k), __shfl_xor_sync(kAll, b.imax.y, k),
                     __shfl_xor_sync(kAll, b.imax.z, k));
    o.lo = __shfl_xor_sync(kAll, b.lo, k);
    o.hi = __shfl_xor_sync(kAll, b.hi, k);
    b = gst::merge(b, o);
  }
  return b;
}

// One lane's ray of K7c's block: padding rays past the last are not live.
struct VoteRay {
  gst::V3 o, inv;
  float lo, hi;
  bool live;
};

__device__ __forceinline__ VoteRay vote_ray(const float* __restrict__ origin,
                                            const float* __restrict__ direction,
                                            const float* __restrict__ t_min,
                                            const float* __restrict__ t_max, int r,
                                            int n_rays) {
  const bool in = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, in, 0.0f);
  const gst::V3 d = gst::load3(direction, r, in, 1.0f);
  const gst::V3 inv = gst::v3(gst::inv_dir_nan(d.x), gst::inv_dir_nan(d.y), gst::inv_dir_nan(d.z));
  const float lo = in ? t_min[r] : 0.0f;
  const float hi = in ? t_max[r] : -gst::kBig;
  return {o, inv, lo, hi, gst::live_ray(o, inv, lo, hi)};
}

// K7c's boxes of one CTA, staged in shared memory as two rows a box (lo xyz
// and hi x; hi y z).
struct VoteBoxes {
  const float4* a;
  const float2* b;
  __device__ __forceinline__ gst::Box operator()(int i) const {
    const float4 p = a[i];
    const float2 q = b[i];
    return {gst::v3(p.x, p.y, p.z), gst::v3(p.w, q.x, q.y)};
  }
};

__global__ void __launch_bounds__(32 * kVoteWarps, kVoteCtas)
cluster_votes_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                     const float* __restrict__ t_min, const float* __restrict__ t_max,
                     int n_rays, const float* __restrict__ blo, const float* __restrict__ bhi,
                     int sp, int n_super, int* __restrict__ votes) {
  constexpr int kThreads = 32 * kVoteWarps;
  __shared__ float4 box_a[kRange];
  __shared__ float2 box_b[kRange];
  __shared__ int flag[kRange];
  const int s_begin = blockIdx.y * kRange;
  const int n = min(kRange, n_super - s_begin);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = s_begin + i;
    box_a[i] = make_float4(blo[s], blo[sp + s], blo[2 * sp + s], bhi[s]);
    box_b[i] = make_float2(bhi[sp + s], bhi[2 * sp + s]);
    flag[i] = 0;
  }
  __syncthreads();
  const VoteBoxes boxes{box_a, box_b};
  const int lane = threadIdx.x & 31;
  const int r_block = blockIdx.x * kBlock;
  for (int g = threadIdx.x / 32; g < kBlock / 32; g += kVoteWarps) {
    const VoteRay ray = vote_ray(origin, direction, t_min, t_max, r_block + 32 * g + lane, n_rays);
    const unsigned live = __ballot_sync(kAll, ray.live);
    if (!live) continue;  // no live lane: no test
    const int n_live = __popc(live);
    gst::Bundle bundle{};
    if (kCull && n_live > kDirect)
      bundle = warp_bundle(gst::ray_bundle(ray.o, ray.inv, ray.lo, ray.hi, ray.live));
    const bool cull = kCull && n_live > kDirect && gst::bundle_useful(bundle);
    for (int s0 = 0; s0 < n; s0 += 32) {
      const int i = s0 + lane;
      const gst::Box box = boxes(min(i, n - 1));
      const bool keep = i < n && !(cull && gst::bundle_culls(box, bundle));
      const unsigned kept = __ballot_sync(kAll, keep);
      bool voted = false;  // for supernode i
      if (__popc(kept) <= n_live) {
        // each kept supernode against every lane's own ray, two at a time;
        // a lane that is not live never passes
        unsigned hit = 0;  // bit b: this lane's ray passes supernode s0 + b
        for (unsigned m = kept; m;) {
          const int b0 = __ffs(m) - 1;
          m &= m - 1;
          const int b1 = m ? __ffs(m) - 1 : b0;
          m &= m - 1;
          const gst::Box x0 = boxes(s0 + b0), x1 = boxes(s0 + b1);
          hit |= (unsigned)gst::vote_passes(x0, ray.o, ray.inv, ray.lo, ray.hi) << b0 |
                 (unsigned)gst::vote_passes(x1, ray.o, ray.inv, ray.lo, ray.hi) << b1;
        }
        voted = __reduce_or_sync(kAll, hit) >> lane & 1u;
      } else {
        // each live ray, taken from its lane, against every lane's own supernode
        for (unsigned m = live; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const gst::V3 o =
              gst::v3(__shfl_sync(kAll, ray.o.x, src), __shfl_sync(kAll, ray.o.y, src),
                      __shfl_sync(kAll, ray.o.z, src));
          const gst::V3 inv =
              gst::v3(__shfl_sync(kAll, ray.inv.x, src), __shfl_sync(kAll, ray.inv.y, src),
                      __shfl_sync(kAll, ray.inv.z, src));
          voted |= gst::vote_passes(box, o, inv, __shfl_sync(kAll, ray.lo, src),
                                    __shfl_sync(kAll, ray.hi, src));
        }
        voted = voted && keep;
      }
      if (voted) flag[i] = 1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    votes[(size_t)blockIdx.x * n_super + s_begin + i] = flag[i];
}

// The block's votes, 32 supernodes at a time: each lane reads one, and
// every lane of the warp gets the mask of those voted.  `lane` is the
// caller's lane index.
__device__ __forceinline__ unsigned voted(const int* __restrict__ block_votes, int s0,
                                          int n_super, int lane) {
  const int s = s0 + lane;
  return __ballot_sync(kAll, s < n_super && __ldg(block_votes + s) != 0);
}

// Box i of a (3, stride) pair of lo / hi tables (the supernode boxes).
__device__ __forceinline__ void box3(const float* __restrict__ lo, const float* __restrict__ hi,
                                     int stride, int i, gst::V3& bl, gst::V3& bh) {
  bl = gst::v3(__ldg(lo + i), __ldg(lo + stride + i), __ldg(lo + 2 * stride + i));
  bh = gst::v3(__ldg(hi + i), __ldg(hi + stride + i), __ldg(hi + 2 * stride + i));
}

// The tables of one sweep: supernode boxes, the leaf clusters' boxes (rows
// of the (C, 3) node_min / node_max tables from the first leaf on,
// inverted where a cluster is empty) and the (T, 12) Woop rows.
struct Sweep {
  const int* votes;
  const float *blo, *bhi;
  int sp, n_super, stride;
  const float *cmin, *cmax;
  int n_clusters, leaf_size;
  const float4* woop;
  int n_slots;
};

// Whether the ray's widened slab test enters leaf cluster c on [lo, hi]; an
// empty cluster (inverted box, zero rows) is never entered: the slab test
// alone would pass every ray through its +inf / -inf bounds.
__device__ __forceinline__ bool cluster_entered(const Sweep& S, int c, gst::V3 o, gst::V3 inv,
                                                float lo, float hi) {
  const gst::V3 bl = gst::v3(__ldg(S.cmin + 3 * c), __ldg(S.cmin + 3 * c + 1),
                             __ldg(S.cmin + 3 * c + 2));
  const gst::V3 bh = gst::v3(__ldg(S.cmax + 3 * c), __ldg(S.cmax + 3 * c + 1),
                             __ldg(S.cmax + 3 * c + 2));
  float near;
  return !(bl.x > bh.x) && gst::slab_entered(bl, bh, o, inv, lo, hi, near);
}

// The slots a lane Woop-tests in voted supernode s once its own test passed
// (`go`): those of each leaf cluster that some lane of the warp enters, each
// lane testing only the clusters it enters itself.  `visit(slot, test)` runs
// for each slot in order, `test` whether this lane tests it, and returns
// whether the lane goes on searching (false after an any hit's occluder).
// With kStops the warp leaves a cluster, and the supernode, once no lane
// goes on in it.
template <bool kStops, class Visit>
__device__ __forceinline__ void sweep_supernode(const Sweep& S, int s, bool go, gst::V3 o,
                                                gst::V3 inv, float lo, const float& hi,
                                                Visit&& visit) {
  const int k = S.stride / S.leaf_size;
  const int c1 = min((s + 1) * k, S.n_clusters);
  for (int c = s * k; c < c1 && (!kStops || __any_sync(kAll, go)); ++c) {
    bool cin = go && cluster_entered(S, c, o, inv, lo, hi);
    if (!__any_sync(kAll, cin)) continue;
    const int e = min((c + 1) * S.leaf_size, S.n_slots);
#pragma unroll(kUnroll)
    for (int slot = c * S.leaf_size; slot < e; ++slot) {
      go = visit(slot, cin) && go;
      cin = cin && go;
      if (kStops && !__any_sync(kAll, cin)) break;
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
cluster_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                       const float* __restrict__ t_max, int n_rays, Sweep S,
                       const float* __restrict__ attr, int n_attr, float* __restrict__ t_out,
                       int* __restrict__ prim_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, float* __restrict__ attr_out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + threadIdx.x / 32) * 32;  // the warp's first ray
  if (r0 >= n_rays) return;  // a whole warp past the last ray
  const int r = r0 + lane;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = gst::v3(gst::inv_dir1(d.x), gst::inv_dir1(d.y), gst::inv_dir1(d.z));
  float best = live ? t_max[r] : -gst::kBig;
  const bool act = best > 0.0f;  // a segment (0, t_max) to search
  float best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  const int* block_votes = S.votes + (size_t)(r0 / kBlock) * S.n_super;
  for (int s0 = 0; s0 < S.n_super; s0 += 32) {
    for (unsigned m = voted(block_votes, s0, S.n_super, lane); m; m &= m - 1) {
      const int s = s0 + __ffs(m) - 1;
      gst::V3 bl, bh;
      box3(S.blo, S.bhi, S.sp, s, bl, bh);
      float near;
      const bool in = act && gst::slab_entered(bl, bh, o, inv, 0.0f, best, near);
      if (!__any_sync(kAll, in)) continue;
      sweep_supernode<false>(S, s, in, o, inv, 0.0f, best, [&](int slot, bool test) {
        float t, u, v;
        // strict `<` against best (woop_eval's t < t_hi), slots in order:
        // the lowest slot wins among exactly tied t
        if (gst::woop_row(S.woop + 3 * slot, o, d, 0.0f, best, t, u, v) && test) {
          best = t;
          best_u = u;
          best_v = v;
          best_prim = slot;
        }
        return true;
      });
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

__global__ void __launch_bounds__(32 * kWarps)
cluster_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                   Sweep S, bool* __restrict__ occ_out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + threadIdx.x / 32) * 32;
  if (r0 >= n_rays) return;
  const int r = r0 + lane;
  const bool live = r < n_rays;
  const gst::V3 o = gst::load3(origin, r, live, 0.0f);
  const gst::V3 d = gst::load3(direction, r, live, 1.0f);
  const gst::V3 inv = gst::v3(gst::inv_dir1(d.x), gst::inv_dir1(d.y), gst::inv_dir1(d.z));
  const float lo = live ? t_min[r] : 0.0f;
  const float hi = live ? t_max[r] : -gst::kBig;
  bool occ = false;
  bool todo = hi > lo;  // no t lies in an empty (lo, hi): never occluded
  const int* block_votes = S.votes + (size_t)(r0 / kBlock) * S.n_super;
  for (int s0 = 0; s0 < S.n_super && __any_sync(kAll, todo); s0 += 32) {
    for (unsigned m = voted(block_votes, s0, S.n_super, lane); m && __any_sync(kAll, todo);
         m &= m - 1) {
      const int s = s0 + __ffs(m) - 1;
      gst::V3 bl, bh;
      box3(S.blo, S.bhi, S.sp, s, bl, bh);
      float near;
      const bool in = todo && gst::slab_entered(bl, bh, o, inv, lo, hi, near);
      if (!__any_sync(kAll, in)) continue;
      sweep_supernode<true>(S, s, in, o, inv, lo, hi, [&](int slot, bool test) {
        float t, u, v;
        if (gst::woop_row(S.woop + 3 * slot, o, d, lo, hi, t, u, v) && test) {
          occ = true;  // the lane's first occluder: it stops
          todo = false;
        }
        return todo;
      });
    }
  }
  if (live) occ_out[r] = occ;
}

int blocks_for(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

// A launch of K7d / K7e: one warp a 32 rays, kWarps warps a CTA.
dim3 sweep_grid(int n_rays) {
  const int warps = (n_rays + 31) / 32;
  return dim3((warps + kWarps - 1) / kWarps);
}

Sweep sweep_tables(const int* votes, const float* blo, const float* bhi, int sp, int n_super,
                   int stride, const float* cmin, const float* cmax, int n_clusters,
                   int leaf_size, const float* woop, int n_slots) {
  return Sweep{votes, blo, bhi, sp, n_super, stride, cmin, cmax, n_clusters, leaf_size,
               reinterpret_cast<const float4*>(woop), n_slots};
}

}  // namespace

extern "C" int gst_cluster_votes(const float* origin, const float* direction, const float* t_min,
                                 const float* t_max, int n_rays, const float* blo,
                                 const float* bhi, int sp, int n_super, int* votes,
                                 void* stream) {
  if (n_rays == 0 || n_super == 0) return 0;
  const dim3 grid(blocks_for(n_rays), (n_super + kRange - 1) / kRange);
  cluster_votes_kernel<<<grid, 32 * kVoteWarps, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, blo, bhi, sp, n_super, votes);
  return (int)cudaGetLastError();
}

// cmin / cmax: the first leaf cluster's row of the (2C - 1, 3) node tables;
// woop: the (n_slots, 12) Woop rows, 16-byte aligned.
extern "C" int gst_cluster_closest(const float* origin, const float* direction,
                                   const float* t_max, int n_rays, const int* votes,
                                   const float* blo, const float* bhi, int sp, int n_super,
                                   int stride, const float* cmin, const float* cmax,
                                   int n_clusters, int leaf_size, const float* woop, int n_slots,
                                   const float* attr, int n_attr, float* t_out, int* prim_out,
                                   float* u_out, float* v_out, float* attr_out, void* stream) {
  if (n_rays == 0) return 0;
  cluster_closest_kernel<<<sweep_grid(n_rays), 32 * kWarps, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays,
      sweep_tables(votes, blo, bhi, sp, n_super, stride, cmin, cmax, n_clusters, leaf_size, woop,
                   n_slots),
      attr, n_attr, t_out, prim_out, u_out, v_out, attr_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_cluster_any(const float* origin, const float* direction, const float* t_min,
                               const float* t_max, int n_rays, const int* votes,
                               const float* blo, const float* bhi, int sp, int n_super,
                               int stride, const float* cmin, const float* cmax, int n_clusters,
                               int leaf_size, const float* woop, int n_slots, bool* occ_out,
                               void* stream) {
  if (n_rays == 0) return 0;
  cluster_any_kernel<<<sweep_grid(n_rays), 32 * kWarps, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays,
      sweep_tables(votes, blo, bhi, sp, n_super, stride, cmin, cmax, n_clusters, leaf_size, woop,
                   n_slots),
      occ_out);
  return (int)cudaGetLastError();
}
