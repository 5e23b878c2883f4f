// K7a / K7b: the binned sweep, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/binned.py: _make_fused_closest_kernel (K7a,
// the pallas_call at binned.py:409, votes by _vote_words) and
// _make_fused_any_kernel (K7b, :449).  Wrapper:
// gpuspectral_tpu_torch/bvh/binned.py (binned_closest, binned_any).
//
// The function.  The scene's leaf clusters are grouped into n_bins sweep
// bins: bin b covers the slots [b * slots, (b + 1) * slots) of the Woop
// table, that is the g = slots / leaf_size consecutive clusters [b * g,
// (b + 1) * g) of the implicit tree of the scene build, and has one box.  A
// ray votes for bin b where the slab test of b's box on [0, t_max] passes
// (unwidened, the inverse direction math3d.safe_div(1, d)).  K7a is the
// closest hit with t in (0, t_max), ties to the lowest slot, among the
// slots of the bins the ray votes for; K7b whether one of those slots holds
// a hit in (t_min, t_max).  Slots past the Woop table are never tested.  A
// ray with t_max <= 0 (K7a), or t_max <= t_min (K7b), votes for nothing.
//
// The design: one thread a ray walks the BVH of K3 (csrc/bvh.cuh: the
// child-pair rows, near child first for K7a and left first for K7b,
// while-while, 128-bit __ldg rows, a local stack, no shared memory) with
// its bin vote as a leaf filter: at a cluster c the walk tests c's slots
// only where c / g < n_bins and the ray votes for bin c / g.  The vote is
// computed at the leaf, on the bin's packed row (two float4 of the (n_bins,
// 8) bin rows), and the last bin's vote stays in registers: the leaves of
// a walk mostly come in runs of one bin (g = 16 clusters on the sphere
// field; 0.4 votes a random ray against its 8.4 Woop tests).  A ray that
// can vote for nothing (an empty segment, a NaN in its origin or
// direction) skips the walk.  No CTA barrier and no staging: the TPU
// kernel's 687-bin vote loop per ray and the block's union of votes (a
// warp of rays Woop-testing every slot of every bin one of them voted for)
// are gone.
//
// Why it equals the plain version bit for bit.  The walk's widened slab
// gate on (0, best) skips only boxes whose triangles the Woop test would
// reject or that could not beat best (bvh.cuh, header: K3 equals the brute
// scan that way); a hit lies in a non-empty cluster (padding rows are zero
// and never hit, and the pair rows prune only empty clusters); the vote
// alone decides which bins count, computed as the plain _votes computes it
// (common.cuh:slab_nan, torch's NaN rule kept); the closest hit commits on
// t < best || (t == best && slot < best_slot), so the order of the walk
// changes no tie.  K7b stops at its first occluder in (t_min, t_max); a
// node its gate culls on (t_min, t_max) holds no such occluder.
//
// What bounds it on the H100: as for K3, the SIMT efficiency of a divergent
// per-ray walk and the latency of its scattered reads (64 B a pair row, 48
// B a Woop slot, 32 B a bin row), not the tests' arithmetic.  The walk
// makes K3's tests plus one bin vote a run of leaves; the block sweep it
// replaces slab-tested all n_bins boxes for every ray and Woop-tested the
// union of a warp's votes.  Variants that lost (tools/torch_binned_variants.py
// at commit 3f246ab; PERF.md): the bin rows staged in shared memory by each
// CTA (1.11x slower), K7b's walk near child first (1.15x random, 1.6x
// primary rays); a fresh vote at every leaf ran as fast as the cached one.
//
// Precision: built with --fmad=false like the other kernels.  The vote is
// plain subtracts, multiplies, NaN-keeping min / max and an IEEE division,
// as torch computes it; the Woop test is common.cuh:woop_eval, whose fmaf
// calls sit where ops/woop.py calls m3.fma.  So t, prim, u, v and occ equal
// the plain version's.
//
// gst_binned_count is no part of the render path: the same walk with each
// ray's box tests, bin votes and Woop tests counted, the clusters it tests
// marked, and its result written (bvh/binned.py: binned_walk_tests, the
// count of K7a / K7b's bounds).
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

constexpr int kThreads = 128;  // as K3 (bvh.cu): 16 warps an SM
constexpr int kWarpsPerSm = 16;
constexpr int kCtasPerSm = kWarpsPerSm * 32 / kThreads;

struct BinTables {
  const float4* rows;  // (n_bins, 2 float4): [lo xyz, 0], [hi xyz, 0]
  int n_bins, g;       // g clusters a bin
};

// The leaf filter of K7a / K7b: cluster c is tested where its bin lies in
// the table and the ray votes for it.  kCount: count the votes made and
// mark the clusters tested (the counting kernel).
template <bool kCount>
struct BinVote {
  BinTables T;
  gst::V3 o, inv;
  float hi;
  int bin = -1;
  bool vote = false;
  int votes = 0;
  unsigned char* tested = nullptr;

  __device__ __forceinline__ bool operator()(int c) {
    const int b = c / T.g;
    if (b >= T.n_bins) return false;
    if (b != bin) {
      bin = b;
      vote = gst::slab_nan(gst::xyz(__ldg(T.rows + 2 * b)), gst::xyz(__ldg(T.rows + 2 * b + 1)),
                           o, inv, 0.0f, hi);
      if (kCount) ++votes;
    }
    if (kCount && vote) tested[c] = 1;
    return vote;
  }
};

// Whether the ray can vote for a bin at all: a segment to search and no
// NaN in its origin or direction (every slab test of such a ray fails).
__device__ __forceinline__ bool votes_any(gst::V3 o, gst::V3 d, bool segment) {
  return segment && !(isnan(o.x) || isnan(o.y) || isnan(o.z) || isnan(d.x) || isnan(d.y) ||
                      isnan(d.z));
}

template <bool kCount>
__device__ __forceinline__ BinVote<kCount> bin_vote(const BinTables& T, gst::V3 o, gst::V3 d,
                                                    float t_max) {
  BinVote<kCount> v;
  v.T = T;
  v.o = o;
  v.inv = gst::v3(gst::inv_dir_nan(d.x), gst::inv_dir_nan(d.y), gst::inv_dir_nan(d.z));
  v.hi = t_max;
  return v;
}

__device__ __forceinline__ gst::V3 ray3(const float* p, int r) {
  return gst::V3{p[3 * r], p[3 * r + 1], p[3 * r + 2]};
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
binned_closest_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                      const float* __restrict__ t_max, int n_rays, gst::WalkTables B,
                      BinTables T, float* __restrict__ t_out, int* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o = ray3(origin, r), d = ray3(direction, r);
  const float hi = t_max[r];
  float t = gst::kBig, u = 0.0f, v = 0.0f;
  int prim = -1;
  if (votes_any(o, d, hi > 0.0f)) {
    gst::walk_closest(B, o, d, hi, t, prim, u, v, gst::NoCount(),
                      bin_vote<false>(T, o, d, hi));
  }
  t_out[r] = t;
  prim_out[r] = prim;
  u_out[r] = u;
  v_out[r] = v;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
binned_any_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                  const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                  gst::WalkTables B, BinTables T, bool* __restrict__ occ_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o = ray3(origin, r), d = ray3(direction, r);
  const float lo = t_min[r], hi = t_max[r];
  // the votes take [0, t_max] whatever t_min is
  occ_out[r] = votes_any(o, d, hi > lo) &&
               gst::walk_any(B, o, d, lo, hi, gst::NoCount(), bin_vote<false>(T, o, d, hi));
}

__global__ void __launch_bounds__(kThreads)
binned_count_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                    const float* __restrict__ t_min, const float* __restrict__ t_max,
                    int n_rays, gst::WalkTables B, BinTables T, int any_hit,
                    int* __restrict__ boxes_out, int* __restrict__ votes_out,
                    int* __restrict__ woops_out, int* __restrict__ result_out,
                    unsigned char* __restrict__ tested) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const gst::V3 o = ray3(origin, r), d = ray3(direction, r);
  const float lo = t_min[r], hi = t_max[r];
  gst::TestCount count;
  BinVote<true> keep = bin_vote<true>(T, o, d, hi);
  keep.tested = tested;
  int result;
  if (any_hit) {
    result = votes_any(o, d, hi > lo) && gst::walk_any(B, o, d, lo, hi, count, keep);
  } else {
    float t = gst::kBig, u, v;
    result = -1;
    if (votes_any(o, d, hi > 0.0f)) gst::walk_closest(B, o, d, hi, t, result, u, v, count, keep);
  }
  boxes_out[r] = count.boxes;
  votes_out[r] = keep.votes;
  woops_out[r] = count.woops;
  result_out[r] = result;
}

int blocks(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

BinTables bin_tables(const float* bin_rows, int n_bins, int g) {
  return BinTables{reinterpret_cast<const float4*>(bin_rows), n_bins, g};
}

}  // namespace

// walk_ip: the ints of bvh.cuh:make_walk_tables (bvh/ftb.py:walk_tables);
// bin_rows (n_bins, 8) float (bvh/binned.py:bin_rows); g clusters a bin
extern "C" int gst_binned_closest(const float* origin, const float* direction, const float* t_max,
                                  int n_rays, const float* pairs, const float* woop,
                                  const int* walk_ip, const float* bin_rows, int n_bins, int g,
                                  float* t_out, int* prim_out, float* u_out, float* v_out,
                                  void* stream) {
  if (n_rays == 0) return 0;
  binned_closest_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_max, n_rays, gst::make_walk_tables(pairs, woop, walk_ip),
      bin_tables(bin_rows, n_bins, g), t_out, prim_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int gst_binned_any(const float* origin, const float* direction, const float* t_min,
                              const float* t_max, int n_rays, const float* pairs,
                              const float* woop, const int* walk_ip, const float* bin_rows,
                              int n_bins, int g, bool* occ_out, void* stream) {
  if (n_rays == 0) return 0;
  binned_any_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, gst::make_walk_tables(pairs, woop, walk_ip),
      bin_tables(bin_rows, n_bins, g), occ_out);
  return (int)cudaGetLastError();
}

// result_out: prim (-1 on a miss) or the occlusion flag; tested (n_clusters
// bytes, zeroed by the caller): 1 where some ray tested the cluster's slots
extern "C" int gst_binned_count(const float* origin, const float* direction, const float* t_min,
                                const float* t_max, int n_rays, const float* pairs,
                                const float* woop, const int* walk_ip, const float* bin_rows,
                                int n_bins, int g, int any_hit, int* boxes_out, int* votes_out,
                                int* woops_out, int* result_out, unsigned char* tested,
                                void* stream) {
  if (n_rays == 0) return 0;
  binned_count_kernel<<<blocks(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_min, t_max, n_rays, gst::make_walk_tables(pairs, woop, walk_ip),
      bin_tables(bin_rows, n_bins, g), any_hit, boxes_out, votes_out, woops_out, result_out,
      tested);
  return (int)cudaGetLastError();
}
