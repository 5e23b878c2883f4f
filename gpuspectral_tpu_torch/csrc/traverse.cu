// K7h: packet traversal of the implicit cluster tree, for sm_90a.
//
// Replaces gpuspectral_tpu/bvh/kernels.py:traverse_pallas (the pallas_call at
// kernels.py:269, body _traversal_kernel :58, triangle table _pack_tris :37).
// Wrapper: gpuspectral_tpu_torch/bvh/kernels.py (traverse_closest,
// traverse_any).  Plain version: bvh/traverse.py (intersect_closest_bvh_ref,
// intersect_any_bvh_ref), which the kernels equal bit for bit.
//
// The tree is bvh/build.py's: C clusters (a power of two) of leaf_size
// slots, nodes in (2C - 1, 3) min / max tables, node n's children 2n + 1 and
// 2n + 2, leaves from C - 1 on; leaf C - 1 + c holds the rows
// [c * leaf_size, (c + 1) * leaf_size) of the (C * leaf_size, 12) table of
// kernels.pack_tris, [v0, e1 = p1 - v0, e2 = p2 - v0, 0, 0, 0] (zero rows,
// which never hit, past the scene's triangles).
//
// One CTA per packet of `packet` consecutive rays (the ragged last packet
// padded with rays o = 0, d = 1, t_min = 0, t_max = -1e30, which never hit,
// as traverse._packets pads it).  T = min(packet rounded up to a warp, 1024)
// threads, each owning kPer rays of the packet (ray j on thread j % T; kPer =
// 1 up to 1024 rays a packet, 2 up to kMaxPacket = 2048), their state in
// registers.
// The walk is the CTA's, not a ray's: every thread holds the same node and
// stack pointer, and the stack of right children still to visit lives in
// shared memory, written by thread 0.  At each node:
//   * each thread slab-tests its rays against the node's box (a broadcast
//     load) on [t_min, best]; __syncthreads_or of those votes is the
//     packet's vote.  No slab widening: a ray may find its hit in a leaf
//     that only another ray's vote let the packet enter, as in the plain
//     version.
//   * an entered internal node pushes its right child 2n + 2 and visits its
//     left child 2n + 1 next: the left subtree first, the order in which the
//     plain version pops (the JAX Pallas kernel pops the right child first
//     and so breaks exact-t ties across leaves the other way).
//   * at an entered leaf the CTA stages its leaf_size rows (16 x 12 floats
//     on the sphere field) in shared memory, and every ray of the packet
//     tests them in slot order with a strict `<` against its running best:
//     the plain version's argmin over the leaf followed by `t_new < best`
//     across leaves, so exact-t ties go to the lowest slot.
//   any hit: an occluded ray stops voting and testing, a ray stops at its
//     first hit in (t_min, t_max), and the CTA stops once every ray of the
//     packet, padding included, is occluded (__syncthreads_and), where the
//     plain version's loop stops.
// Barriers: the vote's __syncthreads_or also keeps the previous leaf's
// readers ahead of the next staging, and thread 0's push ahead of the pop
// that reads it (a push is always followed by the vote on the left child).
//
// What bounds it on the H100: operations.  On the sphere field (C = 16,384
// clusters of 16 slots, 7,159 of them empty) a 1024-ray packet of random
// rays votes on ~12,900 nodes and enters ~5,800 leaves, and every ray of the
// packet makes an entered leaf's 16 Moller-Trumbore tests (46 flops each)
// whether it voted or not: ~92,800 tests a ray.  Most entered leaves are
// empty padding: an empty cluster's inverted infinite box (bvh/build.py)
// passes every slab test (t_enter = -inf, t_exit = +inf) and its zero rows
// never hit, so skipping inverted boxes would cut the tests ~20x without
// changing a result (tools/torch_traverse_empty.py).  Past that, the fixed
// left-first order culls only by the packet's best t.  One CTA per packet
// gives a 65,536-ray batch 64 CTAs for 132 SMs, and each node costs a CTA
// barrier; votes across a thread block cluster (distributed shared memory)
// and a front-to-back order are later work.  No wgmma or TMA: the tests
// are scalar float32.
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
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxStack = 64;  // right children pending: at most log2(C)
constexpr int kMaxPacket = 2 * kMaxThreads;

struct Ray {
  gst::V3 o, d, inv;
  float lo, best, u, v;
  int prim;
  bool occ;
  int boxes, tests;  // the tests made, kept by the counting kernels only
};

// math3d.safe_div(1, d): |d| clamped to 1e-12 with its sign, NaN kept
__device__ __forceinline__ float inv_dir(float dx) {
  const float a = fabsf(dx);
  const float mag = a < 1e-12f ? 1e-12f : a;
  return 1.0f / (dx < 0.0f ? -mag : mag);
}

// The plain version's node test (bvh/traverse.py:_ray_aabb and node_hit):
// t_enter = max of the per-axis min, t_exit = min of the per-axis max,
// (t_exit >= t_enter) & (t_exit >= t_min) & (t_enter <= best).
__device__ __forceinline__ bool node_hit(const float* __restrict__ lo,
                                         const float* __restrict__ hi, const Ray& r) {
  const float t0x = (lo[0] - r.o.x) * r.inv.x;
  const float t0y = (lo[1] - r.o.y) * r.inv.y;
  const float t0z = (lo[2] - r.o.z) * r.inv.z;
  const float t1x = (hi[0] - r.o.x) * r.inv.x;
  const float t1y = (hi[1] - r.o.y) * r.inv.y;
  const float t1z = (hi[2] - r.o.z) * r.inv.z;
  if (isnan(t0x) || isnan(t0y) || isnan(t0z) || isnan(t1x) || isnan(t1y) || isnan(t1z)) {
    return false;
  }
  const float t_enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float t_exit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (t_exit >= t_enter) && (t_exit >= r.lo) && (t_enter <= r.best);
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

// kCount: also count each ray's slab and Moller-Trumbore tests into
// boxes_out / tests_out (kernels.traverse_tests); the walk is the same.
template <int kPer, bool kAny, bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
traverse_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                const float* __restrict__ t_min, const float* __restrict__ t_max, int n_rays,
                int packet, const float* __restrict__ node_min,
                const float* __restrict__ node_max, const float* __restrict__ tris,
                int n_clusters, int leaf_size, float* __restrict__ t_out,
                int* __restrict__ prim_out, float* __restrict__ u_out,
                float* __restrict__ v_out, bool* __restrict__ occ_out,
                int* __restrict__ boxes_out, int* __restrict__ tests_out) {
  extern __shared__ float leaf_rows[];  // leaf_size x 12
  __shared__ int stack[kMaxStack];
  const int first_leaf = n_clusters - 1;
  const long long first_ray = (long long)blockIdx.x * packet;
  Ray ray[kPer];
  bool in_packet[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * blockDim.x + threadIdx.x;
    const long long i = first_ray + j;
    in_packet[k] = j < packet;  // else a thread slot past the packet: no ray
    const bool live = in_packet[k] && i < n_rays;
    Ray& r = ray[k];
    r.o = live ? gst::V3{origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]}
               : gst::V3{0.0f, 0.0f, 0.0f};
    r.d = live ? gst::V3{direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]}
               : gst::V3{1.0f, 1.0f, 1.0f};
    r.inv = {inv_dir(r.d.x), inv_dir(r.d.y), inv_dir(r.d.z)};
    r.lo = live ? t_min[i] : 0.0f;
    const float hi = live ? t_max[i] : -gst::kBig;
    r.best = hi > r.lo ? hi : -gst::kBig;  // the ray's search window (lo, best)
    r.u = 0.0f;
    r.v = 0.0f;
    r.prim = -1;
    r.occ = !in_packet[k];  // a slot past the packet never holds the packet back
    r.boxes = 0;
    r.tests = 0;
  }

  int node = 0, sp = 0;
  while (true) {
    const float* lo = node_min + 3 * (size_t)node;
    const float* hi = node_max + 3 * (size_t)node;
    bool vote = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (in_packet[k] && !(kAny && ray[k].occ)) {
        vote |= node_hit(lo, hi, ray[k]);
        if (kCount) ++ray[k].boxes;
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
      const float* src = tris + (size_t)cluster * leaf_size * 12;
      for (int e = threadIdx.x; e < leaf_size * 12; e += blockDim.x) leaf_rows[e] = src[e];
      __syncthreads();
      bool done = true;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        Ray& r = ray[k];
        // an empty window (lo, best) holds no hit: such a ray tests nothing
        const bool tests = in_packet[k] && !(kAny && r.occ) && r.best > r.lo;
        for (int s = 0; tests && s < leaf_size; ++s) {
          float t, u, v;
          if (kCount) ++r.tests;
          if (mt_test(&leaf_rows[12 * s], r, r.best, t, u, v)) {
            if (kAny) {
              r.occ = true;
              break;
            }
            r.best = t;
            r.u = u;
            r.v = v;
            r.prim = cluster * leaf_size + s;
          }
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
    const int j = k * blockDim.x + threadIdx.x;
    const long long i = first_ray + j;
    if (!in_packet[k] || i >= n_rays) continue;
    const Ray& r = ray[k];
    if (kCount) {
      boxes_out[i] = r.boxes;
      tests_out[i] = r.tests;
    }
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
}

template <bool kAny, bool kCount>
int launch(const float* origin, const float* direction, const float* t_min, const float* t_max,
           int n_rays, int packet, const float* node_min, const float* node_max,
           const float* tris, int n_clusters, int leaf_size, float* t_out, int* prim_out,
           float* u_out, float* v_out, bool* occ_out, int* boxes_out, int* tests_out,
           void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = (size_t)leaf_size * 12 * sizeof(float);
  if (packet < 1 || packet > kMaxPacket || leaf_size < 1 || smem > 48 * 1024 ||
      n_clusters < 1 || (n_clusters & (n_clusters - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = min(kMaxThreads, (packet + 31) / 32 * 32);
  const int per = (packet + threads - 1) / threads;
  const int grid = (int)(((long long)n_rays + packet - 1) / packet);
  const cudaStream_t s = (cudaStream_t)stream;
#define GST_TRAVERSE(K)                                                                       \
  traverse_kernel<K, kAny, kCount><<<grid, threads, smem, s>>>(                               \
      origin, direction, t_min, t_max, n_rays, packet, node_min, node_max, tris, n_clusters, \
      leaf_size, t_out, prim_out, u_out, v_out, occ_out, boxes_out, tests_out)
  if (per == 1) {
    GST_TRAVERSE(1);
  } else {
    GST_TRAVERSE(2);
  }
#undef GST_TRAVERSE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gst_traverse_closest(const float* origin, const float* direction,
                                    const float* t_min, const float* t_max, int n_rays,
                                    int packet, const float* node_min, const float* node_max,
                                    const float* tris, int n_clusters, int leaf_size,
                                    float* t_out, int* prim_out, float* u_out, float* v_out,
                                    void* stream) {
  return launch<false, false>(origin, direction, t_min, t_max, n_rays, packet, node_min,
                              node_max, tris, n_clusters, leaf_size, t_out, prim_out, u_out,
                              v_out, nullptr, nullptr, nullptr, stream);
}

extern "C" int gst_traverse_any(const float* origin, const float* direction, const float* t_min,
                                const float* t_max, int n_rays, int packet,
                                const float* node_min, const float* node_max, const float* tris,
                                int n_clusters, int leaf_size, bool* occ_out, void* stream) {
  return launch<true, false>(origin, direction, t_min, t_max, n_rays, packet, node_min, node_max,
                             tris, n_clusters, leaf_size, nullptr, nullptr, nullptr, nullptr,
                             occ_out, nullptr, nullptr, stream);
}

// The same walk with each ray's slab and Moller-Trumbore tests counted
// (kernels.traverse_tests): the closest hit's outputs, or with any_hit occ.
extern "C" int gst_traverse_count(const float* origin, const float* direction,
                                  const float* t_min, const float* t_max, int n_rays, int packet,
                                  const float* node_min, const float* node_max,
                                  const float* tris, int n_clusters, int leaf_size, int any_hit,
                                  float* t_out, int* prim_out, float* u_out, float* v_out,
                                  bool* occ_out, int* boxes_out, int* tests_out, void* stream) {
  if (any_hit) {
    return launch<true, true>(origin, direction, t_min, t_max, n_rays, packet, node_min,
                              node_max, tris, n_clusters, leaf_size, nullptr, nullptr, nullptr,
                              nullptr, occ_out, boxes_out, tests_out, stream);
  }
  return launch<false, true>(origin, direction, t_min, t_max, n_rays, packet, node_min, node_max,
                             tris, n_clusters, leaf_size, t_out, prim_out, u_out, v_out, nullptr,
                             boxes_out, tests_out, stream);
}
