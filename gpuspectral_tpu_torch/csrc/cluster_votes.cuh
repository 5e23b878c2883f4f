// K7c's two tests (csrc/cluster.cu): a lane's exact vote and a warp's
// bundle cull.  Host functions too, so that tests/test_torch_cluster_host.py
// compiles them with g++ and holds the cull to the exact test on the CPU;
// bvh/cluster_sweep.py:bundle_culls is their torch copy, op for op.
#pragma once

#include "common.cuh"

namespace gst {

constexpr float kInf = __builtin_huge_valf();

// A supernode's box.
struct Box {
  V3 lo, hi;
};

// A warp's live rays as one bundle: per axis the least and the greatest
// origin and inverse direction, the least t_min and the greatest t_max.
struct Bundle {
  V3 omin, omax, imin, imax;
  float lo, hi;
};

// Whether the ray can pass a slab test: no NaN in its origin, inverse
// direction or segment, and t_max >= t_min.  slab_nan fails for every other
// ray (a NaN reaches t_near or t_far; or t_far <= t_max < t_min <= t_near).
__host__ __device__ __forceinline__ bool live_ray(V3 o, V3 inv, float lo, float hi) {
  return hi >= lo && o.x == o.x && o.y == o.y && o.z == o.z && inv.x == inv.x &&
         inv.y == inv.y && inv.z == inv.z;
}

// The bundle of one ray (the empty bundle for a ray that is not live, which
// changes no bundle it is merged into).
__host__ __device__ __forceinline__ Bundle ray_bundle(V3 o, V3 inv, float lo, float hi,
                                                      bool live) {
  const V3 top{kInf, kInf, kInf}, bottom{-kInf, -kInf, -kInf};
  return live ? Bundle{o, o, inv, inv, lo, hi} : Bundle{top, bottom, top, bottom, kInf, -kInf};
}

__host__ __device__ __forceinline__ V3 min3(V3 a, V3 b) {
  return {fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z)};
}

__host__ __device__ __forceinline__ V3 max3(V3 a, V3 b) {
  return {fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z)};
}

__host__ __device__ __forceinline__ Bundle merge(const Bundle& a, const Bundle& b) {
  return {min3(a.omin, b.omin), max3(a.omax, b.omax), min3(a.imin, b.imin),
          max3(a.imax, b.imax), fminf(a.lo, b.lo), fmaxf(a.hi, b.hi)};
}

// One axis of the bundle test: the least (near) and greatest (far) of the
// rounded products (c - o) * inv over the box's two planes c, o at the
// bundle's least and greatest origin and inv at its least and greatest
// inverse direction: eight corners, a NaN among them kept.
__host__ __device__ __forceinline__ void bundle_axis(float bl, float bh, float omin, float omax,
                                                     float imin, float imax, float& near,
                                                     float& far) {
  const float d0 = bl - omax, d1 = bl - omin, d2 = bh - omax, d3 = bh - omin;
  const float p0 = d0 * imin, p1 = d0 * imax, p2 = d1 * imin, p3 = d1 * imax;
  const float p4 = d2 * imin, p5 = d2 * imax, p6 = d3 * imin, p7 = d3 * imax;
  near = min_nan(min_nan(min_nan(p0, p1), min_nan(p2, p3)),
                 min_nan(min_nan(p4, p5), min_nan(p6, p7)));
  far = max_nan(max_nan(max_nan(p0, p1), max_nan(p2, p3)),
                max_nan(max_nan(p4, p5), max_nan(p6, p7)));
}

// Whether no ray of the bundle can pass slab_nan on the box (cluster.cu,
// header): the greatest t_far any of them could have lies below the least
// t_near.  A NaN anywhere gives false: no cull.
__host__ __device__ __forceinline__ bool bundle_culls(const Box& b, const Bundle& B) {
  float nx, fx, ny, fy, nz, fz;
  bundle_axis(b.lo.x, b.hi.x, B.omin.x, B.omax.x, B.imin.x, B.imax.x, nx, fx);
  bundle_axis(b.lo.y, b.hi.y, B.omin.y, B.omax.y, B.imin.y, B.imax.y, ny, fy);
  bundle_axis(b.lo.z, b.hi.z, B.omin.z, B.omax.z, B.imin.z, B.imax.z, nz, fz);
  const float near = max_nan(max_nan(nx, ny), max_nan(nz, B.lo));
  const float far = min_nan(min_nan(fx, fy), min_nan(fz, B.hi));
  return far < near;
}

// Whether the bundle's tests are worth making: not where its inverse
// directions take both signs on every axis.  Then each axis's corner
// products take both signs, so its far bound lies above 0 and its near bound
// below, and the test could cull only a box whose far planes all lie before
// the least t_min: in practice never.  Skipping a cull changes no vote.
__host__ __device__ __forceinline__ bool bundle_useful(const Bundle& B) {
  return !(B.imin.x < 0.0f && B.imax.x > 0.0f && B.imin.y < 0.0f && B.imax.y > 0.0f &&
           B.imin.z < 0.0f && B.imax.z > 0.0f);
}

// The exact vote of one ray: the plain votes' slab test, torch's NaN rule
// kept.
__host__ __device__ __forceinline__ bool vote_passes(const Box& b, V3 o, V3 inv, float lo,
                                                     float hi) {
  return slab_nan(b.lo, b.hi, o, inv, lo, hi);
}

}  // namespace gst
