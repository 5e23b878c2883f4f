// Shared device code of the hand-written kernels: the counter-based RNG of
// ops/rng.py, float3 helpers in the reference's operand order, and the Woop
// unit-triangle test of ops/woop.py.
//
// Built with nvcc --fmad=false and without --use_fast_math: every multiply
// and add rounds on its own unless written as fmaf, and sqrtf / division are
// IEEE, as in PyTorch's own elementwise kernels.  The fmaf calls sit where
// the plain torch versions call m3.fma (the Woop test, the hit point, the
// next ray's origin).  The brute-force kernels then agree with the plain
// torch scans bit for bit (up to m3.fma's rare double rounding), and the
// megakernel with the torch wavefront up to op order and libm.
#pragma once

#include <cstdint>

namespace gst {

constexpr float kBig = 1e30f;
constexpr float kPi = 3.14159265358979323846f;

// ---------------------------------------------------------------- RNG ----
// gpuspectral_tpu/ops/rng.py: PCG-RXS-M-XS hash, TEA seed mix, counter draw.

__device__ __forceinline__ uint32_t pcg_hash(uint32_t v) {
  uint32_t state = v * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
  for (int i = 0; i < 4; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ uint32_t pixel_seed(uint32_t pixel, uint32_t ts) {
  return pcg_hash(tea(pixel, ts));
}

__device__ __forceinline__ uint32_t random_bits(uint32_t seed, uint32_t bounce,
                                                uint32_t channel) {
  return pcg_hash(seed ^ pcg_hash(bounce * 0x9E3779B9u + channel + 1u));
}

// bits * float32(1/0xffffffff), the conversion rounding to nearest as
// numpy's astype(float32) does
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t bounce,
                                         uint32_t channel) {
  return __uint2float_rn(random_bits(seed, bounce, channel)) *
         (float)(1.0 / 4294967295.0);
}

// ------------------------------------------------------------ vectors ----
struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
// ops/math3d.py length / normalize guards
__device__ __forceinline__ float length(V3 a) { return sqrtf(fmaxf(dot(a, a), 1e-24f)); }
__device__ __forceinline__ V3 normalize(V3 a) {
  float inv = 1.0f / fmaxf(length(a), 1e-12f);
  return scale(a, inv);
}
__device__ __forceinline__ float safe_inv(float x) { return 1.0f / fmaxf(x, 1e-12f); }

// ---------------------------------------------------------------- Woop ---
// One unit-triangle test (ops/woop.py, pallas_isect.py:39-58, op for op),
// its multiply-adds fused where XLA fuses them and where ops/woop.py calls
// m3.fma, on the triangle's 12 Woop floats.
__device__ __forceinline__ bool woop_eval(float ax0, float ax1, float ax2, float ay0, float ay1,
                                          float ay2, float az0, float az1, float az2, float bx,
                                          float by, float bz, V3 o, V3 d, float t_lo,
                                          float t_hi, float& t_out, float& u_out,
                                          float& v_out) {
  const float opz = fmaf(o.z, az2, fmaf(o.x, az0, o.y * az1)) + bz;
  const float dpz = fmaf(d.z, az2, fmaf(d.x, az0, d.y * az1));
  const bool live = fabsf(dpz) > 1e-12f;
  const float t = -opz / (live ? dpz : 1.0f);
  const float px = fmaf(t, d.x, o.x);
  const float py = fmaf(t, d.y, o.y);
  const float pz = fmaf(t, d.z, o.z);
  const float u = fmaf(pz, ax2, fmaf(px, ax0, py * ax1)) + bx;
  const float v = fmaf(pz, ay2, fmaf(px, ay0, py * ay1)) + by;
  t_out = t;
  u_out = u;
  v_out = v;
  return live && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > t_lo) && (t < t_hi);
}

// woop_test of the triangle whose 12 rows w points at, `stride` floats apart.
__device__ __forceinline__ bool woop_test(const float* w, int stride, V3 o, V3 d,
                                          float t_lo, float t_hi, float& t_out,
                                          float& u_out, float& v_out) {
  return woop_eval(w[0 * stride], w[1 * stride], w[2 * stride], w[3 * stride], w[4 * stride],
                   w[5 * stride], w[6 * stride], w[7 * stride], w[8 * stride], w[9 * stride],
                   w[10 * stride], w[11 * stride], o, d, t_lo, t_hi, t_out, u_out, v_out);
}

// ------------------------------------------------ block-gated sweeps ---
// The slab tests of the votes: K7c (csrc/cluster.cu), the bin votes of
// K7a / K7b (binned.cu) and K7f / K7g's node votes (dfs.cu) take the
// NaN-keeping slab test, K7h (traverse.cu) its min / max; K7d / K7e take
// load3 only.  These four are host functions too, so that the CPU tests
// can compile K7c's tests (cluster_votes.cuh) with g++.

// math3d.safe_div(1, dx) with torch's NaN rule: |dx| clamped to 1e-12 with
// its sign, a NaN component kept NaN (fmaxf would drop it, giving
// 1e12).
__host__ __device__ __forceinline__ float inv_dir_nan(float dx) {
  const float a = fabsf(dx);
  const float mag = a < 1e-12f ? 1e-12f : a;
  return 1.0f / (dx < 0.0f ? -mag : mag);
}

// torch.minimum / torch.maximum: NaN if either operand is NaN (fminf and
// fmaxf drop it)
__host__ __device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a || b != b ? a + b : (b < a ? b : a);
#endif
}

__host__ __device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a || b != b ? a + b : (a < b ? b : a);
#endif
}

// The slab test of the box [bl, bh] on the segment [lo, hi] as the plain
// torch votes compute it (no widening), torch's NaN rule kept: with
// inv = inv_dir_nan(d), a NaN in the ray's origin, direction or segment
// ends makes t_near or t_far NaN, and the test fails, as on the CPU.
__host__ __device__ __forceinline__ bool slab_nan(V3 bl, V3 bh, V3 o, V3 inv, float lo,
                                                  float hi) {
  const float t0x = (bl.x - o.x) * inv.x;
  const float t1x = (bh.x - o.x) * inv.x;
  const float t0y = (bl.y - o.y) * inv.y;
  const float t1y = (bh.y - o.y) * inv.y;
  const float t0z = (bl.z - o.z) * inv.z;
  const float t1z = (bh.z - o.z) * inv.z;
  const float t_near =
      max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), max_nan(min_nan(t0z, t1z), lo));
  const float t_far =
      min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), min_nan(max_nan(t0z, t1z), hi));
  return t_far >= t_near;
}

// Ray r's xyz of an (R, 3) array, or `fill` for a padding thread past the
// last ray.
__device__ __forceinline__ V3 load3(const float* p, int r, bool live, float fill) {
  return live ? V3{p[3 * r], p[3 * r + 1], p[3 * r + 2]} : V3{fill, fill, fill};
}

}  // namespace gst
