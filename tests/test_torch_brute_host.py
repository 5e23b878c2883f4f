"""PyTorch port: the device code of K1 / K5 (csrc/bounce.cuh, brute.cuh,
grad.cuh) compiled for the host with g++ behind a small CUDA shim (one
thread at a time, so a warp vote or an atomic is the thread's own), and
held to itself under the schedules the kernels may take:

  * a thread that takes its next pixel lane from the counter
    (LaneCounter: 1 thread, 77 threads, more threads than lanes) gives every
    lane the sums, ray counts and gradient partials of the one-lane
    schedule (OneLane), bit for bit;
  * K5's partials added in shared memory and written out per lane
    (GradHookT<true>) equal those added in device memory (GradHookT<false>,
    K6's), bit for bit;
  * the staged float4 rows and the unrolled loop (BruteIsect) give the
    plain torch scans' closest hits and occlusion (ops/cuda_isect.py), ties
    and odd rays included.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
Needs g++; skips without it."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch import _build
from gpuspectral_tpu_torch.integrator import mega, mega_grad as mg
from gpuspectral_tpu_torch.ops import cuda_isect as ci
from gpuspectral_tpu_torch.ops.woop import woop_transform
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import build_zoo
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import CORNELL_XML

_SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
using std::max;
using std::min;
using std::isfinite;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint2float_rn(uint32_t u) { return (float)u; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline Dim3 threadIdx, blockDim{1, 1, 1};
inline void __syncthreads() {}
inline bool __syncthreads_and(bool p) { return p; }
inline unsigned __activemask() { return 1u; }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
inline int atomicAdd(int* p, int v) { const int o = *p; *p += v; return o; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaFuncSetAttribute(...) { return 0; }
inline int cudaGetDevice(int*) { return 0; }
inline int cudaDeviceGetAttribute(...) { return 0; }
inline int cudaMemsetAsync(...) { return 0; }
inline int cudaGetLastError() { return 0; }
template <class F> inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t) {
  return 0;
}
template <class F, class... A> inline void host_launch(F, A...) {}
"""

_HOST_CODE = r"""
#include "cuda_runtime.h"
#include "bounce.cuh"
#include "brute.cuh"
#include "grad.cuh"
#include <vector>
using namespace gst;

// K1 (grad 0) or K5 (grad 1) over n_lanes lanes: threads == 0 runs each lane
// on its own (OneLane, K5's partials in device memory); threads > 0 runs
// that many threads one after another, each taking further lanes from the
// counter (LaneCounter), K5's partials in shared memory if shared.
extern "C" void run_lanes(const int* pix, int n_lanes, const float* woop, int n_tris,
                          const float* attr, const float* light, const float* cam,
                          const float* env, const int* ip, const float* fp, float* rr, float* rg,
                          float* rb, int* rays, int threads, int grad, int shared,
                          const int* rows, const float* kd, int n_rows, int n_gl, float* parts) {
  const Params P = make_params(ip, fp);
  const Tables T{attr, light, nullptr, nullptr, cam, make_env(env, ip)};
  const int n_pad = brute_pad(n_tris);
  std::vector<float4> sw(3 * n_pad);
  stage_woop_rows(sw.data(), reinterpret_cast<const float4*>(woop), n_tris, n_pad);
  const BruteIsect isect{sw.data(), n_pad};
  // a column of shared partials that starts dirty: the hook must zero it
  std::vector<float> block(3 * n_rows + 6 * n_gl + 1, 12345.0f);
  const int col = P.attr_stride - 1;
  if (threads == 0) {
    for (int lane = 0; lane < n_lanes; ++lane) {
      if (grad) {
        render_lane<BruteIsect, false>(isect, T, P, lane, n_lanes, pix, rr, rg, rb, rays,
                                       make_grad_hook(parts, rows, kd, n_lanes, lane, n_rows,
                                                      n_gl, col));
      } else {
        render_lane<BruteIsect, false>(isect, T, P, lane, n_lanes, pix, rr, rg, rb, rays);
      }
    }
    return;
  }
  int next = 0;
  for (int th = 0; th < threads; ++th) {
    const LaneCounter lanes{&next, threads};
    if (grad && shared) {
      render_lane<BruteIsect, false>(
          isect, T, P, th, n_lanes, pix, rr, rg, rb, rays,
          make_grad_hook<true>(parts, rows, kd, n_lanes, th, n_rows, n_gl, col, block.data()),
          lanes);
    } else if (grad) {
      render_lane<BruteIsect, false>(
          isect, T, P, th, n_lanes, pix, rr, rg, rb, rays,
          make_grad_hook(parts, rows, kd, n_lanes, th, n_rows, n_gl, col), lanes);
    } else {
      render_lane<BruteIsect, false>(isect, T, P, th, n_lanes, pix, rr, rg, rb, rays, NoHook(),
                                     lanes);
    }
  }
}

// BruteIsect alone: closest (t, prim) on (0, 1e30) and any on (lo, hi).
extern "C" void brute_rays(const float* woop, int n_tris, const float* o, const float* d,
                           const float* lo, const float* hi, int n, float* t, int* prim,
                           int* occ) {
  const int n_pad = brute_pad(n_tris);
  std::vector<float4> sw(3 * n_pad);
  stage_woop_rows(sw.data(), reinterpret_cast<const float4*>(woop), n_tris, n_pad);
  const BruteIsect isect{sw.data(), n_pad};
  for (int r = 0; r < n; ++r) {
    const V3 oo = v3(o[3 * r], o[3 * r + 1], o[3 * r + 2]);
    const V3 dd = v3(d[3 * r], d[3 * r + 1], d[3 * r + 2]);
    float u, v;
    isect.closest(oo, dd, t[r], prim[r], u, v);
    occ[r] = isect.any(oo, dd, lo[r], hi[r]);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the device headers for the host")
    d = tmp_path_factory.mktemp("brute_host")
    for src in ("bounce.cuh", "brute.cuh", "grad.cuh", "common.cuh"):
        text = (_build._CSRC / src).read_text()
        if src == "brute.cuh":  # the launch syntax g++ does not parse
            text, n = re.subn(r"(\w+)<<<[^>]*>>>\(", r"host_launch(\1, ", text)
            assert n == 1
        (d / src).write_text(text)
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "host_lanes.cpp").write_text(_HOST_CODE)
    so = d / "libbrute_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(d), str(d / "host_lanes.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _lanes(lib, scene, cfg, pix, threads, grad, shared=False):
    woop = mega.woop_rows(scene).numpy()
    _, attr, light, cam = mega._pack_tables(scene)
    if grad:
        attr = torch.cat([attr, scene.tri_bsdf[:, None].to(torch.float32)], 1).contiguous()
    attr, light, cam = attr.numpy(), light.numpy(), cam.numpy()
    env = mega.pack_env(scene).numpy()
    ip, fp = mega.kernel_params(scene, cfg, 7, attr_stride=attr.shape[1])
    b, n_l = scene.bsdf_kind.shape[0], scene.num_lights
    rows = np.arange(b, dtype=np.int32)
    kd = scene.bsdf_params[:, 0:3].contiguous().numpy()
    n = pix.size
    out = [np.full(n, np.nan, np.float32) for _ in range(3)] + [np.full(n, -1, np.int32)]
    parts = np.zeros((3 * b + 6 * n_l, n), np.float32)
    lib.run_lanes(_p(pix), ctypes.c_int(n), _p(woop), ctypes.c_int(scene.num_tris), _p(attr),
                  _p(light), _p(cam), _p(env), _p(ip), _p(fp), *map(_p, out),
                  ctypes.c_int(threads), ctypes.c_int(int(grad)), ctypes.c_int(int(shared)),
                  _p(rows), _p(kd), ctypes.c_int(b), ctypes.c_int(n_l), _p(parts))
    return out + ([parts] if grad else [])


@pytest.fixture(scope="module")
def scenes():
    return dict(cornell=load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0],
                zoo=build_zoo("cpu"))


@pytest.mark.parametrize("name,grad", [("cornell", False), ("cornell", True), ("zoo", False)],
                         ids=["k1_cornell", "k5_cornell", "k1_zoo"])
def test_lane_counter_equals_one_lane(lib, scenes, name, grad):
    scene = scenes[name]
    cfg = RenderConfig(width=24, height=24, spp=4 if grad else 8, max_depth=5 if grad else 50)
    assert mg.mega_grad_eligible(scene, cfg) or not grad
    pix = mega.pix_rows(cfg, "cpu").numpy().reshape(-1).copy()  # 4.5 rows: padding lanes
    ref = _lanes(lib, scene, cfg, pix, 0, grad)
    assert np.isfinite(ref[0]).all() and (ref[3] > 0).all()
    if grad:
        assert np.abs(ref[4]).max() > 0
    for threads in (1, 77, pix.size + 40):
        for shared in ((False, True) if grad else (False,)):
            got = _lanes(lib, scene, cfg, pix, threads, grad, shared)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


def _soup(rng, n, twins=False):
    tris = rng.uniform(-2, 2, (n, 1, 3)) + rng.normal(scale=0.4, size=(n, 3, 3))
    tris = tris.astype(np.float32)
    if twins:  # exact-t ties, which the lowest index wins
        tris[n // 2:] = tris[:n - n // 2]
    return tris


@pytest.mark.parametrize("case", ["soup", "twins", "one_triangle", "limit"])
def test_brute_rows_equal_the_plain_scans(lib, case):
    rng = np.random.default_rng(3)
    n_tris = dict(soup=300, twins=200, one_triangle=1, limit=2048)[case]
    tris = _soup(rng, n_tris, twins=case == "twins")
    rows = np.ascontiguousarray(woop_transform(tris).astype(np.float32))
    m = 1500 if case != "limit" else 400
    target = (tris[rng.integers(0, n_tris, m)] * rng.dirichlet([1, 1, 1], m)[:, :, None]).sum(1)
    o = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d[::5] *= np.float32(1e-12)  # |dpz| near woop_eval's 1e-12 cut
    o[3::17, 1] = np.nan
    lo = rng.choice(np.array([0.0, 1e-4, -1.0, 0.5], np.float32), m)
    hi = rng.choice(np.array([1e30, 2.0, 0.0, np.inf, 1e-30], np.float32), m)
    t = np.zeros(m, np.float32)
    prim, occ = np.zeros(m, np.int32), np.zeros(m, np.int32)
    lib.brute_rays(_p(rows), ctypes.c_int(n_tris), _p(o), _p(d), _p(lo), _p(hi), ctypes.c_int(m),
                   _p(t), _p(prim), _p(occ))
    tab = torch.as_tensor(np.ascontiguousarray(rows.T))
    t_r, prim_r = ci.closest_ref(torch.as_tensor(o), torch.as_tensor(d), tab,
                                 torch.zeros(m), torch.full((m,), 1e30))
    occ_r = ci.any_ref(torch.as_tensor(o), torch.as_tensor(d), tab, torch.as_tensor(lo),
                       torch.as_tensor(hi))
    assert int((prim >= 0).sum()) > m // 3 and int(occ.sum()) > 0
    # the same fused operations in the same order: equal up to the plain
    # scans' rare double rounding in m3.fma (tests/test_torch_cuda.py's K2 rule)
    assert int((prim != prim_r.numpy()).sum()) <= 2
    hit = (prim == prim_r.numpy()) & (prim >= 0)
    np.testing.assert_array_equal(t[hit], t_r.numpy()[hit])
    assert int((occ != occ_r.numpy().astype(np.int32)).sum()) <= 2
