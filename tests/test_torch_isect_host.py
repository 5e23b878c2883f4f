"""PyTorch port: K2 (csrc/isect.cu, the brute-force closest and any hit)
compiled for the host with g++ behind a CUDA shim that runs a CTA's
threads at once, one std::thread a CUDA thread (`__syncthreads` a
std::barrier, `__syncthreads_or` an atomic between two barriers of the
CTA, the shared memory a buffer filled with non-zero bytes, so that a read
of an unstaged row shows), CTAs one after another, and held bit for bit to the plain versions closest_ref / any_ref
(ops/cuda_isect.py):

  * Cornell and the zoo cut at their `tri_rows` (36 and 90 of 128 slots)
    and a 2048-triangle soup (eight chunks), against the whole tables;
  * a table with trailing zero rows cut at its count, a count that is no
    multiple of the chunk or of the unroll with non-zero rows after it
    (against the plain versions on the cut), and a count of 0;
  * exact-t twins (the lowest id wins);
  * NaN, empty-interval and past-the-end lanes, whole warps dead, one live
    lane a warp, ~5% live lanes scattered, and an any hit whose warps have
    every lane occluded at their first test.

So the cut and the dead-lane skip change no output.  The kernels
themselves run on the card only (tests/test_torch_cuda.py).  Needs g++;
skips without it."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch import _build
from gpuspectral_tpu_torch.ops import cuda_isect as ci
from gpuspectral_tpu_torch.ops.woop import woop_transform
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import build_zoo

from chip_smoke import random_rays, warp_lanes
from torch_common import CORNELL_XML

_SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
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
inline thread_local Dim3 threadIdx, blockIdx;
inline Dim3 blockDim{1, 1, 1}, gridDim{1, 1, 1};
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

// one CTA: its barrier, and the accumulators of the votes, two used in
// turn (a vote's first reader may be a turn ahead of its last)
struct HostCta {
  explicit HostCta(int threads) : bar(threads) {}
  std::barrier<> bar;
  std::atomic<int> any[2] = {0, 0};
};
inline HostCta* host_cta = nullptr;
inline float4* host_smem = nullptr;
inline thread_local int host_or_turn = 0;

inline void __syncthreads() { host_cta->bar.arrive_and_wait(); }
inline bool __syncthreads_or(bool p) {
  const int k = host_or_turn++ & 1;
  if (p) host_cta->any[k].store(1);
  host_cta->bar.arrive_and_wait();
  const bool r = host_cta->any[k].load() != 0;
  host_cta->bar.arrive_and_wait();
  if (threadIdx.x == 0) host_cta->any[k].store(0);
  return r;
}

// kernel<<<grid, block, smem, stream>>>(args...): the CTAs in turn, each
// CTA's threads at once
template <class K, class... A>
void host_launch(K kernel, int grid, int block, size_t smem, cudaStream_t, A... args) {
  blockDim.x = block;
  gridDim.x = grid;
  std::vector<float4> mem(smem / sizeof(float4) + 1);
  for (int b = 0; b < grid; ++b) {
    std::memset(mem.data(), 0x3e, mem.size() * sizeof(float4));
    HostCta cta(block);
    host_cta = &cta;
    host_smem = mem.data();
    std::vector<std::thread> threads;
    for (int i = 0; i < block; ++i) {
      threads.emplace_back([&, i, b] {
        threadIdx.x = i;
        blockIdx.x = b;
        kernel(args...);
      });
    }
    for (auto& t : threads) t.join();
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile K2 for the host")
    d = tmp_path_factory.mktemp("isect_host")
    for src in ("isect.cu", "brute.cuh", "common.cuh"):
        text = (_build._CSRC / src).read_text()
        # the launch syntax and the dynamic shared memory, which g++ does not parse
        text, n = re.subn(r"(\w+)<<<([^>]*)>>>\(", r"host_launch(\1, \2, ", text)
        assert n == (src != "common.cuh")
        text, n = re.subn(r"extern __shared__ float4 (\w+)\[\];", r"float4* const \1 = host_smem;",
                          text)
        assert n == (2 if src == "isect.cu" else 0)
        (d / (src.replace(".cu", ".cpp") if src.endswith(".cu") else src)).write_text(text)
    (d / "cuda_runtime.h").write_text(_SHIM)
    so = d / "libisect_host.so"
    # -fno-gnu-unique: the shim's inline globals (blockDim, threadIdx) stay
    # this library's own, not shared with another host build loaded in the
    # same process (tests/test_torch_brute_host.py's shim)
    subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fno-gnu-unique", "-pthread",
                    "-shared", "-fPIC", "-I", str(d), str(d / "isect.cpp"), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("gst_closest", "gst_any"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _p(x):
    return ctypes.c_void_p(x.data_ptr())


def _k2(lib, woop_t, rays, n_rows):
    """(t, prim, occ) of the compiled K2a / K2b: closest on (t_min, t_max),
    any on the same segments."""
    o, d, lo, hi = rays
    r = o.shape[0]
    t = torch.full((r,), np.nan, dtype=torch.float32)
    prim = torch.full((r,), -7, dtype=torch.int32)
    occ = torch.ones((r,), dtype=torch.bool)
    args = (_p(o), _p(d), _p(woop_t), woop_t.shape[1], n_rows, _p(lo), _p(hi), r)
    assert lib.gst_closest(*args, _p(t), _p(prim), None) == 0
    assert lib.gst_any(*args, _p(occ), None) == 0
    return t, prim, occ


def _plain(woop_t, rays, n_rows=None):
    return (*ci.closest_ref(*rays[:2], woop_t, *rays[2:], n_rows=n_rows),
            ci.any_ref(*rays[:2], woop_t, *rays[2:], n_rows=n_rows))


def _assert_equal(got, want):
    for name, a, b in zip(("t", "prim", "occ"), got, want):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} lanes differ"


def _soup(n, seed, twins=False):
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-2.0, 2.0, size=(n, 1, 3))
            + rng.normal(scale=0.15, size=(n, 3, 3))).astype(np.float32)
    if twins:  # exact-t ties, which the lowest index wins
        tris[n // 2:] = tris[:n - n // 2]
    return tris


def _table(tris, slots):
    """The (12, slots) table of the triangles, zero columns after them."""
    w = np.zeros((12, slots), np.float32)
    w[:, :tris.shape[0]] = woop_transform(tris).T
    return torch.as_tensor(w)


def _rays(n, seed, lo=-2.5, hi=2.5):
    return random_rays(n, lo, hi, seed, "cpu")


@pytest.fixture(scope="module")
def scenes():
    return dict(cornell=load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0],
                zoo=build_zoo("cpu"))


@pytest.mark.parametrize("name,rows", [("cornell", 36), ("zoo", 90)])
def test_k2_scene_cut_at_its_rows_equals_the_plain_versions(lib, scenes, name, rows):
    scene = scenes[name]
    assert scene.tri_rows == rows and scene.tri_woop_t.shape[1] == 128
    rays = _rays(2001, 5, -1.2, 2.2)  # 2001: a CTA's past-the-end lanes
    for tag, lanes in warp_lanes(rays).items():
        want = _plain(scene.tri_woop_t, lanes)  # every slot
        assert int((want[1] >= 0).sum()) > 0 and int(want[2].sum()) > 0, tag
        _assert_equal(_k2(lib, scene.tri_woop_t, lanes, scene.tri_rows), want)


def test_k2_soup2048_equals_the_plain_versions(lib):
    w = _table(_soup(2048, 1), 2048)
    rays = _rays(1500, 6)
    for tag, lanes in warp_lanes(rays).items():
        want = _plain(w, lanes)
        assert int((want[1] >= 0).sum()) > (100 if tag in ("clean", "odd") else 0), tag
        _assert_equal(_k2(lib, w, lanes, 2048), want)


@pytest.mark.parametrize("n_tris,slots,n_rows", [(300, 512, 300), (300, 512, 0),
                                                  (700, 768, 517), (700, 768, 3)],
                         ids=["trailing_zero_rows", "no_rows", "cut_off_the_chunk", "cut_3"])
def test_k2_cut_equals_the_plain_versions_on_the_cut(lib, n_tris, slots, n_rows):
    w = _table(_soup(n_tris, 2), slots)
    rays = _rays(1200, 7)
    for tag, lanes in warp_lanes(rays).items():
        got = _k2(lib, w, lanes, n_rows)
        _assert_equal(got, _plain(w, lanes, n_rows))
        if n_rows == n_tris:  # only zero rows cut: the whole table's results
            _assert_equal(got, _plain(w, lanes))
        elif n_rows == 0:
            assert bool((got[1] == -1).all()) and not bool(got[2].any())
    if 0 < n_rows < n_tris:  # the rows past the cut hold triangles: the cut shows
        full = _plain(w, rays)
        assert not torch.equal(got[1], full[1]) or not torch.equal(got[2], full[2])


def test_k2_exact_t_twins_lowest_id_wins(lib):
    tris = _soup(600, 3, twins=True)
    w = _table(tris, 640)
    rays = _rays(1500, 8)
    t, prim, occ = got = _k2(lib, w, rays, 600)
    _assert_equal(got, _plain(w, rays))
    hit = prim >= 0
    assert int(hit.sum()) > 100 and bool((prim[hit] < 300).all())  # the first copy wins


def test_k2_any_warps_occluded_at_their_first_test(lib):
    """A large triangle at slot 0 that every live ray crosses: each warp's
    lanes are all occluded at their first test and leave together; the
    closest hit still scans every row."""
    big = np.array([[[-50.0, -50.0, 0.0], [50.0, -50.0, 0.0], [0.0, 50.0, 0.0]]], np.float32)
    tris = np.concatenate([big, _soup(400, 4)])
    w = _table(tris, 512)
    rng = np.random.default_rng(9)
    n = 1000
    o = np.concatenate([rng.uniform(-3, 3, (n, 2)), np.full((n, 1), -4.0)], 1).astype(np.float32)
    d = np.concatenate([rng.normal(scale=0.2, size=(n, 2)), np.ones((n, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = [torch.as_tensor(x) for x in (o, d, np.zeros(n, np.float32),
                                         np.full(n, 1e30, np.float32))]
    for tag, lanes in warp_lanes(rays).items():
        want = _plain(w, lanes)
        if tag != "odd":  # (its NaN and zero-z directions miss the plane)
            assert bool(want[2][lanes[3] > lanes[2]].all()), tag
        _assert_equal(_k2(lib, w, lanes, 401), want)
