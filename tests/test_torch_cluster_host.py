"""PyTorch port: K7c's two tests (csrc/cluster_votes.cuh: a warp's bundle
cull and a lane's exact vote) compiled for the host with g++ behind a small
CUDA shim, run over K7c's schedule one warp of 32 rays at a time, and held
to the plain votes and to their torch copies:

  * the exact vote equals the plain slab test of cluster_votes_ref, ray by
    ray and box by box, and the live rays equal cluster_sweep.live_rays;
  * the cull is sound: no (warp, supernode) it culls holds a ray that
    passes, so the schedule's votes (a warp with no live ray skipped, the
    OR over the block's warps of a supernode not culled and passed) equal
    cluster_votes_ref;
  * cluster_sweep.bundle_culls (the torch copy) culls exactly what the
    compiled cull does, and cluster_sweep.bundle_vote_tests counts the
    compiled schedule's bundle and exact tests and gives its votes.

On NaN and inactive lanes, warps of 0, 1 and 32 live rays, a few live rays
scattered among inactive ones, parallel rays from nearby origins, mixed-sign and
+-0 direction components, rays that graze a box's face or end exactly on
one, t_min = t_max, coherent camera rays and 1, 31, 33, 257 and 65,537
rays.  The kernel itself runs on the card only (tests/test_torch_cuda.py).
Needs g++; skips without it."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch import _build
from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

from chip_smoke import field_rays, odd_lanes, primary_rays, soup_scene, sparse_lanes
from torch_common import CORNELL_XML

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstdint>
using std::isfinite;
#define __device__
#define __host__
#define __forceinline__ inline
inline float __uint2float_rn(uint32_t u) { return (float)u; }
"""

_HOST_CODE = r"""
#include "cuda_runtime.h"
#include "cluster_votes.cuh"
#include <vector>
using namespace gst;

// K7c's schedule (csrc/cluster.cu), one warp of 32 rays at a time: each
// ray's live flag and exact vote on each supernode; each warp's bundle cull
// of each supernode (1 for a warp with no live ray); whether the warp makes
// the bundle tests; and, as the kernel
// takes them, each warp's exact tests and votes on each supernode: a warp
// of k live rays takes the supernodes 32 at a time, keeps those its bundle
// does not cull (all of them for k <= direct or a bundle whose inverse
// directions take both signs on every axis), and tests the kept ones
// against each live ray where they are at most k, else each live ray
// against every supernode of the step.  Rays past the last are padding
// lanes, as in the kernel: o 0, d 1, segment [0, -1e30].
extern "C" void warp_tests(const float* o, const float* d, const float* lo, const float* hi,
                           int n, const float* blo, const float* bhi, int sp, int n_super,
                           int direct, unsigned char* live, unsigned char* passes,
                           unsigned char* culled, unsigned char* bundled, int* exact,
                           unsigned char* votes) {
  auto box = [&](int s) {
    return Box{{blo[s], blo[sp + s], blo[2 * sp + s]}, {bhi[s], bhi[sp + s], bhi[2 * sp + s]}};
  };
  for (int w = 0; w < (n + 31) / 32; ++w) {
    Bundle bundle = ray_bundle({0, 0, 0}, {0, 0, 0}, 0.0f, 0.0f, false);
    std::vector<int> rays;
    std::vector<V3> os(32), invs(32);
    std::vector<float> los(32), his(32);
    for (int lane = 0; lane < 32; ++lane) {
      const int r = 32 * w + lane;
      const bool in = r < n;
      os[lane] = in ? V3{o[3 * r], o[3 * r + 1], o[3 * r + 2]} : V3{0, 0, 0};
      const V3 rd = in ? V3{d[3 * r], d[3 * r + 1], d[3 * r + 2]} : V3{1, 1, 1};
      invs[lane] = V3{inv_dir_nan(rd.x), inv_dir_nan(rd.y), inv_dir_nan(rd.z)};
      los[lane] = in ? lo[r] : 0.0f;
      his[lane] = in ? hi[r] : -kBig;
      const bool lv = live_ray(os[lane], invs[lane], los[lane], his[lane]);
      bundle = merge(bundle, ray_bundle(os[lane], invs[lane], los[lane], his[lane], lv));
      if (lv) rays.push_back(lane);
      if (!in) continue;
      live[r] = lv;
      for (int s = 0; s < n_super; ++s)
        passes[(size_t)r * n_super + s] = vote_passes(box(s), os[lane], invs[lane], los[lane],
                                                      his[lane]);
    }
    const int k = (int)rays.size();
    const bool cull = k > direct && bundle_useful(bundle);
    bundled[w] = cull;
    for (int s = 0; s < n_super; ++s)
      culled[(size_t)w * n_super + s] = k == 0 || bundle_culls(box(s), bundle);
    if (k == 0) continue;
    for (int s0 = 0; s0 < n_super; s0 += 32) {
      const int s1 = s0 + 32 < n_super ? s0 + 32 : n_super;
      int n_kept = 0;
      for (int s = s0; s < s1; ++s) n_kept += !cull || !culled[(size_t)w * n_super + s];
      for (int s = s0; s < s1; ++s) {
        const bool keep = !cull || !culled[(size_t)w * n_super + s];
        if (n_kept <= k && !keep) continue;
        exact[(size_t)w * n_super + s] = k;
        bool vote = false;
        for (int lane : rays) vote = vote || vote_passes(box(s), os[lane], invs[lane], los[lane],
                                                        his[lane]);
        votes[(size_t)w * n_super + s] = keep && vote;
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile K7c's tests for the host")
    d = tmp_path_factory.mktemp("cluster_host")
    for src in ("cluster_votes.cuh", "common.cuh"):
        (d / src).write_text((_build._CSRC / src).read_text())
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "host_votes.cpp").write_text(_HOST_CODE)
    so = d / "libcluster_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(d), str(d / "host_votes.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def scenes():
    return dict(cornell=load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0],
                soup=soup_scene(3000, 5, "cpu"),
                field=build_sphere_field("cpu", n_side=2, segs=16, rings=8))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _warp_tests(lib, sn, o, d, lo, hi):
    """(live (R,), passes (R, S), culled (W, S), bundled (W,), exact (W, S),
    votes (W, S)) of the compiled schedule."""
    r = o.shape[0]
    w = -(-r // 32)
    live = torch.zeros((r,), dtype=torch.uint8)
    passes = torch.zeros((r, sn.s), dtype=torch.uint8)
    culled = torch.zeros((w, sn.s), dtype=torch.uint8)
    bundled = torch.zeros((w,), dtype=torch.uint8)
    exact = torch.zeros((w, sn.s), dtype=torch.int32)
    votes = torch.zeros((w, sn.s), dtype=torch.uint8)
    lib.warp_tests(_p(o), _p(d), _p(lo), _p(hi), ctypes.c_int(r), _p(sn.blo), _p(sn.bhi),
                   ctypes.c_int(sn.blo.shape[1]), ctypes.c_int(sn.s), ctypes.c_int(cs.DIRECT),
                   _p(live), _p(passes), _p(culled), _p(bundled), _p(exact), _p(votes))
    return (live.bool(), passes.bool(), culled.bool(), bundled.to(torch.int64),
            exact.to(torch.int64), votes.bool())


def _graze(scene, sn, n, seed):
    """Axis-aligned rays that start on a supernode box's plane and run along
    it (a zero direction component, +0 or -0), or run toward a face and end
    exactly on it (t_max the face's own rounded t), or start just past it."""
    rng = np.random.default_rng(seed)
    lo, hi = sn.blo[:, :sn.s].numpy(), sn.bhi[:, :sn.s].numpy()
    s = rng.integers(0, sn.s, n)
    ax = rng.integers(0, 3, n)
    o = (lo[:, s] + rng.uniform(0, 1, (3, n)).astype(np.float32) * (hi[:, s] - lo[:, s])).T.copy()
    d = np.zeros((n, 3), np.float32)
    sign = rng.choice(np.array([-1.0, 1.0], np.float32), n)
    i = np.arange(n)
    face = np.where(sign > 0, lo[ax, s], hi[ax, s]).astype(np.float32)
    o[i, ax] = face - sign * rng.choice(np.array([2.0, 0.5, 0.0, -1e-3], np.float32), n)
    d[i, ax] = sign
    along = rng.uniform(size=n) < 0.3  # on a face's plane, running along it
    other = (ax + 1) % 3
    d[along] = 0.0
    d[along, other[along]] = 1.0
    neg = along & (rng.uniform(size=n) < 0.5)
    d[neg, ax[neg]] = -0.0
    o[along, ax[along]] = face[along]
    with np.errstate(divide="ignore", invalid="ignore"):  # the rays along a plane
        t_face = ((face - o[i, ax]) * (np.float32(1.0) / d[i, ax])).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.5, t_face, np.float32(1e30)).astype(np.float32)
    t_max[along] = 1e30
    t_min = np.zeros(n, np.float32)
    return [torch.as_tensor(x) for x in (o, d, t_min, t_max)]


def _mixed(scene, n, seed):
    """Random rays whose warps mix the signs of every direction component,
    with +0 and -0 components."""
    o, d, lo, hi = field_rays(n, scene, seed, "cpu")
    d[0::7, 0] = 0.0
    d[1::7, 0] = -0.0
    d[2::5, 1] = -0.0
    d[3::11, 2] = 0.0
    return o, d, lo, hi


def _live_0_1_32(scene):
    """Three warps: no live ray, one, all 32."""
    o, d, lo, hi = field_rays(96, scene, 4, "cpu")
    hi[:32] = -1e30
    hi[32:63] = -1e30
    return o, d, lo, hi


def _parallel(scene, n, seed):
    """Rays of one direction from origins on a small jittered grid, with a
    few directions' worth of warps: bundles of distinct origins whose
    direction range is narrow."""
    rng = np.random.default_rng(seed)
    lo = scene.bvh_node_min[0].numpy() - 0.5
    hi = scene.bvh_node_max[0].numpy() + 0.5
    k = n // 32
    base = rng.uniform(lo, hi, (k, 1, 3)).astype(np.float32)
    o = (base + rng.uniform(-0.05, 0.05, (k, 32, 3))).reshape(-1, 3).astype(np.float32)
    d = rng.normal(size=(k, 1, 3)) + rng.normal(scale=1e-3, size=(k, 32, 3))
    d = (d / np.linalg.norm(d, axis=2, keepdims=True)).reshape(-1, 3).astype(np.float32)
    t_min = np.zeros(k * 32, np.float32)
    t_max = rng.choice(np.array([1e30, 1.0, 3.0], np.float32), k * 32)
    return [torch.as_tensor(x) for x in (o, d, t_min, t_max)]


CASES = {
    "sparse_live": ("field", lambda sc, sn: sparse_lanes(field_rays(4000, sc, 8, "cpu"))),
    "parallel_rays": ("soup", lambda sc, sn: _parallel(sc, 1024, 9)),
    "odd_lanes": ("field", lambda sc, sn: odd_lanes(field_rays(2000, sc, 1, "cpu"))),
    "live_0_1_32": ("field", lambda sc, sn: _live_0_1_32(sc)),
    "mixed_signs_zeros": ("soup", lambda sc, sn: _mixed(sc, 700, 2)),
    "graze_faces": ("field", lambda sc, sn: _graze(sc, sn, 900, 3)),
    "t_min_eq_t_max": ("soup", lambda sc, sn: (lambda r: (r[0], r[1], r[2], r[2].clone()))(
        field_rays(500, sc, 5, "cpu"))),
    "camera_rays": ("field", lambda sc, sn: primary_rays(sc, 48, "cpu")),
    "cornell": ("cornell", lambda sc, sn: odd_lanes(field_rays(300, sc, 6, "cpu"))),
    **{f"r{n}": ("field", (lambda n: lambda sc, sn: odd_lanes(field_rays(n, sc, 7, "cpu")))(n))
       for n in (1, 31, 33, 257, 65537)},
}


def test_direct_is_the_kernels():
    """cluster_sweep.DIRECT, which the counts take, is csrc/cluster.cu's kDirect."""
    text = (_build._CSRC / "cluster.cu").read_text()
    assert re.search(r"constexpr int kDirect = (\d+);", text).group(1) == str(cs.DIRECT)


@pytest.mark.parametrize("case", list(CASES))
def test_cull_is_sound_and_the_schedule_gives_the_plain_votes(lib, scenes, case):
    name, make = CASES[case]
    scene = scenes[name]
    sn = cs.scene_supernodes(scene)
    o, d, lo, hi = (x.contiguous() for x in make(scene, sn))
    r = o.shape[0]
    live, passes, culled, bundled, exact, warp_votes = _warp_tests(lib, sn, o, d, lo, hi)
    # the exact vote is the plain slab test, the live rays are live_rays
    ref_pass = torch.cat([h.reshape(-1, sn.s) for _, h in cs._slab_blocks(sn, o, d, lo, hi)])[:r]
    assert torch.equal(passes, ref_pass)
    inv = cs.inv_dir_nan(d)
    assert torch.equal(live, cs.live_rays(o, inv, lo, hi))
    assert not bool((passes & ~live[:, None]).any())
    # sound: a culled (warp, supernode) holds no ray that passes
    pad = -r % 32
    warp_pass = torch.cat([passes, passes.new_zeros((pad, sn.s))]).reshape(-1, 32, sn.s).any(1)
    assert not bool((culled & warp_pass).any())
    # the torch copy culls what the compiled cull does, warp by warp
    bundles = cs.warp_bundles(o, inv, lo, hi, live)
    n_live = torch.cat([live, live.new_zeros(pad)]).reshape(-1, 32).sum(1)
    torch_culled = cs.bundle_culls(sn.blo[:, :sn.s], sn.bhi[:, :sn.s], bundles)
    assert torch.equal(culled[n_live > 0], torch_culled[n_live > 0])
    # the schedule's votes are the plain votes; bundle_vote_tests counts its
    # tests and gives its votes
    blocks = -(-r // cs.BLOCK)
    per = cs.BLOCK // 32
    wpad = blocks * per - culled.shape[0]

    def by_block(x):
        return torch.cat([x, x.new_zeros((wpad, *x.shape[1:]))]).reshape(blocks, per, *x.shape[1:])

    ref = cs.cluster_votes_ref(scene, o, d, lo, hi, supernodes=sn)
    assert torch.equal(by_block(warp_votes).any(1).to(torch.int32), ref)
    bt = cs.bundle_vote_tests(scene, o, d, lo, hi, supernodes=sn)
    assert torch.equal(bt.votes, ref)
    lanes = by_block(n_live)
    assert torch.equal(bt.skipped, (lanes == 0).sum(1))
    assert torch.equal(bt.bundle, by_block(bundled).sum(1, keepdim=True).expand(-1, sn.s))
    assert torch.equal(bt.exact, by_block(exact).sum(1))
    # what each case is there for
    share = float(culled[n_live > 0].float().mean()) if bool((n_live > 0).any()) else 0.0
    if case == "live_0_1_32":
        assert n_live.tolist() == [0, 1, 32] and bool(culled[0].all())
        assert int(bt.skipped[0]) == per - 2 and int(exact[0].sum()) == 0
    if case in ("camera_rays", "parallel_rays", "sparse_live"):
        assert share > 0.5  # tight bundles: adjacent pixels, parallel rays, few live rays
    if case in ("camera_rays", "parallel_rays"):
        assert bool((bundled == 1).all())
    if case == "mixed_signs_zeros":  # 32 random directions take both signs on every axis
        assert int(bundled.sum()) == 0
    if case == "graze_faces":
        assert int(ref.sum()) > 0 and int(ref_pass.sum()) > r // 4
    if case == "t_min_eq_t_max":
        assert bool(live.all()) and int(ref.sum()) > 0
    if case in ("odd_lanes", "r65537"):
        assert 0 < int((~live).sum()) < r
