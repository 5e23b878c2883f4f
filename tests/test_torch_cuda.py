"""PyTorch port on an NVIDIA GPU: each hand-written CUDA kernel against its
plain PyTorch version on the same CUDA tensors.  Every test here needs the
card (a CUDA kernel has no interpret mode) and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch.bvh import binned as tb
from gpuspectral_tpu_torch.bvh import build as bvh_build
from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
from gpuspectral_tpu_torch.bvh import dfs_sweep as ds
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.bvh import kernels as tk
from gpuspectral_tpu_torch.bvh import traverse as ttr
from gpuspectral_tpu_torch.bsdf.table import diffuse
from gpuspectral_tpu_torch.integrator import mega, mega_bvh
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.integrator import render_image_stats_auto
from gpuspectral_tpu_torch.ops import cuda_isect as ci
from gpuspectral_tpu_torch.ops.woop import woop_transform
from gpuspectral_tpu_torch.scene import data as tdata
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field, build_zoo
from gpuspectral_tpu_torch.utils import RenderConfig

from chip_smoke import odd_lanes, warp_lanes
from torch_common import (CORNELL_XML, assert_mega_gates, cuda_device,  # noqa: F401
                          env_box, launches, mixed_bsdf_scene, sky, textured_diffuse_scene,
                          textured_floor)

pytestmark = pytest.mark.cuda


def _scene(name, dev):
    if name == "zoo":
        return build_zoo(dev)
    if name == "sphere_field":
        return build_sphere_field(dev, n_side=2, segs=16, rings=8)
    if name == "env_const":
        return env_box(tdata.SceneBuilder(), True).build(dev)
    if name == "env_image":
        return env_box(tdata.SceneBuilder(), True, sky(32, 64)).build(dev)
    if name == "textured":
        u = (np.arange(tdata.TEX_RES, dtype=np.float32) + 0.5) / tdata.TEX_RES
        grad = np.broadcast_to(u[None, :, None], (tdata.TEX_RES, tdata.TEX_RES, 3)).copy()
        return textured_floor(tdata.SceneBuilder(), grad).build(dev)
    return load_mitsuba_scene(str(CORNELL_XML), device=dev)[0]


def _table(name, dev):
    if name == "soup2048":
        rng = np.random.default_rng(1)
        tris = (rng.uniform(-2, 2, size=(2048, 1, 3))
                + rng.normal(scale=0.15, size=(2048, 3, 3))).astype(np.float32)
        return torch.as_tensor(woop_transform(tris).T.copy(), device=dev)
    return _scene(name, dev).tri_woop_t


def _rays(seed, r, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 2.5, size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rng.uniform(size=r) < 0.5, 0.0, rng.uniform(0, 0.5, size=r)).astype(np.float32)
    t_max = np.where(rng.uniform(size=r) < 0.5, 1e30, rng.uniform(0.5, 6.0, size=r)).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (o, d, t_min, t_max)]


@pytest.mark.parametrize("name", ["cornell", "zoo", "soup2048"])
def test_k2_matches_plain_version(cuda_device, name):  # noqa: F811
    """K2 against the plain versions on random rays, clean and with dead
    lanes (chip_smoke.warp_lanes: NaN and inactive lanes, dead warps, one
    live lane a warp, ~5% live): a scene's table cut at its tri_rows
    against the whole table, the soup whole and cut off its chunks against
    the plain versions on the cut."""
    w = _table(name, cuda_device)
    cuts = [(None, None)] if name == "soup2048" else [(_scene(name, cuda_device).tri_rows, None)]
    if name == "soup2048":
        cuts.append((1001, 1001))
    for n_rows, ref_rows in cuts:
        for tag, (o, d, lo, hi) in warp_lanes(_rays(7, 1 << 16, cuda_device)).items():
            n0, m0 = launches(ci.closest_cuda), launches(ci.any_cuda)
            t, prim = ci.closest_cuda(o, d, w, lo, hi, n_rows)
            occ = ci.any_cuda(o, d, w, lo, hi, n_rows)
            assert (launches(ci.closest_cuda), launches(ci.any_cuda)) == (n0 + 1, m0 + 1)
            t_r, prim_r = ci.closest_ref(o, d, w, lo, hi, ref_rows)
            assert (prim_r >= 0).sum() > (1000 if tag in ("clean", "odd") else 10), tag
            # the same fused operations in the same order: equal up to the plain
            # version's rare double rounding in m3.fma (about one op in 2^29)
            assert int((prim != prim_r).sum()) <= 2, tag
            assert bool(((t - t_r).abs() <= 1e-6 * t_r.abs()).all()), tag
            assert int((occ != ci.any_ref(o, d, w, lo, hi, ref_rows)).sum()) <= 2, tag


def test_k2_rejects_bad_inputs(cuda_device):  # noqa: F811
    w = _table("cornell", cuda_device)
    o, d, lo, hi = _rays(1, 64, cuda_device)
    with pytest.raises(ValueError):
        ci.closest_cuda(o.cpu(), d, w, lo, hi)
    with pytest.raises(ValueError):
        ci.any_cuda(o, d, w.t(), lo, hi)
    for bad in (-1, w.shape[1] + 1):
        with pytest.raises(ValueError, match="n_rows"):
            ci.closest_cuda(o, d, w, lo, hi, bad)


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_k1_matches_plain_version(cuda_device, name):  # noqa: F811
    ts = _scene(name, cuda_device)
    for kw, emission_only in ((dict(max_depth=0, nee=False, spp=1), True),
                              (dict(max_depth=4, nee=True, spp=2), False)):
        cfg = RenderConfig(width=64, height=64, **kw)
        n0 = launches(mega.render_mega_rows)
        got, rays_got = render_image_stats_auto(ts, cfg, 0)
        assert launches(mega.render_mega_rows) == n0 + 1
        pix = torch.arange(64 * 64, dtype=torch.int32, device=cuda_device).reshape(-1, mega.LANES)
        r, g, b, rays = mega.render_mega_rows_ref(ts, cfg, pix, 0)
        ref = (torch.stack([r, g, b], -1).reshape(64, 64, 3) / cfg.spp).cpu().numpy()
        got = got.cpu().numpy()
        if emission_only:
            # at most 0.1% of pixels: a 1-ulp tanf / rsqrtf difference may move
            # a ray across the emitter's silhouette
            assert np.mean(np.abs(got - ref).max(-1) > 0) <= 0.001
        assert_mega_gates(ref, got, float(rays.double().sum()), rays_got)


def test_wavefront_on_k2_matches_plain_scans(cuda_device):  # noqa: F811
    ts = _scene("cornell", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, ray_batch=4096)
    n0 = launches(ci.closest_cuda)
    got, rays_got = pt.render_image_stats(ts, cfg, 0)
    assert launches(ci.closest_cuda) > n0
    ref, rays_ref = pt.render_image_stats(ts, cfg.replace(intersector="woop"), 0)
    assert_mega_gates(ref.cpu().numpy(), got.cpu().numpy(), rays_ref, rays_got,
                      max_frac=0.001)


@pytest.mark.parametrize("name", ["cornell", "zoo", "sphere_field", "slot_mode"])
def test_k3_matches_plain_version(cuda_device, name, monkeypatch):  # noqa: F811
    if name == "slot_mode":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
    ts = _scene("cornell" if name == "slot_mode" else name, cuda_device)
    o, d, lo, hi = _rays(11, 1 << 16, cuda_device)
    n0, m0 = launches(ftb.ftb_closest), launches(ftb.ftb_any)
    t, prim, u, v, attrs = ftb.ftb_closest(ts, o, d, t_max=hi)
    occ = ftb.ftb_any(ts, o, d, lo, hi)
    assert (launches(ftb.ftb_closest), launches(ftb.ftb_any)) == (n0 + 1, m0 + 1)
    t_r, prim_r, u_r, v_r, attrs_r = ftb.ftb_closest_ref(ts, o, d, t_max=hi)
    assert (prim_r >= 0).sum() > 1000
    # the brute scan's fused arithmetic: equal up to m3.fma's rare double
    # rounding (about one op in 2^29), ties included
    assert int((prim != prim_r).sum()) <= 2
    same = prim == prim_r
    assert torch.equal(t[same], t_r[same]) and torch.equal(u[same], u_r[same])
    assert torch.equal(v[same], v_r[same]) and torch.equal(attrs[same], attrs_r[same])
    assert int((occ != ftb.ftb_any_ref(ts, o, d, lo, hi)).sum()) <= 2


def test_walk_tests_count_the_walk(cuda_device):  # noqa: F811
    """ftb_walk_tests runs K3's walk with counters: a ray that hits tested at
    least one triangle, no ray more than every slot; a ray whose segment
    misses the root box tested that box alone; an empty segment nothing."""
    ts = _scene("sphere_field", cuda_device)
    o, d, lo, hi = _rays(12, 1 << 14, cuda_device)
    _, prim, _, _, _ = ftb.ftb_closest(ts, o, d, t_max=hi)
    boxes, woops = ftb.ftb_walk_tests(ts, o, d, torch.zeros_like(hi), hi, False)
    n_slots, n_nodes = ts.tri_woop_t.shape[1], ts.bvh_dfs_bounds.shape[1]
    assert bool((woops[prim >= 0] >= 1).all()) and int(woops.max()) <= n_slots
    assert bool((boxes >= 1).all()) and int(boxes.max()) <= n_nodes + ts.bvh_clusters
    far = torch.tensor([[1e4, 1e4, 1e4]], device=cuda_device)
    out = torch.tensor([[1.0, 0.0, 0.0]], device=cuda_device)
    one = torch.ones((1,), device=cuda_device)
    assert [int(x) for x in ftb.ftb_walk_tests(ts, far, out, one * 0, one * 1e30, False)] == [1, 0]
    assert [int(x) for x in ftb.ftb_walk_tests(ts, o[:1], d[:1], one, one, True)] == [0, 0]
    b_any, w_any = ftb.ftb_walk_tests(ts, o, d, lo, hi, True)
    occ = ftb.ftb_any(ts, o, d, lo, hi)
    assert bool((w_any[occ] >= 1).all()) and int(w_any.max()) <= n_slots


@pytest.mark.parametrize("name", ["soup_morton", "soup_ties", "slot_field", "one_cluster"])
def test_k3_pair_walk_edge_cases(cuda_device, name, monkeypatch):  # noqa: F811
    """K3's pair walk on a morton build, a soup of exact-t twins, a
    slot-mode sphere field and a tree of one cluster (no pair row), with
    NaN and inactive lanes: the brute scan's hits, the lowest slot of a
    tie."""
    from chip_smoke import field_rays, soup_scene

    if name == "soup_morton":
        ts = soup_scene(700, 3, cuda_device, order="morton")
    elif name == "soup_ties":
        ts = soup_scene(600, 5, cuda_device, ties=True)
    elif name == "slot_field":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        ts = _scene("sphere_field", cuda_device)
    else:
        ts = soup_scene(12, 3, cuda_device)
        assert ts.bvh_pairs.shape[0] == 0 and ts.bvh_root == ~0
    o, d, lo, hi = odd_lanes(field_rays(1 << 15, ts, 13, cuda_device))
    t, prim, u, v, attrs = ftb.ftb_closest(ts, o, d, t_max=hi)
    occ = ftb.ftb_any(ts, o, d, lo, hi)
    t_r, prim_r, u_r, v_r, attrs_r = ftb.ftb_closest_ref(ts, o, d, t_max=hi)
    assert (prim_r >= 0).sum() > (50 if name == "one_cluster" else 500)
    # the brute scan's fused arithmetic: equal up to m3.fma's rare double
    # rounding (about one op in 2^29), ties included
    assert int((prim != prim_r).sum()) <= 2
    same = prim == prim_r
    assert torch.equal(t[same], t_r[same]) and torch.equal(u[same], u_r[same])
    assert torch.equal(v[same], v_r[same]) and torch.equal(attrs[same], attrs_r[same])
    assert int((occ != ftb.ftb_any_ref(ts, o, d, lo, hi)).sum()) <= 2


def test_walk_tests_count_the_pair_walk(cuda_device):  # noqa: F811
    """walk_tests runs K3's own walk with counters: a ray that hits tested
    at least one triangle, none more than every slot; a ray far outside the
    scene tested the root's two child boxes alone; an empty segment
    nothing."""
    ts = _scene("sphere_field", cuda_device)
    o, d, lo, hi = _rays(12, 1 << 14, cuda_device)
    _, prim, _, _, _ = ftb.ftb_closest(ts, o, d, t_max=hi)
    zero = torch.zeros_like(hi)
    boxes, woops = ftb.walk_tests(ts, o, d, zero, hi, False)
    n_slots = ts.tri_woop.shape[0]
    assert bool((woops[prim >= 0] >= 1).all()) and int(woops.max()) <= n_slots
    assert bool((boxes >= 2).all()) and int(boxes.max()) <= 2 * ts.bvh_pairs.shape[0]
    far = torch.tensor([[1e4, 1e4, 1e4]], device=cuda_device)
    out = torch.tensor([[1.0, 0.0, 0.0]], device=cuda_device)
    one = torch.ones((1,), device=cuda_device)
    assert [int(x) for x in ftb.walk_tests(ts, far, out, one * 0, one * 1e30, False)] == [2, 0]
    assert [int(x) for x in ftb.walk_tests(ts, o[:1], d[:1], one, one, True)] == [0, 0]
    b_any, w_any = ftb.walk_tests(ts, o, d, lo, hi, True)
    occ = ftb.ftb_any(ts, o, d, lo, hi)
    assert bool((w_any[occ] >= 1).all()) and int(w_any.max()) <= n_slots


def _k7_launches():
    return (launches(cs.cluster_votes), launches(cs.cluster_closest), launches(cs.cluster_any))


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_k7_matches_plain_version(cuda_device, name):  # noqa: F811
    """K7c's votes equal the plain slab test's; K7d / K7e on those votes
    equal the plain gated scan (m3.fma's rare double rounding aside)."""
    ts = _scene(name, cuda_device)
    o, d, lo, hi = _rays(13, 1 << 14, cuda_device)
    zeros = torch.zeros_like(hi)
    n0 = _k7_launches()
    votes = cs.cluster_votes(ts, o, d, zeros, hi)
    votes_any = cs.cluster_votes(ts, o, d, lo, hi)
    got = cs.cluster_closest(ts, o, d, t_max=hi, votes=votes)
    occ = cs.cluster_any(ts, o, d, lo, hi, votes=votes_any)
    assert _k7_launches() == (n0[0] + 2, n0[1] + 1, n0[2] + 1)
    assert torch.equal(votes, cs.cluster_votes_ref(ts, o, d, zeros, hi))
    assert torch.equal(votes_any, cs.cluster_votes_ref(ts, o, d, lo, hi))
    ref = cs.cluster_closest_ref(ts, o, d, t_max=hi, votes=votes)
    assert (ref[1] >= 0).sum() > 1000
    assert int((got[1] != ref[1]).sum()) <= 2
    same = got[1] == ref[1]
    for a, b in zip(got, ref):
        assert torch.equal(a[same], b[same])
    assert int((occ != cs.cluster_any_ref(ts, o, d, lo, hi, votes=votes_any)).sum()) <= 2
    # the wrappers launch K7c themselves when not given the votes
    t2 = cs.cluster_closest(ts, o, d, t_max=hi)[0]
    assert torch.equal(t2, got[0]) and _k7_launches()[0] == n0[0] + 3


@pytest.mark.parametrize("name", ["soup_ties", "slot_field", "one_supernode", "inactive_block",
                                  "r1", "r31", "r33", "r257"])
def test_k7de_two_gate_sweep_edge_cases(cuda_device, name, monkeypatch):  # noqa: F811
    """K7d / K7e (a warp a 32 rays, each voted supernode and leaf cluster
    gated by the ray's own widened slab test) bit for bit against the
    block-gated plain scans on the same votes, with NaN and inactive lanes:
    a soup of exact-t twins (every hit a tie won by the lower slot), a
    slot-mode sphere field, a scene of one supernode, a block of 256 rays
    all inactive, and 1, 31, 33 and 257 rays (part warps, part blocks)."""
    from chip_smoke import field_rays, soup_scene, tied_hits

    if name == "soup_ties":
        ts = soup_scene(600, 5, cuda_device, ties=True)
    elif name == "slot_field":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        ts = _scene("sphere_field", cuda_device)
    else:
        ts = _scene("cornell" if name == "one_supernode" else "sphere_field", cuda_device)
    n = dict(r1=1, r31=31, r33=33, r257=257).get(name, 1 << 14)
    o, d, lo, hi = odd_lanes(field_rays(n, ts, 14, cuda_device))
    if name == "inactive_block":
        hi[256:512] = -1e30
    sn = cs.scene_supernodes(ts)
    assert (sn.s == 1) == (name == "one_supernode")
    votes = cs.cluster_votes(ts, o, d, torch.zeros_like(hi), hi, supernodes=sn)
    votes_any = cs.cluster_votes(ts, o, d, lo, hi, supernodes=sn)
    if name == "inactive_block":
        assert int(votes[1].sum()) == 0 and int(votes_any[1].sum()) == 0
    n0 = _k7_launches()
    got = cs.cluster_closest(ts, o, d, t_max=hi, votes=votes, supernodes=sn)
    occ = cs.cluster_any(ts, o, d, lo, hi, votes=votes_any, supernodes=sn)
    assert _k7_launches() == (n0[0], n0[1] + 1, n0[2] + 1)
    ref = cs.cluster_closest_ref(ts, o, d, t_max=hi, votes=votes, supernodes=sn)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, cs.cluster_any_ref(ts, o, d, lo, hi, votes=votes_any, supernodes=sn))
    hits = int((ref[1] >= 0).sum())
    assert n < 300 or hits > 500
    if name == "soup_ties":
        assert tied_hits(ts, ref[1]) == hits


def test_wavefront_on_k7_matches_plain_scans(cuda_device):  # noqa: F811
    """The wavefront with bvh_kernel "cluster": K7c once for every K7d and
    K7e launch, K3 never; the image against the plain brute-force scans
    under the tests/test_mega.py gates."""
    ts = _scene("sphere_field", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, ray_batch=4096, use_bvh=True,
                       sort_rays=True, intersector="pallas", bvh_kernel="cluster")
    n0, f0 = _k7_launches(), (launches(ftb.ftb_closest), launches(ftb.ftb_any))
    got, rays_got = pt.render_image_stats(ts, cfg, 0)
    votes, closest, any_hit = (a - b for a, b in zip(_k7_launches(), n0))
    assert closest > 0 and any_hit > 0 and votes == closest + any_hit
    assert (launches(ftb.ftb_closest), launches(ftb.ftb_any)) == f0
    ref, rays_ref = pt.render_image_stats(ts, cfg.replace(intersector="woop"), 0,
                                          bvh_isect=pt.PLAIN_K3)
    assert_mega_gates(ref.cpu().numpy(), got.cpu().numpy(), rays_ref, rays_got)


def _k7fg_launches():
    return launches(ds.dfs_closest), launches(ds.dfs_any)


@pytest.mark.parametrize("name", ["cornell", "zoo", "sphere_field", "slot_mode"])
def test_k7fg_matches_plain_version(cuda_device, name, monkeypatch):  # noqa: F811
    """K7f / K7g equal the plain walk at BLOCK bit for bit: t, prim, u, v,
    attrs and occ, ties included, with inactive rays."""
    if name == "slot_mode":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
    ts = _scene("cornell" if name == "slot_mode" else name, cuda_device)
    o, d, lo, hi = _rays(14, 1 << 14, cuda_device)
    active = torch.arange(o.shape[0], device=cuda_device) % 7 != 0
    n0 = _k7fg_launches()
    got = ds.dfs_closest(ts, o, d, t_max=hi, active=active)
    occ = ds.dfs_any(ts, o, d, lo, hi, active=active)
    assert _k7fg_launches() == (n0[0] + 1, n0[1] + 1)
    ref = ds.dfs_closest_ref(ts, o, d, t_max=hi, active=active)
    assert (ref[1] >= 0).sum() > 1000 and not bool((ref[1][~active] >= 0).any())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ_r = ds.dfs_any_ref(ts, o, d, lo, hi, active=active)
    assert 0 < int(occ_r.sum()) < o.shape[0] and torch.equal(occ, occ_r)


@pytest.mark.parametrize("name", ["soup2048", "sphere_field"])
def test_k7fg_with_nan_lanes(cuda_device, name):  # noqa: F811
    """K7f / K7g against the plain walk on rays with NaN origin and
    direction components and inactive lanes: their votes keep torch's NaN
    rule (common.cuh:slab_nan), so a NaN lane votes for nothing, as in the
    plain walk."""
    from chip_smoke import field_rays, soup_scene

    ts = soup_scene(2048, 7, cuda_device) if name == "soup2048" else _scene(name, cuda_device)
    o, d, lo, hi = odd_lanes(field_rays(1 << 14, ts, 18, cuda_device))
    got = ds.dfs_closest(ts, o, d, t_max=hi)
    for a, b in zip(got, ds.dfs_closest_ref(ts, o, d, t_max=hi)):
        assert torch.equal(a, b)
    assert torch.equal(ds.dfs_any(ts, o, d, lo, hi), ds.dfs_any_ref(ts, o, d, lo, hi))


@pytest.mark.parametrize("name", ["soup_ties", "slot_field", "one_cluster", "nan_warp",
                                  "inactive_warp", "padded_warp", "r1", "r31", "r33", "r257"])
def test_k7fg_warp_walk_edge_cases(cuda_device, name, monkeypatch):  # noqa: F811
    """K7f / K7g (a warp a block of 32 rays, each leaf cluster gated by the
    lane's own widened slab test) bit for bit against the plain walk at
    BLOCK, with NaN and inactive lanes: a soup of exact-t twins (every hit a
    tie won by the lower slot), a slot-mode sphere field, a tree of one
    cluster, a warp of NaN lanes only, an inactive warp, a launch whose
    last warp is partly padding (4,100 rays) and 1, 31, 33 and 257 rays."""
    from chip_smoke import field_rays, soup_scene, tied_hits

    if name == "soup_ties":
        ts = soup_scene(600, 5, cuda_device, ties=True)
    elif name == "slot_field":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        ts = _scene("sphere_field", cuda_device)
    elif name == "one_cluster":
        ts = soup_scene(12, 3, cuda_device)
        assert ts.bvh_dfs_meta.shape[1] == 1 and ts.bvh_clusters == 1
    else:
        ts = _scene("sphere_field", cuda_device)
    n = dict(r1=1, r31=31, r33=33, r257=257, padded_warp=4100).get(name, 1 << 14)
    o, d, lo, hi = odd_lanes(field_rays(n, ts, 16, cuda_device))
    if name == "nan_warp":
        o[64:96, 0] = float("nan")
    if name == "inactive_warp":
        hi[64:96] = -1e30
    n0 = _k7fg_launches()
    got = ds.dfs_closest(ts, o, d, t_max=hi)
    occ = ds.dfs_any(ts, o, d, lo, hi)
    assert _k7fg_launches() == (n0[0] + 1, n0[1] + 1)
    ref = ds.dfs_closest_ref(ts, o, d, t_max=hi)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, ds.dfs_any_ref(ts, o, d, lo, hi))
    hits = int((ref[1] >= 0).sum())
    assert n < 300 or hits > (20 if name == "one_cluster" else 300)
    if name in ("nan_warp", "inactive_warp"):
        assert not bool((got[1][64:96] >= 0).any()) and not bool(occ[64:96].any())
    if name == "soup_ties":
        assert tied_hits(ts, ref[1]) == hits


def test_wavefront_on_k7fg_matches_plain_scans(cuda_device):  # noqa: F811
    """The wavefront with bvh_kernel "dfs": K7f and K7g launched, K3 and
    K7c-e never; the image against the plain brute-force scans under the
    tests/test_mega.py gates."""
    ts = _scene("sphere_field", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, ray_batch=4096, use_bvh=True,
                       sort_rays=True, intersector="pallas", bvh_kernel="dfs")
    n0, others = _k7fg_launches(), (launches(ftb.ftb_closest), launches(ftb.ftb_any),
                                    *_k7_launches())
    got, rays_got = pt.render_image_stats(ts, cfg, 0)
    closest, any_hit = (a - b for a, b in zip(_k7fg_launches(), n0))
    assert closest > 0 and any_hit > 0
    assert (launches(ftb.ftb_closest), launches(ftb.ftb_any), *_k7_launches()) == others
    ref, rays_ref = pt.render_image_stats(ts, cfg.replace(intersector="woop"), 0,
                                          bvh_isect=pt.PLAIN_K3)
    assert_mega_gates(ref.cpu().numpy(), got.cpu().numpy(), rays_ref, rays_got)


def _k7ab_launches():
    return launches(tb.binned_closest), launches(tb.binned_any)


@pytest.mark.parametrize("name", ["cornell", "zoo", "sphere_field", "slot_mode", "soup2048"])
def test_k7ab_matches_plain_version(cuda_device, name, monkeypatch):  # noqa: F811
    """K7a / K7b equal the plain binned sweep bit for bit: t, prim, u, v,
    attrs and occ, ties included, with inactive rays."""
    if name == "slot_mode":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
    if name == "soup2048":
        from chip_smoke import soup_scene

        ts = soup_scene(2048, 7, cuda_device)
    else:
        ts = _scene("cornell" if name == "slot_mode" else name, cuda_device)
    o, d, lo, hi = _rays(15, 1 << 14, cuda_device)
    active = torch.arange(o.shape[0], device=cuda_device) % 7 != 0
    n0 = _k7ab_launches()
    got = tb.binned_closest(ts, o, d, t_max=hi, active=active)
    occ = tb.binned_any(ts, o, d, lo, hi, active=active)
    assert _k7ab_launches() == (n0[0] + 1, n0[1] + 1)
    ref = tb.binned_closest_ref(ts, o, d, t_max=hi, active=active)
    assert (ref[1] >= 0).sum() > 1000 and not bool((ref[1][~active] >= 0).any())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ_r = tb.binned_any_ref(ts, o, d, lo, hi, active=active)
    assert 0 < int(occ_r.sum()) < o.shape[0] and torch.equal(occ, occ_r)


def _rebinned(ts, slots):
    """ts with its bins rebuilt at `slots` slots a bin (bvh/tables.py:
    build_bins over the same tree)."""
    from gpuspectral_tpu_torch.bvh import tables

    c = ts.bvh_clusters
    lo, hi = ts.bvh_node_min.cpu().numpy(), ts.bvh_node_max.cpu().numpy()
    real = int(np.isfinite(lo[c - 1:]).all(1).sum())
    bounds, n_bins, n_slots = tables.build_bins(lo, hi, c, real, ts.bvh_leaf_size,
                                                slots_per_bin=slots)
    return ts.replace(bvh_bin_bounds=torch.as_tensor(bounds, device=ts.device), bvh_bins=n_bins,
                      bvh_bin_slots=n_slots, bvh_bin_rows=torch.as_tensor(
                          tables.build_bin_rows(bounds, n_bins), device=ts.device))


def _culled(ts):
    """ts with every third bin's box moved to a far point: the votes lose
    those bins' hits, so the leaf filter decides the results."""
    from gpuspectral_tpu_torch.bvh import tables

    b = ts.bvh_bin_bounds.cpu().numpy().copy()
    b[:, ::3] = np.array([1e17, 2e17, 3e17, 1e17, 2e17, 3e17], np.float32)[:, None]
    return ts.replace(bvh_bin_bounds=torch.as_tensor(b, device=ts.device), bvh_bin_rows=
                      torch.as_tensor(tables.build_bin_rows(b, ts.bvh_bins), device=ts.device))


@pytest.mark.parametrize("name", ["soup_morton", "soup_ties", "slot_field", "below_width",
                                  "above_width", "culled_bins", "one_cluster", "t_min_negative",
                                  "r1", "r31", "r33", "r257"])
def test_k7ab_walk_edge_cases(cuda_device, name, monkeypatch):  # noqa: F811
    """K7a / K7b (K3's walk with the bin vote as a leaf filter) bit for bit
    against the plain binned sweep, with NaN and inactive lanes: a morton
    build, a soup of exact-t twins (every hit a tie won by the lower slot),
    a slot-mode sphere field (its bins' slots fall short of the Woop
    table's width), a soup whose 256-slot bins reach past it, bins whose
    boxes miss (the votes drop hits the brute scan finds), a tree of one
    cluster, t_min < 0 for K7b, and 1, 31, 33 and 257 rays."""
    from chip_smoke import field_rays, soup_scene, tied_hits

    if name == "soup_morton":
        ts = soup_scene(2048, 8, cuda_device, order="morton")
    elif name == "soup_ties":
        ts = soup_scene(600, 5, cuda_device, ties=True)
    elif name in ("slot_field", "below_width"):
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        ts = _scene("sphere_field", cuda_device)
    elif name == "above_width":
        ts = _rebinned(soup_scene(1100, 4, cuda_device), 256)
    elif name == "culled_bins":
        ts = _culled(soup_scene(2048, 7, cuda_device))
    elif name == "one_cluster":
        ts = soup_scene(12, 3, cuda_device)
    else:
        ts = _scene("sphere_field", cuda_device)
    width = ts.bvh_bins * ts.bvh_bin_slots
    if name == "below_width":
        assert width < ts.tri_woop.shape[0]
    if name == "above_width":
        assert width > ts.tri_woop.shape[0]
    n = dict(r1=1, r31=31, r33=33, r257=257).get(name, 1 << 14)
    o, d, lo, hi = odd_lanes(field_rays(n, ts, 16, cuda_device))
    if name == "t_min_negative":
        lo = torch.where(torch.arange(n, device=cuda_device) % 2 == 0, -0.5, lo).contiguous()
    n0 = _k7ab_launches()
    got = tb.binned_closest(ts, o, d, t_max=hi)
    occ = tb.binned_any(ts, o, d, lo, hi)
    assert _k7ab_launches() == (n0[0] + 1, n0[1] + 1)
    ref = tb.binned_closest_ref(ts, o, d, t_max=hi)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ_r = tb.binned_any_ref(ts, o, d, lo, hi)
    assert torch.equal(occ, occ_r)
    hits = int((ref[1] >= 0).sum())
    assert n < 300 or hits > (50 if name == "one_cluster" else 500)
    if name == "soup_ties":
        assert tied_hits(ts, ref[1]) == hits
    if name == "culled_bins":
        assert bool((ref[1] != ftb.ftb_closest_ref(ts, o, d, t_max=hi)[1]).any())
    if name == "t_min_negative":
        assert not torch.equal(occ_r, tb.binned_any_ref(ts, o, d, torch.zeros_like(lo), hi))


@pytest.mark.parametrize("name", ["sphere_field", "culled_bins"])
def test_binned_walk_tests_count_the_walk(cuda_device, name):  # noqa: F811
    """binned_walk_tests runs K7a / K7b's walk with counters: its results
    equal the kernels' (prim, occ), a ray that hits tested at least one
    triangle and voted at least once, no ray more Woop tests than slots; a
    ray far outside the scene tested the root's two child boxes alone; an
    empty segment and a NaN lane nothing."""
    from chip_smoke import soup_scene

    ts = _scene("sphere_field", cuda_device) if name == "sphere_field" else _culled(
        soup_scene(2048, 7, cuda_device))
    o, d, lo, hi = odd_lanes(_rays(12, 1 << 14, cuda_device))
    zero = torch.zeros_like(hi)
    prim = tb.binned_closest(ts, o, d, t_max=hi)[1]
    occ = tb.binned_any(ts, o, d, lo, hi)
    n_slots = ts.tri_woop.shape[0]
    for w, want in ((tb.binned_walk_tests(ts, o, d, zero, hi, False), prim),
                    (tb.binned_walk_tests(ts, o, d, lo, hi, True), occ.int())):
        assert torch.equal(w.result, want)
        hit = want >= 0 if want is prim else want > 0
        assert bool((w.woops[hit] >= 1).all()) and bool((w.votes[hit] >= 1).all())
        assert int(w.woops.max()) <= n_slots and int(w.votes.max()) <= int(w.boxes.max())
        nan = torch.isnan(o).any(1) | torch.isnan(d).any(1)
        assert int((w.boxes[nan] + w.votes[nan] + w.woops[nan]).sum()) == 0
        assert w.clusters.shape == (ts.bvh_clusters,) and bool(w.clusters.any())
    far = torch.tensor([[1e4, 1e4, 1e4]], device=cuda_device)
    out = torch.tensor([[1.0, 0.0, 0.0]], device=cuda_device)
    one = torch.ones((1,), device=cuda_device)
    w = tb.binned_walk_tests(ts, far, out, one * 0, one * 1e30, False)
    assert [int(x) for x in w[:4]] == [2, 0, 0, -1]
    w = tb.binned_walk_tests(ts, o[:1], d[:1], one, one, True)
    assert [int(x) for x in w[:4]] == [0, 0, 0, 0]


@pytest.mark.parametrize("case", [1, 31, 33, 257, 1 << 14, "inactive_blocks",
                                  "one_live_lane_a_warp", "sparse_live", "s1", "s33", "s1024"])
def test_k7c_votes_with_nan_lanes(cuda_device, case):  # noqa: F811
    """F17: K7c's votes equal the plain slab test's on rays with NaN origin
    and direction components and inactive lanes: a NaN lane votes for
    nothing (fminf / fmaxf would drop the NaN and let it vote).  Then K7c's
    warp schedule (a warp with no live lane skipped, a warp's live rays
    culled as one bundle) at its edges, bit for bit: 1, 31, 33, 257 and
    16,384 rays; blocks whose lanes are all inactive; one live lane a warp;
    ~5% of the lanes live, scattered (chip_smoke.sparse_lanes); and 1, 33
    and 1,024 supernodes (the first S of the sphere field's, and a
    supernode range of the grid cut short)."""
    from chip_smoke import field_rays, sparse_lanes

    ts = _scene("cornell" if case == "s1" else "sphere_field", cuda_device)
    if case in ("s33", "s1024"):
        ts = build_sphere_field(cuda_device)
    n = case if isinstance(case, int) else 1 << 14
    o, d, lo, hi = odd_lanes(field_rays(n, ts, 17, cuda_device))
    if case == "inactive_blocks":
        hi[256:768] = -1e30
        hi[-300:] = -1e30
    if case == "one_live_lane_a_warp":
        r = torch.arange(n, device=cuda_device)
        hi[r % 32 != r // 32 % 32] = -1e30
    if case == "sparse_live":
        o, d, lo, hi = sparse_lanes((o, d, lo, hi))
    sn = cs.scene_supernodes(ts)
    if case == "s33":
        sn = cs.Supernodes(sn.blo, sn.bhi, 33, sn.stride)
    assert {"s1": 1, "s1024": 1024}.get(case, sn.s) == sn.s
    n0 = launches(cs.cluster_votes)
    for seg in (torch.zeros_like(lo), lo):
        votes = cs.cluster_votes(ts, o, d, seg, hi, supernodes=sn)
        assert torch.equal(votes, cs.cluster_votes_ref(ts, o, d, seg, hi, supernodes=sn))
    assert launches(cs.cluster_votes) == n0 + 2
    if case == "inactive_blocks":
        assert int(votes[1:3].sum()) == 0 and int(votes.sum()) > 0
    if case in ("sparse_live", "one_live_lane_a_warp", "s33", "s1024"):
        assert int(votes.sum()) > 0
    # a block of NaN lanes alone votes for nothing
    nan_o = torch.full_like(o, float("nan"))
    assert int(cs.cluster_votes(ts, nan_o, d, lo, hi, supernodes=sn).sum()) == 0


def test_wavefront_on_k7ab_matches_plain_scans(cuda_device):  # noqa: F811
    """The wavefront with bvh_kernel "binned": K7a and K7b launched, K3,
    K7c-e and K7f / K7g never; the image against the plain brute-force
    scans under the tests/test_mega.py gates."""
    ts = _scene("sphere_field", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, ray_batch=4096, use_bvh=True,
                       sort_rays=True, intersector="pallas", bvh_kernel="binned")
    n0, others = _k7ab_launches(), (launches(ftb.ftb_closest), launches(ftb.ftb_any),
                                    *_k7_launches(), *_k7fg_launches())
    got, rays_got = pt.render_image_stats(ts, cfg, 0)
    closest, any_hit = (a - b for a, b in zip(_k7ab_launches(), n0))
    assert closest > 0 and any_hit > 0
    assert (launches(ftb.ftb_closest), launches(ftb.ftb_any), *_k7_launches(),
            *_k7fg_launches()) == others
    ref, rays_ref = pt.render_image_stats(ts, cfg.replace(intersector="woop"), 0,
                                          bvh_isect=pt.PLAIN_K3)
    assert_mega_gates(ref.cpu().numpy(), got.cpu().numpy(), rays_ref, rays_got)


def _k7h_launches():
    return launches(tk.traverse_closest), launches(tk.traverse_any)


def _soup_scene(dev, n_tris=2048):
    rng = np.random.default_rng(7)
    tris = (rng.uniform(-2.0, 2.0, size=(n_tris, 1, 3))
            + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32)
    b = tdata.SceneBuilder()
    b.add_object(tris, tris, None, np.eye(4, dtype=np.float32), b.add_bsdf(diffuse((0.5,) * 3)))
    return b.build(dev)


def _tree(ts):
    return (tk.pack_tris(ts.tri_pos, ts.bvh_clusters, ts.bvh_leaf_size),
            ts.bvh_node_min.contiguous(), ts.bvh_node_max.contiguous(), ts.bvh_levels)


def _hand_tree(dev, clusters, n_clusters=64, leaf=16, seed=5):
    """A tree of n_clusters x leaf slots built by hand, triangles only in
    the clusters named in `clusters` ({cluster: (16, 3, 3) triangles}), the
    other clusters' rows zero under inverted boxes: (packed rows, node_min,
    node_max, n_levels)."""
    tris = np.zeros((n_clusters * leaf, 3, 3), np.float32)
    node_min = np.full((2 * n_clusters - 1, 3), np.inf, np.float32)
    node_max = np.full((2 * n_clusters - 1, 3), -np.inf, np.float32)
    for c, rows in clusters.items():
        tris[c * leaf:c * leaf + rows.shape[0]] = rows
        node_min[n_clusters - 1 + c] = rows.min((0, 1))
        node_max[n_clusters - 1 + c] = rows.max((0, 1))
    for n in range(n_clusters - 2, -1, -1):
        node_min[n] = np.minimum(node_min[2 * n + 1], node_min[2 * n + 2])
        node_max[n] = np.maximum(node_max[2 * n + 1], node_max[2 * n + 2])
    packed = tk.pack_tris(torch.as_tensor(tris, device=dev), n_clusters, leaf)
    return (packed, torch.as_tensor(node_min, device=dev), torch.as_tensor(node_max, device=dev),
            int(np.log2(n_clusters)) + 1)


def _blob(rng, n=16, scale=0.3):
    return (rng.uniform(-1, 1, size=(n, 1, 3))
            + rng.normal(scale=scale, size=(n, 3, 3))).astype(np.float32)


def _special_case(name, dev):
    """(tree, rays) of the K7h edge cases: one real cluster among 64 (the
    root's right half), a tree with no empty cluster (1,024 triangles in 64
    full clusters), a packet occluded at the first leaf it enters (a wide
    triangle in cluster 0 in front of every ray, a blob in cluster 63), and
    packets of inactive rays only (t_max = -1e30) between active ones."""
    rng = np.random.default_rng(9)
    if name == "one_cluster":
        tree = _hand_tree(dev, {37: _blob(rng)})
        rays = _rays(31, 3000, dev)
    elif name == "no_empty_cluster":
        tris = _blob(rng, 1024, 0.1) * 2.0
        bvh = bvh_build.build_bvh(tris, 1024)
        assert bvh.n_clusters == bvh.n_clusters_real == 64
        tree = (tk.pack_tris(torch.as_tensor(tris[bvh.perm], device=dev), 64, bvh.leaf_size),
                torch.as_tensor(bvh.node_min, device=dev), torch.as_tensor(bvh.node_max, device=dev),
                bvh.n_levels)
        rays = _rays(32, 3000, dev)
    elif name == "occluded_first_leaf":
        wall = np.array([[[-50.0, -50.0, 1.0], [50.0, -50.0, 1.0], [0.0, 80.0, 1.0]]], np.float32)
        tree = _hand_tree(dev, {0: wall, 63: _blob(rng) + 3.0})
        r = 2048
        o = np.concatenate([rng.uniform(-1, 1, size=(r, 2)), np.zeros((r, 1))], 1)
        d = np.concatenate([rng.normal(scale=0.2, size=(r, 2)), np.ones((r, 1))], 1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = [torch.as_tensor(x.astype(np.float32), device=dev)
                for x in (o, d, np.zeros(r), np.full(r, 1e30))]
    else:  # inactive_packets
        tree = _tree(_scene("sphere_field", dev))
        rays = _rays(33, 4096, dev)
        rays[3][1024:3072] = -1e30
    return tree, rays


@pytest.mark.parametrize("name", ["one_cluster", "no_empty_cluster", "occluded_first_leaf",
                                  "inactive_packets"])
@pytest.mark.parametrize("packet", [32, 1024])
def test_k7h_edge_cases_match_plain_version(cuda_device, name, packet):  # noqa: F811
    """K7h equals the plain traversal bit for bit on trees and packets at
    the edges of its walk (pack_nodes marks every empty subtree, or none;
    an any-hit packet stops after its first leaf; a packet votes for
    nothing)."""
    tree, (o, d, lo, hi) = _special_case(name, cuda_device)
    nodes = tk.pack_nodes(*tree[1:3], tree[0])
    marked = int(nodes[:, 3].sum())
    assert marked == 0 if name == "no_empty_cluster" else marked > 0
    zero = torch.zeros_like(hi)
    got = tk.traverse_closest(o, d, *tree, zero, hi, packet, nodes=nodes)
    occ = tk.traverse_any(o, d, *tree, lo, hi, packet, nodes=nodes)
    ref = ttr.intersect_closest_bvh_ref(o, d, *tree, zero, hi, packet)
    occ_r = ttr.intersect_any_bvh_ref(o, d, *tree, lo, hi, packet)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, occ_r)
    if name == "occluded_first_leaf":
        assert bool(occ_r.all()) and bool((ref[1] < 16).all())
    elif name == "inactive_packets":
        assert not bool(occ_r[1024:3072].any()) and bool((ref[1][1024:3072] == -1).all())
        assert bool(occ_r.any())
    else:
        assert int((ref[1] >= 0).sum()) > 20 and bool(occ_r.any())


@pytest.mark.parametrize("packet", [1, 32, 96, 256, 1024, 2048])
def test_k7h_launch_shape(cuda_device, packet):  # noqa: F811
    """K7h's launch holds every ray of a packet once: a thread block cluster
    of CTAs at the CLI's packets of 1,024 (the cluster variant is kept),
    whose warps fill at most the 32 slots of a reduction, one or two rays a
    thread."""
    shape = tk.launch_shape(packet)
    ctas, threads, per = (shape[k] for k in ("ctas_per_packet", "threads_per_cta",
                                             "rays_per_thread"))
    assert threads % 32 == 0 and ctas * threads <= 1024 and per in (1, 2)
    assert ctas * threads * per >= packet
    if packet >= 1024:
        assert ctas > 1


def test_k7h_node_rows_argument(cuda_device):  # noqa: F811
    """The node rows built once (pack_nodes, as the wavefront passes them)
    and built by the wrapper give the same result; rows of another shape,
    type or device raise, and so does a marked cluster with a row."""
    ts = _scene("sphere_field", cuda_device)
    tree = _tree(ts)
    o, d, lo, hi = _rays(7, 3000, cuda_device)
    nodes = tk.pack_nodes(*tree[1:3], tree[0])
    a = tk.traverse_closest(o, d, *tree, lo, hi, nodes=nodes)
    b = tk.traverse_closest(o, d, *tree, lo, hi)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(tk.traverse_any(o, d, *tree, lo, hi, nodes=nodes),
                       tk.traverse_any(o, d, *tree, lo, hi))
    for bad in (nodes[:, :7].contiguous(), nodes.double(), nodes.cpu(), nodes[1:]):
        with pytest.raises(ValueError, match="nodes wants"):
            tk.traverse_any(o, d, *tree, lo, hi, nodes=bad)
    packed = tree[0].clone()
    leaf = int(torch.nonzero(nodes[ts.bvh_clusters - 1:, 3])[0, 0])
    packed[leaf, 0, 0] = 1.0
    with pytest.raises(ValueError, match="inverted box"):
        tk.traverse_closest(o, d, packed, *tree[1:], lo, hi)


@pytest.mark.parametrize("name,packet", [
    ("cornell", 32), ("zoo", 1024), ("sphere_field", 32), ("sphere_field", 1024),
    ("soup2048", 1), ("soup2048", 96), ("soup2048", 2048), ("soup2048", 32), ("soup2048", 1024)])
def test_k7h_matches_plain_version(cuda_device, name, packet):  # noqa: F811
    """K7h equals the plain packet traversal bit for bit: t, prim, u, v and
    occ, ties included, with NaN and inactive lanes and a ragged last
    packet."""
    ts = _soup_scene(cuda_device) if name == "soup2048" else _scene(name, cuda_device)
    o, d, lo, hi = odd_lanes(_rays(17, 5000, cuda_device))
    tree = _tree(ts)
    n0 = _k7h_launches()
    got = tk.traverse_closest(o, d, *tree, lo, hi, packet)
    occ = tk.traverse_any(o, d, *tree, lo, hi, packet)
    assert _k7h_launches() == (n0[0] + 1, n0[1] + 1)
    ref = ttr.intersect_closest_bvh_ref(o, d, *tree, lo, hi, packet)
    assert int((ref[1] >= 0).sum()) > 100
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ_r = ttr.intersect_any_bvh_ref(o, d, *tree, lo, hi, packet)
    assert 0 < int(occ_r.sum()) < o.shape[0] and torch.equal(occ, occ_r)


def test_k7h_rejects_bad_inputs(cuda_device):  # noqa: F811
    ts = _scene("cornell", cuda_device)
    o, d, lo, hi = _rays(3, 64, cuda_device)
    tree = _tree(ts)
    with pytest.raises(ValueError, match="float32"):
        tk.traverse_closest(o.double(), d, *tree, lo, hi)
    with pytest.raises(ValueError, match="contiguous"):
        tk.traverse_any(o, d, *tree, lo, torch.stack([hi, hi], 1)[:, 0])
    o, d, lo, hi = _rays(3, tk.MAX_PACKET + 1, cuda_device)
    with pytest.raises(ValueError, match="packets of up to"):
        tk.traverse_any(o, d, *tree, lo, hi, tk.MAX_PACKET + 1)


@pytest.mark.parametrize("skip_empty", [False, True])
def test_traverse_tests_count_the_plain_walk(cuda_device, skip_empty):  # noqa: F811
    """traverse_tests on the card (K7h's walk with counters; with
    skip_empty, the walk that enters no empty cluster) equals the plain
    walk's count on the CPU, test for test, and its result equals K7h's."""
    ts, cpu = _scene("sphere_field", cuda_device), _scene("sphere_field", "cpu")
    o, d, lo, hi = odd_lanes(_rays(21, 3000, cuda_device))
    zero = torch.zeros_like(hi)
    for any_hit, tmin in ((False, zero), (True, lo)):
        rays = (o, d, tmin, hi)
        got = tk.traverse_tests(*rays[:2], *_tree(ts), *rays[2:], any_hit, 256, skip_empty)
        ref = tk.traverse_tests(*[x.cpu() for x in rays[:2]], *_tree(cpu),
                                *[x.cpu() for x in rays[2:]], any_hit, 256, skip_empty)
        assert int(got[1].sum()) > 0
        assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
        if any_hit:
            assert torch.equal(got[2], tk.traverse_any(o, d, *_tree(ts), lo, hi, 256))
        else:
            k7h = tk.traverse_closest(o, d, *_tree(ts), zero, hi, 256)
            assert all(torch.equal(a, b) for a, b in zip(got[2], k7h))


def test_wavefront_on_k7h_matches_cpu(cuda_device):  # noqa: F811
    """The wavefront with intersector "mt" and a BVH: K7h launched for the
    closest hits and the shadow rays, no other intersection kernel; the
    image against the same render on the CPU (the plain traversal) under
    the tests/test_mega.py gates."""
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=4, ray_batch=2048, use_bvh=True,
                       intersector="mt", packet_size=256)
    others = lambda: (launches(ci.closest_cuda), launches(ci.any_cuda),  # noqa: E731
                      launches(ftb.ftb_closest), launches(ftb.ftb_any), *_k7_launches(),
                      *_k7fg_launches(), *_k7ab_launches())
    n0, o0 = _k7h_launches(), others()
    got, rays_got = pt.render_image_stats(_scene("sphere_field", cuda_device), cfg, 0)
    assert all(a > b for a, b in zip(_k7h_launches(), n0)) and others() == o0
    ref, rays_ref = pt.render_image_stats(_scene("sphere_field", "cpu"), cfg, 0)
    assert_mega_gates(ref.numpy(), got.cpu().numpy(), rays_ref, rays_got)


@pytest.mark.parametrize("name", ["env_const", "env_image"])
def test_k1_environment_matches_plain_version(cuda_device, name):  # noqa: F811
    ts = _scene(name, cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4)
    assert mega.mega_eligible(ts, cfg)
    n0 = launches(mega.render_mega_rows)
    got, rays_got = render_image_stats_auto(ts, cfg, 0)
    assert launches(mega.render_mega_rows) == n0 + 1
    pix = torch.arange(64 * 64, dtype=torch.int32, device=cuda_device).reshape(-1, mega.LANES)
    r, g, b, rays = mega.render_mega_rows_ref(ts, cfg, pix, 0)
    ref = (torch.stack([r, g, b], -1).reshape(64, 64, 3) / cfg.spp).cpu().numpy()
    assert_mega_gates(ref, got.cpu().numpy(), float(rays.double().sum()), rays_got)


@pytest.mark.parametrize("name,opts", [
    ("cornell", {}), ("sphere_field", {}), ("textured", {}), ("env_image", {}),
    ("cornell", dict(light_sampling="power", mis_mode="exact")),
    ("sphere_field", dict(mega_sync_regen=True)),
    ("soup_morton", {}), ("soup_ties", dict(mega_sync_regen=True)),
], ids=["cornell", "sphere_field", "textured", "env_image", "power_exact", "sync_regen",
        "soup_morton", "soup_ties_sync_regen"])
def test_k4_matches_plain_version(cuda_device, name, opts):  # noqa: F811
    from chip_smoke import soup_scene

    if name.startswith("soup"):
        ts = soup_scene(600, 5, cuda_device, order="morton" if name == "soup_morton" else "sah",
                        ties=name == "soup_ties", light=True)
    else:
        ts = _scene(name, cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, use_bvh=True, **opts)
    n0 = launches(mega_bvh.render_mega_bvh_rows)
    got, rays_got = render_image_stats_auto(ts, cfg, 0)
    assert launches(mega_bvh.render_mega_bvh_rows) == n0 + 1
    pix = torch.arange(64 * 64, dtype=torch.int32, device=cuda_device).reshape(-1, mega.LANES)
    r, g, b, rays = mega_bvh.render_mega_bvh_rows_ref(ts, cfg, pix, 0)
    ref = (torch.stack([r, g, b], -1).reshape(64, 64, 3) / cfg.spp).cpu().numpy()
    assert_mega_gates(ref, got.cpu().numpy(), float(rays.double().sum()), rays_got)


@pytest.mark.parametrize("mode", ["uniform", "power"])
def test_k4_frames_on_held_tables(cuda_device, mode, monkeypatch):  # noqa: F811
    """Two K4 frames of one scene: the first packs its tables, the second
    is served the held set (mega_bvh.launch_tables); each equals, bit for
    bit, the same frame launched on tables packed afresh."""
    from gpuspectral_tpu_torch.utils import profiling

    ts = _scene("sphere_field", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, use_bvh=True,
                       light_sampling=mode)
    profiling.reset()
    held = [mega_bvh.render_mega_bvh(ts, cfg, t) for t in (0, 1)]
    assert profiling.calls("mega_bvh.tables.packed") == 1
    assert profiling.calls("mega_bvh.tables.reused") == 1
    monkeypatch.setattr(mega_bvh, "launch_tables", mega_bvh._pack)
    fresh = [mega_bvh.render_mega_bvh(ts, cfg, t) for t in (0, 1)]
    assert profiling.calls("mega_bvh.tables.packed") == 1
    assert launches(mega_bvh.render_mega_bvh_rows) == 4
    for (img, rays), (img_f, rays_f) in zip(held, fresh):
        assert torch.equal(img, img_f) and rays == rays_f
    assert not torch.equal(held[0][0], held[1][0])


def test_wavefront_on_k3_matches_plain_scans(cuda_device):  # noqa: F811
    ts = _scene("sphere_field", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, ray_batch=4096, use_bvh=True,
                       sort_rays=True)
    n0 = launches(ftb.ftb_closest)
    got, rays_got = pt.render_image_stats(ts, cfg, 0)
    assert launches(ftb.ftb_closest) > n0
    ref, rays_ref = pt.render_image_stats(ts, cfg.replace(intersector="woop"), 0,
                                          bvh_isect=pt.PLAIN_K3)
    assert_mega_gates(ref.cpu().numpy(), got.cpu().numpy(), rays_ref, rays_got,
                      max_frac=0.001)


def test_run_benchmark_reports_the_card(cuda_device):  # noqa: F811
    import argparse

    from gpuspectral_tpu_torch.utils.bench import run_benchmark

    args = argparse.Namespace(
        scene=str(CORNELL_XML), size="64x64", spp=2, depth=5, no_nee=False, jitter=False,
        ray_batch=4096, bvh=None, bvh_kernel="ftb", light_block=None, packet_size=1024,
        intersector="auto", light_sampling="uniform", mis="reference", device="cuda",
        warmup=1, iters=2)
    n0 = launches(mega.render_mega_rows)
    out = run_benchmark(args)
    assert launches(mega.render_mega_rows) >= n0 + 3
    assert out["backend"] == "cuda" and out["device"] == torch.cuda.get_device_name()
    assert out["rays_traced"] > 64 * 64 * 2 and out["mrays_per_s"] > 0


def _grad_gates(got, ref, spp, rays=True):
    """K5 / K6 against the plain version: the image under the tests/test_mega.py
    gates, rays within 1% (unless `rays` is false), and the partials
    contracted with a fixed numpy cotangent within 2e-3 of the plain
    version's (tests/test_mega_grad.py's tolerance: a path that crosses a
    seam on a rounding moves its terms)."""
    img = (torch.stack(got[:3], -1).reshape(-1, 3) / spp).cpu().numpy()
    img_ref = (torch.stack(ref[:3], -1).reshape(-1, 3) / spp).cpu().numpy()
    assert_mega_gates(img_ref, img, *((float(ref[3].double().sum()),
                                       float(got[3].double().sum())) if rays else ()))
    n = img.shape[0]
    ct = torch.as_tensor(np.random.default_rng(5).uniform(-1, 1, (n, 3)).astype(np.float32),
                         device=got[4].device)
    cidx = torch.arange(got[4].shape[0], device=ct.device) % 3
    cg = (got[4].reshape(got[4].shape[0], -1) * ct.t()[cidx]).sum(1)
    cr = (ref[4].reshape(ref[4].shape[0], -1) * ct.t()[cidx]).sum(1)
    assert float(cr.abs().max()) > 0
    assert float((cg - cr).abs().max()) <= 2e-3 * float(cr.abs().max())


def test_k5_matches_plain_version(cuda_device):  # noqa: F811
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    ts = _scene("cornell", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4)
    pix = mg.pix_rows(cfg, cuda_device)
    n0 = launches(mg.render_mega_fwdgrad_rows)
    got = mg.render_mega_fwdgrad_rows(ts, cfg, pix, 0)
    assert launches(mg.render_mega_fwdgrad_rows) == n0 + 1
    _grad_gates(got, mg.render_mega_fwdgrad_rows_ref(ts, cfg, pix, 0), cfg.spp)
    # K5's image is K1's (the hook only reads)
    k1 = mega.render_mega_rows(ts, cfg, pix, 0)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], k1))


def _brute_scene(name, dev):
    """Scenes at K1 / K5's edges: Cornell; one emitting triangle (three zero
    rows pad its staged Woop rows to the unroll); a 2,048-triangle soup
    under a quad light (96 KB of staged rows, past the 48 KB that a CTA
    gets without the attribute)."""
    from chip_smoke import soup_scene

    if name == "one_triangle":
        b = tdata.SceneBuilder()
        tri = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
        nrm = np.broadcast_to(np.array([0, 0, 1], np.float32), (1, 3, 3)).copy()
        b.add_object(tri, nrm, None, np.eye(4, dtype=np.float32), b.add_bsdf(diffuse((0.5,) * 3)),
                     emission=(4.0, 4.0, 4.0))
        b.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 3], [0, 0, 0, 1]],
                              np.float32), np.deg2rad(60))
        return b.build(dev)
    if name == "soup2048":
        return soup_scene(2046, 5, dev, light=True)
    return _scene("cornell", dev)


def _brute_launch(kernel):
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    if kernel == "k1":
        return mega.render_mega_rows, mega.render_mega_rows_ref, mega._launch
    return mg.render_mega_fwdgrad_rows, mg.render_mega_fwdgrad_rows_ref, mg._launch_k5


def _brute_gates(kernel, got, ref, spp, rays=True):
    if kernel == "k1":
        img = (torch.stack(got[:3], -1).reshape(-1, 3) / spp).cpu().numpy()
        img_ref = (torch.stack(ref[:3], -1).reshape(-1, 3) / spp).cpu().numpy()
        assert_mega_gates(img_ref, img, *((float(ref[3].double().sum()),
                                           float(got[3].double().sum())) if rays else ()))
    else:
        _grad_gates(got, ref, spp, rays=rays)


@pytest.mark.parametrize("kernel", ["k1", "k5"])
@pytest.mark.parametrize("name", ["cornell", "one_triangle", "soup2048"])
def test_k1_k5_scenes_at_the_edges(cuda_device, kernel, name):  # noqa: F811
    """K1 / K5 over a 64x64 frame against the plain version, at one triangle
    and at the 2,048-triangle limit; the schedule of lanes changes nothing:
    a grid of 1 or 3 resident CTAs (each thread takes its next lane from the
    counter many times over) and a second launch give the same sums bit for
    bit.  On the lone emitting triangle, NEE from a hit samples that same
    triangle: the light direction lies in the hit's own plane, so whether
    the shadow ray is cast (dot(gn, ldir) > 0) is a rounding coin flip that
    the kernel's and torch's op orders call differently for many hits; the
    ray counts are not compared there (the radiance those rays carry is
    ~0: the light's cosine is ~0 too)."""
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    ts = _brute_scene(name, cuda_device)
    assert ts.num_tris == {"cornell": 36, "one_triangle": 1, "soup2048": 2048}[name]
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4)
    assert mg.mega_grad_eligible(ts, cfg)
    wrapper, plain, launch = _brute_launch(kernel)
    pix = mega.pix_rows(cfg, cuda_device)
    n0 = launches(wrapper)
    got = wrapper(ts, cfg, pix, 0)
    assert launches(wrapper) == n0 + 1
    # a tenth of the lanes or more trace past their camera rays: their paths
    # hit the scene (38% on the soup in the plain version at 32x32 on the
    # CPU; the lone triangle covers ~17% of the frame)
    assert float((got[3] > cfg.spp).double().mean()) > 0.1
    _brute_gates(kernel, got, plain(ts, cfg, pix, 0), cfg.spp, rays=name != "one_triangle")
    for again in (wrapper(ts, cfg, pix, 0), launch(ts, cfg, pix, 0, max_ctas=1),
                  launch(ts, cfg, pix, 0, max_ctas=3)):
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("kernel", ["k1", "k5"])
@pytest.mark.parametrize("rows", [1, 3, 2049])
def test_k1_k5_odd_row_counts(cuda_device, kernel, rows):  # noqa: F811
    """1, 3 and 2,049 rows of 128 lanes (the last more lanes than the card
    holds at once, so threads take further lanes from the counter), the
    lanes over a 64x64 frame's pixels in raster order and round again: each
    lane's sums and planes equal those of the same pixel in the launch over
    the frame, bit for bit (padding lanes write their own slots), and the
    2,049 rows pass the plain version's gates."""
    ts = _scene("cornell", cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4)
    wrapper, plain, _ = _brute_launch(kernel)
    n_pix = cfg.width * cfg.height
    pix = (torch.arange(rows * mega.LANES, dtype=torch.int32, device=cuda_device) % n_pix)
    pix = pix.reshape(rows, mega.LANES)
    got = wrapper(ts, cfg, pix, 0)
    frame = wrapper(ts, cfg, mega.pix_rows(cfg, cuda_device), 0)
    idx = pix.reshape(-1).long()
    for a, b in zip(got[:4], frame[:4]):
        assert torch.equal(a.reshape(-1), b.reshape(-1)[idx])
    if kernel == "k5":
        npl = frame[4].shape[0]
        assert torch.equal(got[4].reshape(npl, -1), frame[4].reshape(npl, -1)[:, idx])
    if rows == 2049:
        _brute_gates(kernel, got, plain(ts, cfg, pix, 0), cfg.spp)


@pytest.mark.parametrize("name", ["slot_mode", "sphere_field_noenv", "mixed", "textured",
                                  "soup_morton"])
def test_k6_matches_plain_version(cuda_device, name, monkeypatch):  # noqa: F811
    from chip_smoke import soup_scene
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)  # a multi-bin build
    if name == "slot_mode":
        ts = _scene("cornell", cuda_device)
    elif name == "sphere_field_noenv":
        ts = build_sphere_field(cuda_device, n_side=2, segs=16, rings=8, sky_hw=None)
    elif name == "mixed":
        ts = mixed_bsdf_scene(tdata.SceneBuilder())[0].build(cuda_device)
    elif name == "soup_morton":
        ts = soup_scene(600, 5, cuda_device, order="morton", light=True)
    else:
        ts = textured_diffuse_scene(tdata.SceneBuilder()).build(cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4, use_bvh=True)
    assert mg.mega_bvh_grad_eligible(ts, cfg)
    pix = mg.pix_rows(cfg, cuda_device)
    n0 = launches(mg.render_mega_bvh_fwdgrad_rows)
    got = mg.render_mega_bvh_fwdgrad_rows(ts, cfg, pix, 0)
    assert launches(mg.render_mega_bvh_fwdgrad_rows) == n0 + 1
    _grad_gates(got, mg.render_mega_bvh_fwdgrad_rows_ref(ts, cfg, pix, 0), cfg.spp)
    k4 = mega_bvh.render_mega_bvh_rows(ts, cfg, pix, 0)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], k4))


def _diff_rays(dev, seed=3, r=1 << 14):
    o, d, _, hi = _rays(seed, r, dev)
    return o.requires_grad_(True), d.requires_grad_(True), hi


def _vjp(t, u, v, o, d, seed=9):
    g = np.random.default_rng(seed).normal(size=(3, t.shape[0])).astype(np.float32)
    g = torch.as_tensor(g, device=t.device)
    hit = t < 1e29
    loss = (torch.where(hit, t, 0.0) * g[0] + u * g[1] + v * g[2]).sum()
    return torch.autograd.grad(loss, (o, d))


@pytest.mark.parametrize("kind", ["k2a", "k3a", "k7d", "k7a", "k7h"])
def test_closest_diff_matches_plain_version(cuda_device, kind):  # noqa: F811
    """The autograd wrappers of K2a / K3a / K7d / K7a / K7h on the card against
    the same wrappers on the CPU (the plain forward, the same torch
    backward)."""
    ts = _scene("cornell" if kind == "k2a" else "sphere_field", cuda_device)
    cpu = _scene("cornell" if kind == "k2a" else "sphere_field", "cpu")
    out = {}
    for dev, sc in ((cuda_device, ts), (torch.device("cpu"), cpu)):
        o, d, hi = (x.detach().to(dev) for x in _diff_rays(cuda_device))
        o.requires_grad_(True)
        d.requires_grad_(True)
        if kind == "k2a":
            t, prim, u, v = ci.closest_diff(o, d, sc.tri_woop_t, sc.tri_woop, hi)
        elif kind == "k3a":
            t, prim, u, v, _ = ftb.ftb_closest_diff(sc, o, d)
        elif kind == "k7d":
            t, prim, u, v, _ = cs.cluster_closest_diff(sc, o, d)
        elif kind == "k7a":
            t, prim, u, v, _ = tb.binned_closest_diff(sc, o, d)
        else:
            t, prim, u, v = tk.traverse_closest_diff(o, d, *_tree(sc), torch.zeros_like(hi), hi)
        out[dev.type] = (prim.cpu(), [x.cpu() for x in (t, u, v)],
                         [x.cpu() for x in _vjp(t, u, v, o, d)])
    (p1, f1, g1), (p2, f2, g2) = out["cuda"], out["cpu"]
    same = p1 == p2
    assert int((~same).sum()) <= 2 and int((p2 >= 0).sum()) > 1000
    for a, b in zip(f1, f2):
        assert torch.allclose(a[same], b[same], rtol=1e-6, atol=1e-6)
    rows = same[:, None].expand(-1, 3)
    for a, b in zip(g1, g2):
        assert torch.allclose(a[rows], b[rows], rtol=1e-5, atol=1e-5)


def test_render_mega_diff_on_card(cuda_device):  # noqa: F811
    """Autograd through K5 on the card against the plain version on the CPU."""
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        ts = _scene("cornell", dev)
        p = ts.bsdf_params.clone().requires_grad_(True)
        le = ts.light_emission.clone().requires_grad_(True)
        img = mg.render_mega_diff(ts.replace(bsdf_params=p, light_emission=le),
                                  RenderConfig(width=32, height=32, spp=2, max_depth=3), 0)
        (img * torch.arange(3.0, device=dev)).sum().backward()
        grads[dev.type] = (p.grad.cpu(), le.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


def test_run_grad_benchmark_reports_the_card(cuda_device):  # noqa: F811
    from gpuspectral_tpu_torch.integrator import mega_grad as mg
    from gpuspectral_tpu_torch.utils.bench import run_grad_benchmark

    n0 = launches(mg.render_mega_fwdgrad_rows)
    out = run_grad_benchmark(str(CORNELL_XML), size=64, spp=2, depth=5, steps=2)
    assert launches(mg.render_mega_fwdgrad_rows) == n0 + 3
    assert out["kernel"] == "mega" and out["device"] == torch.cuda.get_device_name()
    assert out["grad_steps_per_s"] > 0 and out["peak_hbm_gb"] > 0


@pytest.mark.parametrize("bvh_kernel", ["ftb", "cluster", "binned"])
def test_run_grad_benchmark_wavefront_path(cuda_device, bvh_kernel):  # noqa: F811
    """A scene neither fused kernel takes (an environment emitter): the
    step runs the differentiable wavefront on the BVH kernels it names,
    K3a / K3b, K7c-e or K7a / K7b."""
    from gpuspectral_tpu_torch.utils.bench import run_grad_benchmark

    wrapper = dict(ftb=ftb.ftb_closest, cluster=cs.cluster_closest,
                   binned=tb.binned_closest)[bvh_kernel]
    n0 = launches(wrapper)
    out = run_grad_benchmark("builtin:sphere_field", size=16, spp=2, depth=2, steps=1,
                             use_bvh=True, bvh_kernel=bvh_kernel)
    assert out["kernel"] == "wavefront" and launches(wrapper) > n0
    assert out["grad_steps_per_s"] > 0
