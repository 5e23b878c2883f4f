"""PyTorch port: the plain versions of the cluster sweep (bvh/cluster_sweep.py:
K7c votes, K7d closest, K7e any hit) against the JAX package's cluster
sweep in interpret mode, on Cornell, a 3000-triangle soup (a slot-mode
build) and the small sphere field; the differentiable closest hit against
JAX dfs_sweep.closest_diff(kernel="cluster"); and the wavefront with
bvh_kernel "cluster" against the JAX wavefront.  Both packages get the same
scene tables (scene_from_arrays of the JAX scene) and the same numpy rays.
Then the premise of the kernels' design (csrc/cluster.cu): a walk of one
warp at a time that gates each voted supernode and leaf cluster by the
ray's own widened slab test, as K7d / K7e do, gives the plain versions'
results bit for bit, and gated_tests counts its tests.
The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.bvh import cluster_sweep as jcs
from gpuspectral_tpu.bvh import dfs_sweep as jdfs
from gpuspectral_tpu.integrator.path_tracer import render_sample as jax_render_sample
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.ops import woop
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field
from gpuspectral_tpu_torch.utils import RenderConfig

from chip_smoke import odd_lanes, soup_scene
from test_binned import _random_scene
from test_torch_bvh import SMALL_FIELD
from test_torch_bvh_pack import _inv, _slab
from torch_common import assert_mega_gates, jax_scene_arrays, launches

SCENES = ["cornell", "soup3000", "sphere_field"]


@pytest.fixture(scope="module")
def pairs(cornell_scene):
    """(JAX scene, the port's scene from the same tables) by name."""
    out = {}
    for name, js in (("cornell", cornell_scene), ("soup3000", _random_scene(3000)),
                     ("sphere_field", populate_sphere_field(JaxBuilder(), **SMALL_FIELD).build())):
        out[name] = (js, scene_from_arrays(*jax_scene_arrays(js), "cpu"))
    return out


def _rays(scene, n, seed):
    """Origins around the scene's box, unit directions, and segments: half
    from 0 to 1e30, half short; a tenth of the rays inactive (t_max -1e30)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.bvh_node_min[0]) - 0.2
    hi = np.asarray(scene.bvh_node_max[0]) + 0.2
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 0.3, n)).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.5, 1e30, rng.uniform(0.5, 4.0, n)).astype(np.float32)
    t_max[rng.uniform(size=n) < 0.1] = -1e30
    return o, d.astype(np.float32), t_min, t_max


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", SCENES)
def test_supernode_tables_equal_jax(pairs, name):
    js, ts = pairs[name]
    ref = jcs._supernode_tables(js.bvh_node_min, js.bvh_node_max, js.bvh_clusters,
                                js.tri_woop_t.shape[1], js.bvh_leaf_size)
    got = cs.supernode_tables(ts.bvh_node_min, ts.bvh_node_max, ts.bvh_clusters,
                              ts.padded_tris, ts.bvh_leaf_size)
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2:] == tuple(int(x) for x in ref[2:])
    # padding supernodes are far point boxes, never inverted bounds
    assert bool((got[0] <= got[1]).all())


@pytest.mark.parametrize("odd", [False, True], ids=["clean", "odd_lanes"])
@pytest.mark.parametrize("name", SCENES)
def test_votes_equal_jax(pairs, name, odd):
    """The plain votes against JAX _prepare's; with odd_lanes (NaN origin
    and direction components, inactive lanes) a NaN lane votes for nothing
    in both: jnp.maximum and torch.maximum keep the NaN."""
    js, ts = pairs[name]
    o, d, t_min, t_max = _rays(js, 700, 1)
    if odd:
        o, d, t_min, t_max = (x.numpy() for x in odd_lanes([_t(x) for x in (o, d, t_min, t_max)]))
        assert np.isnan(o).any() and np.isnan(d).any()
    out = jcs._prepare(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                       jnp.asarray(t_max), interpret=True)
    s = out[8]
    ref = np.asarray(out[1])[::8, :s]  # one (8, Sp) row group per block of rays
    got = cs.cluster_votes(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, s)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.sum()) > 0


@pytest.mark.parametrize("name", SCENES)
def test_plain_closest_matches_jax(pairs, name):
    """The gates of tests/test_cluster_sweep.py.  prim may differ only at
    exact-t ties: the JAX kernel keeps one best per lane and breaks a tie
    between lanes by lane position, the port takes the lowest slot."""
    js, ts = pairs[name]
    o, d, _, t_max = _rays(js, 600, 2)
    attr = jdfs._attr_table(js, js.has_textures)
    t_j, prim_j, u_j, v_j, attrs_j = (np.asarray(x) for x in jcs.cluster_closest_tmax(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True, attr=attr))
    n0 = launches(cs.cluster_closest)
    t, prim, u, v, attrs = (x.numpy() for x in cs.cluster_closest(ts, _t(o), _t(d),
                                                                   t_max=_t(t_max)))
    assert launches(cs.cluster_closest) == n0  # the plain version on the CPU
    hit_j = prim_j >= 0
    assert hit_j.sum() > 50
    np.testing.assert_array_equal(prim >= 0, hit_j)
    np.testing.assert_allclose(t[hit_j], t_j[hit_j], rtol=1e-5, atol=1e-5)
    assert (t[~hit_j] == 1e30).all() and (attrs[~hit_j] == 0).all()
    same = prim == prim_j
    assert np.mean(~same) < 0.01
    assert (t[~same] == t_j[~same]).all()  # a differing prim is an exact tie
    np.testing.assert_allclose(u[same], u_j[same], atol=1e-4)
    np.testing.assert_allclose(v[same], v_j[same], atol=1e-4)
    # attrs: exactly the winning slot's row of the port's table, and the JAX
    # kernel's row within a float rounding (XLA fuses the geometric normal's
    # and the area's arithmetic)
    keep = same & hit_j
    np.testing.assert_array_equal(attrs[keep], ftb.attr_table(ts).numpy()[prim_j[keep]])
    np.testing.assert_allclose(attrs[keep], attrs_j[keep], rtol=1e-6, atol=1e-6)
    # against the exact closest hit: votes lose a hit only at a box's edge
    full = ftb.ftb_closest_ref(ts, _t(o), _t(d), t_max=_t(t_max))
    assert int((full[1].numpy() != prim).sum()) <= 2


@pytest.mark.parametrize("name", SCENES)
def test_plain_any_matches_jax(pairs, name):
    js, ts = pairs[name]
    o, d, t_min, t_max = _rays(js, 600, 3)
    occ_j = np.asarray(jcs.cluster_any(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                                       jnp.asarray(t_max), interpret=True))
    occ = cs.cluster_any(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    assert 50 < occ_j.sum() < 550
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    # scalar segment ends, as the wavefront's shadow rays pass t_min
    occ_s = cs.cluster_any(ts, _t(o), _t(d), 0.01, 2.0)
    occ_sj = jcs.cluster_any(js, jnp.asarray(o), jnp.asarray(d), 0.01, 2.0, interpret=True)
    np.testing.assert_array_equal(occ_s.numpy(), np.asarray(occ_sj))


def test_active_mask(pairs):
    js, ts = pairs["sphere_field"]
    o, d, t_min, _ = _rays(js, 512, 4)
    active = torch.arange(512) % 3 != 0
    t, prim, u, v, attrs = cs.cluster_closest(ts, _t(o), _t(d), active=active)
    assert (prim[~active] == -1).all() and (t[~active] == 1e30).all()
    assert (u[~active] == 0).all() and (attrs[~active] == 0).all()
    _, prim_j, _, _ = jcs.cluster_closest(js, jnp.asarray(o), jnp.asarray(d),
                                          active=jnp.asarray(active.numpy()), interpret=True)
    np.testing.assert_array_equal(prim.numpy() >= 0, np.asarray(prim_j) >= 0)
    occ_all = cs.cluster_any(ts, _t(o), _t(d), _t(t_min), 3.0)
    occ = cs.cluster_any(ts, _t(o), _t(d), _t(t_min), 3.0, active=active)
    assert not occ[~active].any() and torch.equal(occ[active], occ_all[active])
    # the votes of inactive rays: a block of them votes for nothing
    idle = cs.cluster_votes(ts, _t(o), _t(d), 0.0, 1e30, active=torch.zeros(512, dtype=torch.bool))
    assert int(idle.sum()) == 0


def test_wrappers_check_their_inputs(pairs):
    _, ts = pairs["cornell"]
    o, d, _, t_max = (_t(x) for x in _rays(ts, 300, 5))
    with pytest.raises(ValueError, match="votes"):
        cs.cluster_closest(ts, o, d, votes=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        cs.cluster_any(ts, o[:, :2].contiguous(), d, 0.0, t_max)


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_closest_diff_grads_match_jax(pairs, name):
    """d(sum of weighted t, u, v)/d(o, d) through cluster_closest_diff
    against jax.grad through dfs_sweep.closest_diff(kernel="cluster"),
    over the rays whose hit is the same triangle."""
    js, ts = pairs[name]
    o, d, _, _ = _rays(js, 256, 6)
    w = np.random.default_rng(7).normal(size=(3, 256)).astype(np.float32)
    active = np.arange(256) % 5 != 0

    def loss_j(oo, dd):
        t, prim, u, v, _ = jdfs.closest_diff(js, oo, dd, active=jnp.asarray(active),
                                             kernel="cluster")
        m = (prim >= 0).astype(jnp.float32)
        return jnp.sum(m * (w[0] * jnp.where(prim >= 0, t, 0.0) + w[1] * u + w[2] * v))

    go_j, gd_j = (np.asarray(g) for g in jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(o), jnp.asarray(d)))
    prim_j = np.asarray(jdfs.closest_diff(js, jnp.asarray(o), jnp.asarray(d),
                                          active=jnp.asarray(active), kernel="cluster")[1])
    ot, dt = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    t, prim, u, v, attrs = cs.cluster_closest_diff(ts, ot, dt, active=_t(active))
    assert not attrs.requires_grad
    m = (prim >= 0).to(torch.float32)
    wt = _t(w)
    loss = (m * (wt[0] * torch.where(prim >= 0, t, 0.0) + wt[1] * u + wt[2] * v)).sum()
    go, gd = (g.numpy() for g in torch.autograd.grad(loss, (ot, dt)))
    same = prim.numpy() == prim_j
    assert same.mean() > 0.99 and (prim_j >= 0).sum() > 50
    for a, b in ((go, go_j), (gd, gd_j)):
        scale = np.abs(b).max()
        assert np.abs(a[same] - b[same]).max() <= 1e-5 * scale


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_wavefront_matches_jax(pairs, name):
    """The BVH wavefront with bvh_kernel "cluster" (16x16, depth 3,
    intersector "pallas": the plain K7c-e on the CPU) against the JAX
    wavefront at the same config and timestamps: 2 spp on Cornell, 1 on the
    textured sphere field under its sky."""
    js, ts = pairs[name]
    base = dict(width=16, height=16, max_depth=3, use_bvh=True, intersector="pallas",
                bvh_kernel="cluster")
    pix = np.arange(256, dtype=np.uint32)
    n0 = launches(cs.cluster_closest)
    for spp_ts in (3, 4) if name == "cornell" else (3,):
        ref, rays_ref = jax_render_sample(js, JaxConfig(**base), jnp.asarray(pix),
                                          jnp.uint32(spp_ts))
        got, rays_got = pt.render_sample(ts, RenderConfig(**base),
                                         torch.as_tensor(pix.astype(np.int64)), spp_ts)
        assert_mega_gates(np.asarray(ref)[:, None], got.numpy()[:, None],
                          float(np.asarray(rays_ref).sum()), float(rays_got.sum()))
    assert launches(cs.cluster_closest) == n0


def test_wavefront_dispatch_reaches_the_cluster_wrappers(pairs, monkeypatch):
    """The wavefront, the differentiable wavefront of diff/gradcheck and the
    sort options call the cluster wrappers for bvh_kernel "cluster" (and the
    ftb wrappers never): they are looked up by name on their module."""
    from gpuspectral_tpu_torch.diff import gradcheck as tgc

    _, ts = pairs["cornell"]
    calls = dict(closest=0, closest_diff=0, any=0)
    for key, name in (("closest", "cluster_closest"), ("closest_diff", "cluster_closest_diff"),
                      ("any", "cluster_any")):
        real = getattr(cs, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(cs, name, spy)
    for name in ("ftb_closest", "ftb_closest_diff", "ftb_any"):
        monkeypatch.setattr(ftb, name, lambda *a, **kw: pytest.fail("ftb called"))
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2, ray_batch=128, use_bvh=True,
                       intersector="pallas", bvh_kernel="cluster", sort_rays=True,
                       shadow_sort=True)
    img, rays = pt.render_image_stats(ts, cfg, 0)
    assert bool(torch.isfinite(img).all()) and rays > 0
    assert calls["closest"] > 0 and calls["any"] > 0 and calls["closest_diff"] == 0
    loss, g = tgc._loss_and_grad(ts, cfg, ts.bsdf_params, np.zeros((64, 3), np.float32))
    assert calls["closest_diff"] > 0 and bool(torch.isfinite(g).all())


def test_wavefront_builds_the_supernodes_once(pairs, monkeypatch):
    """The wavefront builds the supernode tables once per batch of lanes
    and hands them to every wrapper call, which then builds none."""
    _, ts = pairs["cornell"]
    builds = []
    real = cs.scene_supernodes
    monkeypatch.setattr(cs, "scene_supernodes", lambda scene: builds.append(1) or real(scene))
    given = []
    for name in ("cluster_closest", "cluster_any"):
        wrapper = getattr(cs, name)

        def spy(*a, _wrapper=wrapper, **kw):
            given.append(isinstance(kw.get("supernodes"), cs.Supernodes))
            return _wrapper(*a, **kw)

        monkeypatch.setattr(cs, name, spy)
    cfg = RenderConfig(width=16, height=8, spp=2, max_depth=3, ray_batch=64, use_bvh=True,
                       intersector="pallas", bvh_kernel="cluster")
    pt.render_image_stats(ts, cfg, 0)
    assert len(given) > 4 and all(given)
    assert len(builds) == 2  # two batches of 64 lanes, a lane per pixel


def _passes(ts, sn, o, d, lo, hi):
    """(R, S) bool: each ray's slab test against each supernode, one ray
    at a time."""
    return torch.stack([cs.cluster_votes_ref(ts, o[i:i + 1], d[i:i + 1], lo[i:i + 1],
                                             hi[i:i + 1], supernodes=sn)[0] > 0
                        for i in range(o.shape[0])])


@pytest.mark.parametrize("name", SCENES)
def test_vote_tests_count_up_to_the_first_pass(pairs, name):
    """K7c's slab tests per (block, supernode): the rays up to and
    including the first that passes, else all 256 (padding rays too)."""
    _, ts = pairs[name]
    o, d, t_min, t_max = (_t(x) for x in _rays(ts, 300, 8))
    sn = cs.scene_supernodes(ts)
    got = cs.vote_tests(ts, o, d, t_min, t_max, supernodes=sn)
    passes = _passes(ts, sn, o, d, t_min, t_max)
    assert tuple(got.shape) == (2, sn.s)
    for b in range(2):
        block = passes[b * cs.BLOCK:(b + 1) * cs.BLOCK]
        for s in range(sn.s):
            hits = torch.nonzero(block[:, s])[:, 0]
            assert int(got[b, s]) == (int(hits[0]) + 1 if hits.numel() else cs.BLOCK)
    votes = cs.cluster_votes(ts, o, d, t_min, t_max)
    assert torch.equal(votes > 0, torch.stack([passes[:256].any(0), passes[256:].any(0)]))
    assert bool((got[votes == 0] == cs.BLOCK).all()) and bool((got[votes > 0] < cs.BLOCK).any())


@pytest.mark.parametrize("rays", ["clean", "odd_lanes", "sparse_lanes"])
@pytest.mark.parametrize("name", SCENES)
def test_bundle_vote_tests_give_the_plain_votes(pairs, name, rays):
    """bundle_vote_tests, K7c's warp schedule in torch (a warp with no live
    ray skipped, each other warp's live rays culled as one bundle, their
    exact slab tests on the supernodes not culled, the OR over the block's
    warps): its votes equal cluster_votes_ref's, and JAX _prepare's, on
    clean rays, with NaN and inactive lanes, and with ~5% of the lanes live;
    only a warp of more than DIRECT live rays makes a bundle test, one a
    supernode, a live warp at most one exact test a live ray, and every vote
    comes from an exact test."""
    from chip_smoke import sparse_lanes

    js, ts = pairs[name]
    o, d, t_min, t_max = (_t(x) for x in _rays(js, 900, 14))
    if rays != "clean":
        o, d, t_min, t_max = (odd_lanes if rays == "odd_lanes" else sparse_lanes)(
            [o, d, t_min, t_max])
    sn = cs.scene_supernodes(ts)
    got = cs.bundle_vote_tests(ts, o, d, t_min, t_max, supernodes=sn)
    ref = cs.cluster_votes_ref(ts, o, d, t_min, t_max, supernodes=sn)
    assert torch.equal(got.votes, ref) and int(ref.sum()) > 0
    out = jcs._prepare(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                       jnp.asarray(t_min.numpy()), jnp.asarray(t_max.numpy()), interpret=True)
    np.testing.assert_array_equal(got.votes.numpy(), np.asarray(out[1])[::8, :sn.s])
    live = cs.live_rays(o, cs.inv_dir_nan(d), t_min, t_max)
    lanes = torch.cat([live, live.new_zeros(-900 % cs.BLOCK)]).reshape(-1, 8, 32).sum(2)
    assert torch.equal(got.skipped, (lanes == 0).sum(1))
    assert bool((got.bundle <= (lanes > cs.DIRECT).sum(1, keepdim=True)).all())
    assert bool((got.exact <= lanes.sum(1, keepdim=True)).all())
    assert bool((got.exact[ref > 0] > 0).all())
    if rays == "sparse_lanes":
        assert int(got.skipped.sum()) > 0


@pytest.mark.parametrize("name", SCENES)
def test_sweep_tests_count_the_voted_slots(pairs, name):
    """K7d's Woop tests per ray: every slot of the supernodes its block
    voted for, none for an empty segment; K7e's: those slots in order up to
    and including the ray's first occluder, which the plain any hit agrees
    with."""
    _, ts = pairs[name]
    o, d, t_min, t_max = (_t(x) for x in _rays(ts, 300, 9))
    sn = cs.scene_supernodes(ts)
    votes = cs.cluster_votes(ts, o, d, t_min, t_max, supernodes=sn)
    n_slots = ts.tri_woop_t.shape[1]
    closest, occ_c = cs.sweep_tests(ts, o, d, t_min, t_max, votes, False, supernodes=sn)
    tests, occ = cs.sweep_tests(ts, o, d, t_min, t_max, votes, True, supernodes=sn)
    assert not occ_c.any()
    assert torch.equal(occ, cs.cluster_any_ref(ts, o, d, t_min, t_max, votes=votes))
    assert 0 < int(occ.sum()) < 300
    for i in range(300):
        slots = [j for s in torch.nonzero(votes[i // cs.BLOCK])[:, 0].tolist()
                 for j in range(s * sn.stride, min((s + 1) * sn.stride, n_slots))]
        if not t_max[i] > t_min[i]:
            assert int(closest[i]) == 0 and int(tests[i]) == 0
            continue
        assert int(closest[i]) == len(slots)
        hit = woop._chunk_t(o[i:i + 1], d[i:i + 1], ts.tri_woop[slots], t_min[i:i + 1],
                            t_max[i:i + 1])[0] < 1e30
        first = torch.nonzero(hit)[:, 0]
        assert int(tests[i]) == (int(first[0]) + 1 if first.numel() else len(slots))


# ------------------------------------ the two-gate sweep of K7d / K7e ----
GATED = ["cornell", "soup3000", "sphere_field", "soup_ties"]


def _gated_scene(pairs, name):
    """The port's scene: one of `pairs`, or a soup of exact-t twins."""
    return soup_scene(600, 5, "cpu", ties=True) if name == "soup_ties" else pairs[name][1]


def _warp_walk(ts, sn, o, d, lo, hi, votes, any_hit):
    """csrc/cluster.cu's K7d (any_hit False, on (0, hi): lo 0) or K7e, one
    warp of 32 rays at a time, op for op: for each supernode the block
    voted for, in order, each lane's widened slab test on (lo, best) (the
    closest hit) or (lo, hi); where some lane enters it, each non-empty leaf
    cluster's the same way; where some lane enters a cluster, the Woop test
    of each slot in order for the lanes that entered it, a strict `<`
    against best.  An any-hit lane stops at its first occluder, the warp
    when no lane is left.  Returns ((t, prim, u, v, attrs) or occ, the
    slab tests and the Woop tests per ray, the supernodes each warp
    sweeps, the slots some lane Woop-tests)."""
    r = o.shape[0]
    n_slots, leaf = ts.tri_woop.shape[0], ts.bvh_leaf_size
    k = sn.stride // leaf
    c_lo, c_hi, c_empty = cs.cluster_boxes(ts)
    inv = cs.inv_dir(d)
    best, prim = hi.clone(), torch.full((r,), -1, dtype=torch.int32)
    occ = torch.zeros((r,), dtype=torch.bool)
    slab = torch.zeros((r,), dtype=torch.int64)
    tests = torch.zeros((r,), dtype=torch.int64)
    swept = torch.zeros((-(-r // 32),), dtype=torch.int64)
    read = torch.zeros((n_slots,), dtype=torch.bool)
    for w0 in range(0, r, 32):
        w = slice(w0, min(w0 + 32, r))
        wo, wd, wi, wl, wh = o[w], d[w], inv[w], lo[w], hi[w]
        b, wp, wocc = best[w].clone(), prim[w].clone(), occ[w].clone()
        todo = wh > wl
        for s in torch.nonzero(votes[w0 // cs.BLOCK])[:, 0].tolist():
            if not todo.any():
                break
            slab[w][todo] += 1
            go = todo & cs.slab_entered(sn.blo[:, s], sn.bhi[:, s], wo, wi, wl,
                                        wh if any_hit else b)
            swept[w0 // 32] += int(go.any())
            for c in range(s * k, min((s + 1) * k, c_lo.shape[0])):
                if not go.any():
                    break
                if c_empty[c]:
                    continue
                slab[w][go] += 1
                cin = go & cs.slab_entered(c_lo[c], c_hi[c], wo, wi, wl, wh if any_hit else b)
                for slot in range(c * leaf, min((c + 1) * leaf, n_slots)):
                    if not cin.any():
                        break
                    tests[w][cin] += 1
                    read[slot] = True
                    t = woop._chunk_t(wo, wd, ts.tri_woop[slot:slot + 1], wl,
                                      wh if any_hit else b)[:, 0]
                    hit = cin & (t < 1e30)
                    if any_hit:
                        wocc |= hit
                        todo, go, cin = todo & ~hit, go & ~hit, cin & ~hit
                    else:
                        b = torch.where(hit, t, b)
                        wp = torch.where(hit, slot, wp)
        best[w], prim[w], occ[w] = b, wp, wocc
    if any_hit:
        return occ, slab, tests, swept, read
    t = torch.where(prim >= 0, best, 1e30)
    u, v = woop._recover_uv(o, d, ts.tri_woop, prim, torch.where(prim >= 0, best, 0.0))
    u, v = torch.where(prim >= 0, u, 0.0), torch.where(prim >= 0, v, 0.0)
    return (t, prim, u, v, ftb._gather_attrs(ftb.attr_table(ts), prim)), slab, tests, swept, read


def _gated_rays(ts, seed):
    """300 rays (not a whole number of warps or blocks) with NaN and
    inactive lanes (chip_smoke.odd_lanes) on top of _rays' inactive tenth."""
    return odd_lanes([_t(x) for x in _rays(ts, 300, seed)])


@pytest.mark.parametrize("name", GATED)
def test_two_gate_sweep_equals_the_block_gated_scan(pairs, name):
    """The premise of K7d / K7e: a ray's own widened slab test on each voted
    supernode and leaf cluster culls no hit the block-gated scan takes, so
    the warp walk's t, prim, u, v, attrs and occ equal cluster_closest_ref /
    cluster_any_ref bit for bit (on twins, every hit a tie won by the lower
    slot)."""
    from chip_smoke import tied_hits

    ts = _gated_scene(pairs, name)
    o, d, lo, hi = _gated_rays(ts, 11)
    sn = cs.scene_supernodes(ts)
    zero = torch.zeros_like(hi)
    votes = cs.cluster_votes(ts, o, d, zero, hi, supernodes=sn)
    votes_any = cs.cluster_votes(ts, o, d, lo, hi, supernodes=sn)
    got = _warp_walk(ts, sn, o, d, zero, hi, votes, False)[0]
    ref = cs.cluster_closest_ref(ts, o, d, t_max=hi, votes=votes, supernodes=sn)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ = _warp_walk(ts, sn, o, d, lo, hi, votes_any, True)[0]
    occ_ref = cs.cluster_any_ref(ts, o, d, lo, hi, votes=votes_any, supernodes=sn)
    assert torch.equal(occ, occ_ref)
    hits = int((ref[1] >= 0).sum())
    assert hits > 20 and 20 < int(occ_ref.sum()) < 280
    if name == "soup_ties":
        assert tied_hits(ts, ref[1]) == hits


@pytest.mark.parametrize("name", GATED)
def test_gated_tests_count_the_warp_walk(pairs, name):
    """gated_tests (the bound's count of the two-gate sweep) equals the
    slab and Woop tests of the warp walk ray by ray, its supernodes swept
    warp by warp, the slots it reads slot by slot (no slot of an empty
    cluster among them), its occlusion the walk's; it never makes more Woop
    tests than the block sweep (sweep_tests), and on the scenes of several
    supernodes far fewer."""
    ts = _gated_scene(pairs, name)
    o, d, lo, hi = _gated_rays(ts, 12)
    sn = cs.scene_supernodes(ts)
    zero = torch.zeros_like(hi)
    for seg_lo, any_hit in ((zero, False), (lo, True)):
        votes = cs.cluster_votes(ts, o, d, seg_lo, hi, supernodes=sn)
        _, slab, tests, swept, read = _warp_walk(ts, sn, o, d, seg_lo, hi, votes, any_hit)
        g_slab, g_tests, g_occ, g_swept, g_read = cs.gated_tests(ts, o, d, seg_lo, hi, votes,
                                                                 any_hit, supernodes=sn)
        assert torch.equal(g_slab, slab) and torch.equal(g_tests, tests)
        assert torch.equal(g_swept, swept) and torch.equal(g_read, read)
        empty = cs.cluster_boxes(ts)[2].repeat_interleave(ts.bvh_leaf_size)
        n = min(read.shape[0], empty.shape[0])
        assert not bool((read[:n] & empty[:n]).any()) and 0 < int(read.sum()) <= int(tests.sum())
        sweep, occ = cs.sweep_tests(ts, o, d, seg_lo, hi, votes, any_hit, supernodes=sn)
        assert torch.equal(g_occ, occ)
        assert bool((g_tests <= sweep).all())
        assert int(tests.sum()) > 0 and bool((slab[~(hi > seg_lo)] == 0).all())
        if sn.s > 1:
            assert int(g_tests.sum()) * 4 < int(sweep.sum())


def test_slab_entered_is_the_kernels(pairs):
    """cluster_sweep.slab_entered / inv_dir equal the numpy copy of
    csrc/bvh.cuh's slab_entered / inv_dir1 (tests/test_torch_bvh_pack.py)
    bit for bit, on boxes grazed at their faces, NaN and zero direction
    components, NaN origins and inverted boxes."""
    rng = np.random.default_rng(13)
    n = 4000
    lo_box = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    hi_box = (lo_box + rng.uniform(0, 1, (n, 3))).astype(np.float32)
    hi_box[::97] = lo_box[::97] - 0.5  # inverted
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = rng.uniform(size=n) < 0.6  # most rays aimed near the box's centre
    d[aim] = (0.5 * (lo_box + hi_box) - o + rng.normal(scale=0.3, size=(n, 3)))[aim]
    d[::50, 1] = np.nan
    d[1::50, 2] = 0.0
    o[2::50, 0] = np.nan
    # rays aimed at a face corner: the slab intervals meet at the box's edge
    o[3::7] = lo_box[3::7] - d[3::7] * np.float32(2.0)
    seg_lo = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 1, n)).astype(np.float32)
    seg_hi = rng.choice(np.array([1e30, 2.0, 0.5, -1e30], np.float32), n)
    got = cs.slab_entered(_t(lo_box), _t(hi_box), _t(o), cs.inv_dir(_t(d)), _t(seg_lo),
                          _t(seg_hi)).numpy()
    inv = np.array([[_inv(x) for x in row] for row in d], np.float32)
    np.testing.assert_array_equal(cs.inv_dir(_t(d)).numpy(), inv)
    want = np.array([_slab(lo_box[i], hi_box[i], o[i], inv[i], seg_lo[i], seg_hi[i])[0]
                     for i in range(n)])
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9
