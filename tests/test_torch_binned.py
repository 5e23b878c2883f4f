"""PyTorch port: the plain versions of the binned sweep (bvh/binned.py: K7a
closest hit, K7b any hit) against the JAX package's binned kernels in
interpret mode on Cornell, a 3000-triangle soup, the same soup in slot mode
and the small textured sphere field; the plain closest hit against the
brute-force Woop scan; the differentiable closest hit against JAX
binned_closest_diff; the wavefront with bvh_kernel "binned" against the JAX
wavefront; and the kernels' test counts against a walk of one block at a
time.  Both packages get the same scene tables (scene_from_arrays of the
JAX scene) and the same numpy rays.  Then what the kernels' design
(csrc/binned.cu: K3's BVH walk with the bin vote as a leaf filter)
assumes of the tables, and a numpy copy of that walk held to the plain
versions bit for bit.  The CUDA kernels against these plain versions:
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.bvh import binned as jb
from gpuspectral_tpu.bvh import build as jax_bvh_build
from gpuspectral_tpu.integrator.path_tracer import render_sample as jax_render_sample
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.bvh import binned as tb
from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
from gpuspectral_tpu_torch.bvh import dfs_sweep as ds
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.ops import woop
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field
from gpuspectral_tpu_torch.utils import RenderConfig

from chip_smoke import field_rays, odd_lanes
from test_binned import _random_scene
from test_torch_bvh import SMALL_FIELD
from test_torch_bvh_pack import _bits, _walk
from test_torch_dfs import _rays, _t
from torch_common import assert_mega_gates, jax_scene_arrays, launches

SCENES = ["cornell", "soup3000", "slot_mode", "sphere_field"]


def _slot_mode_soup():
    # the JAX megakernel module checks the dense threshold when first
    # imported: import it before lowering the threshold
    import gpuspectral_tpu.integrator.mega  # noqa: F401

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        return _random_scene(3000)


@pytest.fixture(scope="module")
def pairs(cornell_scene):
    """(JAX scene, the port's scene from the same tables) by name."""
    out = {}
    for name, js in (("cornell", cornell_scene), ("soup3000", _random_scene(3000)),
                     ("slot_mode", _slot_mode_soup()),
                     ("sphere_field", populate_sphere_field(JaxBuilder(), **SMALL_FIELD).build())):
        out[name] = (js, scene_from_arrays(*jax_scene_arrays(js), "cpu"))
    assert (np.asarray(out["slot_mode"][0].tri_woop) == 0).all(axis=1).any()  # empty slots
    assert out["sphere_field"][0].has_textures and out["soup3000"][0].bvh_bins > 24
    return out


@pytest.mark.parametrize("name", SCENES)
def test_plain_closest_matches_jax(pairs, name):
    """t, prim, u, v and attrs bit for bit, exact-t ties included: the JAX
    kernel, like the port, takes the first minimum of a chunk and replaces
    its best only on a strictly smaller t, so the lowest slot wins."""
    js, ts = pairs[name]
    o, d, _, t_max = _rays(js, 700, 2)
    t_j, prim_j, u_j, v_j, attrs_j = (np.asarray(x) for x in jb.binned_closest(
        js, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max), interpret=True))
    n0 = launches(tb.binned_closest)
    t, prim, u, v, attrs = (x.numpy() for x in tb.binned_closest(ts, _t(o), _t(d),
                                                                  t_max=_t(t_max)))
    assert launches(tb.binned_closest) == n0  # the plain version on the CPU
    assert (prim_j >= 0).sum() > 100 and prim.dtype == np.int32
    for a, b in ((t, t_j), (prim, prim_j), (u, u_j), (v, v_j), (attrs, attrs_j)):
        np.testing.assert_array_equal(a, b)
    assert (t[prim < 0] == 1e30).all() and (attrs[prim < 0] == 0).all()


@pytest.mark.parametrize("name", SCENES)
def test_plain_any_matches_jax(pairs, name):
    js, ts = pairs[name]
    o, d, t_min, t_max = _rays(js, 700, 3)
    active = np.random.default_rng(4).uniform(size=700) < 0.8
    occ_j = np.asarray(jb.binned_any(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                                     jnp.asarray(t_max), active=jnp.asarray(active),
                                     interpret=True))
    n0 = launches(tb.binned_any)
    occ = tb.binned_any(ts, _t(o), _t(d), _t(t_min), _t(t_max), active=_t(active))
    assert launches(tb.binned_any) == n0
    assert 50 < occ_j.sum() < 600
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    # scalar segment ends, as the wavefront's shadow rays pass t_min
    occ_s = tb.binned_any(ts, _t(o), _t(d), 0.01, 2.0)
    occ_sj = jb.binned_any(js, jnp.asarray(o), jnp.asarray(d), 0.01, 2.0, interpret=True)
    np.testing.assert_array_equal(occ_s.numpy(), np.asarray(occ_sj))


def test_active_mask(pairs):
    js, ts = pairs["sphere_field"]
    o, d, t_min, _ = _rays(js, 512, 4)
    active = torch.arange(512) % 3 != 0
    t, prim, u, v, attrs = tb.binned_closest(ts, _t(o), _t(d), active=active)
    assert (prim[~active] == -1).all() and (t[~active] == 1e30).all()
    assert (u[~active] == 0).all() and (attrs[~active] == 0).all()
    _, prim_j, _, _, _ = jb.binned_closest(js, jnp.asarray(o), jnp.asarray(d),
                                           active=jnp.asarray(active.numpy()), interpret=True)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(prim_j))
    occ_all = tb.binned_any(ts, _t(o), _t(d), _t(t_min), 3.0)
    occ = tb.binned_any(ts, _t(o), _t(d), _t(t_min), 3.0, active=active)
    assert not occ[~active].any() and torch.equal(occ[active], occ_all[active])


@pytest.mark.parametrize("name", SCENES)
def test_plain_closest_matches_brute_force(pairs, name):
    """Where the votes are sound the binned sweep is the brute-force Woop
    scan (tests/test_binned.py:test_binned_closest_matches_brute): the
    closest hit and the occlusion equal ftb's plain scans on >= 99.9% of
    rays, bit for bit on t, prim, u, v and attrs (a ray loses a hit only
    where a bin's slab test rounds the other way at its box's edge)."""
    _, ts = pairs[name]
    o, d, t_min, t_max = (_t(x) for x in _rays(ts, 2000, 5))
    got = tb.binned_closest_ref(ts, o, d, t_max=t_max)
    ref = ftb.ftb_closest_ref(ts, o, d, t_max=t_max)
    same = got[1] == ref[1]
    assert int((ref[1] >= 0).sum()) > 200 and float(same.double().mean()) >= 0.999
    for a, b in zip(got, ref):
        assert torch.equal(a[same], b[same])
    occ = tb.binned_any_ref(ts, o, d, t_min, t_max)
    assert float((occ == ftb.ftb_any_ref(ts, o, d, t_min, t_max)).double().mean()) >= 0.999


def test_wrappers_check_their_inputs(pairs):
    _, ts = pairs["soup3000"]
    o, d, _, t_max = (_t(x) for x in _rays(ts, 300, 5))
    with pytest.raises(ValueError):
        tb.binned_closest(ts, o[:, :2].contiguous(), d)
    with pytest.raises(ValueError):
        tb.binned_any(ts, o, d.double(), 0.0, t_max)
    with pytest.raises(ValueError):
        tb.binned_closest(ts, o, d, t_max=t_max[:-1])
    with pytest.raises(ValueError):  # a bin table narrower than the bins it names
        tb.binned_any(ts.replace(bvh_bin_bounds=ts.bvh_bin_bounds[:, :3]), o, d, 0.0, t_max)


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_closest_diff_grads_match_jax(pairs, name):
    """d(sum of weighted t, u, v)/d(o, d) through binned_closest_diff against
    jax.grad through binned.binned_closest_diff, within 1e-6 of the
    gradient's scale; the hits are the same triangles."""
    js, ts = pairs[name]
    o, d, _, _ = _rays(js, 256, 6)
    w = np.random.default_rng(7).normal(size=(3, 256)).astype(np.float32)
    active = np.arange(256) % 5 != 0

    def loss_j(oo, dd):
        t, prim, u, v, _ = jb.binned_closest_diff(js, oo, dd, active=jnp.asarray(active))
        m = (prim >= 0).astype(jnp.float32)
        return jnp.sum(m * (w[0] * jnp.where(prim >= 0, t, 0.0) + w[1] * u + w[2] * v))

    go_j, gd_j = (np.asarray(g) for g in jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(o), jnp.asarray(d)))
    prim_j = np.asarray(jb.binned_closest_diff(js, jnp.asarray(o), jnp.asarray(d),
                                               active=jnp.asarray(active))[1])
    ot, dt = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    t, prim, u, v, attrs = tb.binned_closest_diff(ts, ot, dt, active=_t(active))
    assert not attrs.requires_grad
    np.testing.assert_array_equal(prim.numpy(), prim_j)
    assert (prim_j >= 0).sum() > 50
    m = (prim >= 0).to(torch.float32)
    wt = _t(w)
    loss = (m * (wt[0] * torch.where(prim >= 0, t, 0.0) + wt[1] * u + wt[2] * v)).sum()
    go, gd = (g.numpy() for g in torch.autograd.grad(loss, (ot, dt)))
    for a, b in ((go, go_j), (gd, gd_j)):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_wavefront_matches_jax(pairs, name):
    """The BVH wavefront with bvh_kernel "binned" (16x16, depth 3,
    intersector "pallas": the plain K7a / K7b on the CPU) against the JAX
    wavefront at the same config and timestamp, under the tests/test_mega.py
    gates: 1 spp on Cornell and on the textured sphere field under its sky
    (both under JAX's 212,992 slots, so JAX runs its binned kernels)."""
    js, ts = pairs[name]
    assert js.tri_woop_t.shape[1] <= jb.MAX_VMEM_SLOTS
    base = dict(width=16, height=16, max_depth=3, use_bvh=True, intersector="pallas",
                bvh_kernel="binned")
    pix = np.arange(256, dtype=np.uint32)
    n0 = launches(tb.binned_closest), launches(tb.binned_any)
    ref, rays_ref = jax_render_sample(js, JaxConfig(**base), jnp.asarray(pix), jnp.uint32(3))
    got, rays_got = pt.render_sample(ts, RenderConfig(**base),
                                     torch.as_tensor(pix.astype(np.int64)), 3)
    assert_mega_gates(np.asarray(ref)[:, None], got.numpy()[:, None],
                      float(np.asarray(rays_ref).sum()), float(rays_got.sum()))
    assert (launches(tb.binned_closest), launches(tb.binned_any)) == n0


def test_wavefront_dispatch_reaches_the_binned_wrappers(pairs, monkeypatch):
    """The wavefront, the differentiable wavefront of diff/gradcheck and the
    sort options call the binned wrappers for bvh_kernel "binned" (and the
    ftb, cluster and dfs wrappers never): they are looked up by name on
    their module."""
    from gpuspectral_tpu_torch.diff import gradcheck as tgc

    _, ts = pairs["sphere_field"]
    calls = dict(closest=0, closest_diff=0, any=0)
    for key, name in (("closest", "binned_closest"), ("closest_diff", "binned_closest_diff"),
                      ("any", "binned_any")):
        real = getattr(tb, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tb, name, spy)
    for mod, names in ((ftb, ("ftb_closest", "ftb_closest_diff", "ftb_any")),
                       (cs, ("cluster_closest", "cluster_closest_diff", "cluster_any")),
                       (ds, ("dfs_closest", "dfs_closest_diff", "dfs_any"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, **kw: pytest.fail("another kernel"))
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2, ray_batch=128, use_bvh=True,
                       intersector="pallas", bvh_kernel="binned", sort_rays=True,
                       shadow_sort=True)
    img, rays = pt.render_image_stats(ts, cfg, 0)
    assert bool(torch.isfinite(img).all()) and rays > 0
    assert calls["closest"] > 0 and calls["any"] > 0 and calls["closest_diff"] == 0
    loss, g = tgc._loss_and_grad(ts, cfg, ts.bsdf_params, np.zeros((64, 3), np.float32))
    assert calls["closest_diff"] > 0 and bool(torch.isfinite(g).all())


def _block_walk(ts, o, d, lo, hi, any_hit):
    """One block of rays walked bin by bin in plain Python, as csrc/binned.cu
    walks them: (box tests, Woop tests, bins the block visits, the closest
    hit's t or the occlusion flags)."""
    bounds, slots = ts.bvh_bin_bounds, ts.bvh_bin_slots
    n_slots = ts.tri_woop.shape[0]
    n = o.shape[0]
    mag = d.abs().clamp(min=1e-12)
    inv = torch.ones_like(d) / torch.where(d < 0, -mag, mag)
    best = torch.clamp(hi, max=1e30)
    occ = torch.zeros(n, dtype=torch.bool)
    testing = (hi > lo) if any_hit else (hi > 0)
    boxes, woops = torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64)
    visits = 0
    for b in range(ts.bvh_bins):
        if any_hit and bool((occ | ~testing).all()):
            break
        t0 = (bounds[0:3, b] - o) * inv
        t1 = (bounds[3:6, b] - o) * inv
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = torch.maximum(near.amax(1), torch.zeros_like(hi))
        t_far = torch.minimum(far.amin(1), hi)
        live = testing & ~occ
        voted = live & (t_far >= t_near)
        boxes += live.to(torch.int64)
        if not bool(voted.any()):
            continue
        visits += 1
        rows = ts.tri_woop[b * slots:min((b + 1) * slots, n_slots)]
        for i in torch.nonzero(voted)[:, 0].tolist():
            if any_hit:
                t = woop._chunk_t(o[i:i + 1], d[i:i + 1], rows, lo[i:i + 1], hi[i:i + 1])[0]
                hit = torch.nonzero(t < 1e30)[:, 0]
                woops[i] += int(hit[0]) + 1 if hit.numel() else rows.shape[0]
                occ[i] = bool(hit.numel())
            else:
                t = woop._chunk_t(o[i:i + 1], d[i:i + 1], rows, torch.zeros(1), best[i:i + 1])[0]
                woops[i] += rows.shape[0]
                best[i] = torch.minimum(best[i], t.min())
    out = occ if any_hit else torch.where(best < torch.clamp(hi, max=1e30), best, 1e30)
    return boxes, woops, visits, out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_binned_tests_count_the_kernels_tests(pairs, any_hit):
    """binned_tests against a walk of one block of BLOCK rays at a time: K7a
    slab-tests every bin for each ray with t_max > 0 and Woop-tests the
    slots of its voted bins; K7b stops a ray's votes and tests at its first
    occluder and a block once all its rays are occluded or empty; a block
    visits each bin one of its rays voted for."""
    _, ts = pairs["soup3000"]
    o, d, t_min, t_max = (_t(x) for x in _rays(ts, 2 * tb.BLOCK + 40, 8))
    if not any_hit:
        t_min = torch.zeros_like(t_max)
    boxes, woops, visits, out = tb.binned_tests(ts, o, d, t_min, t_max, any_hit)
    if any_hit:
        assert torch.equal(out, tb.binned_any_ref(ts, o, d, t_min, t_max))
    else:
        assert torch.equal(out[0], tb.binned_closest_ref(ts, o, d, t_max=t_max)[0])
    for b0 in range(0, o.shape[0], tb.BLOCK):
        s = slice(b0, b0 + tb.BLOCK)
        ref = _block_walk(ts, o[s], d[s], t_min[s], t_max[s], any_hit)
        assert torch.equal(boxes[s], ref[0]) and torch.equal(woops[s], ref[1])
        assert (visits[s] == ref[2]).all()
        assert torch.equal(out[s] if any_hit else out[0][s], ref[3])
    assert int(woops.sum()) > 0 and int(visits.min()) > 1 and int(boxes.max()) == ts.bvh_bins


FAR = np.array([1e17, 2e17, 3e17], np.float32)  # bvh/tables.py:build_bins' padding box


@pytest.mark.parametrize("name", SCENES)
def test_bins_are_runs_of_whole_clusters(pairs, name):
    """What K7a / K7b's walk assumes of the tables: a bin is g = slots /
    leaf_size whole leaf clusters of the tree, [b * g, (b + 1) * g); its box
    is the min / max of those clusters' finite boxes bit for bit (a far
    point where none is finite); the packed bin rows hold the same boxes;
    every cluster past the last bin is empty and its slots are padding
    (zero) Woop rows, which never hit."""
    _, ts = pairs[name]
    slots, leaf, c = ts.bvh_bin_slots, ts.bvh_leaf_size, ts.bvh_clusters
    g = slots // leaf
    assert slots == g * leaf and g >= 1
    lo, hi = ts.bvh_node_min[c - 1:].numpy(), ts.bvh_node_max[c - 1:].numpy()
    finite = np.isfinite(lo).all(1) & np.isfinite(hi).all(1)
    bounds = ts.bvh_bin_bounds.numpy()
    for b in range(ts.bvh_bins):
        ok = finite & (np.arange(c) // g == b)
        want = (lo[ok].min(0), hi[ok].max(0)) if ok.any() else (FAR, FAR)
        np.testing.assert_array_equal(bounds[0:3, b], want[0])
        np.testing.assert_array_equal(bounds[3:6, b], want[1])
    rows = tb.bin_rows(ts).numpy()
    assert rows.shape == (ts.bvh_bins, 8) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0:3], bounds[0:3, :ts.bvh_bins].T)
    np.testing.assert_array_equal(rows[:, 4:7], bounds[3:6, :ts.bvh_bins].T)
    assert (rows[:, 3] == 0).all() and (rows[:, 7] == 0).all()
    past = ts.bvh_bins * g
    assert not finite[past:].any()
    assert (ts.tri_woop.numpy()[past * leaf:] == 0).all()


def test_bin_rows_checks(pairs):
    """bin_rows raises on rows the kernels cannot read: a misaligned view,
    a row count other than the bins', a bin that is no whole number of
    clusters."""
    _, ts = pairs["soup3000"]
    rows = ts.bvh_bin_rows
    offset = torch.empty(rows.numel() + 1)[1:].view(rows.shape)
    offset.copy_(rows)
    for bad in (dict(bvh_bin_rows=offset), dict(bvh_bin_rows=rows[:-1].contiguous()),
                dict(bvh_bin_slots=ts.bvh_bin_slots + 8)):
        with pytest.raises(ValueError):
            tb.bin_rows(ts.replace(**bad))
    assert tb.bin_rows(ts) is rows


def _culled(ts):
    """ts with every third bin's box moved to a far point: its triangles'
    hits are lost to the votes, so the leaf filter decides results."""
    from gpuspectral_tpu_torch.bvh.tables import build_bin_rows

    b = ts.bvh_bin_bounds.clone()
    b[:, ::3] = torch.as_tensor(np.concatenate([FAR, FAR]))[:, None]
    return ts.replace(bvh_bin_bounds=b,
                      bvh_bin_rows=torch.as_tensor(build_bin_rows(b.numpy(), ts.bvh_bins)))


@pytest.mark.parametrize("name", SCENES + ["culled"])
def test_numpy_walk_with_bin_votes_matches_plain(pairs, name):
    """The premise of K7a / K7b's design: K3's walk (csrc/bvh.cuh, the
    numpy copy of tests/test_torch_bvh_pack.py) that tests a leaf cluster
    only where the ray votes for its bin gives the plain versions' t,
    prim, u, v and occ bit for bit, NaN and inactive lanes included; on
    the culled soup the votes drop hits that the brute scan finds."""
    ts = _culled(pairs["soup3000"][1]) if name == "culled" else pairs[name][1]
    o, d, lo, hi = odd_lanes(field_rays(120, ts, 41, "cpu"), seed=7)
    lo = torch.where(torch.arange(120) % 4 == 0, -0.5, lo).contiguous()  # t_min < 0
    g = ts.bvh_bin_slots // ts.bvh_leaf_size
    ref = tb.binned_closest_ref(ts, o, d, t_max=hi)
    occ_r = tb.binned_any_ref(ts, o, d, lo, hi)
    assert int((ref[1] >= 0).sum()) > 10 and bool(occ_r.any())
    if name == "culled":
        assert bool((ref[1] != ftb.ftb_closest_ref(ts, o, d, t_max=hi)[1]).any())
    got, occ = [], []
    for any_hit, live in ((False, hi > 0), (True, hi > lo)):
        votes = tb._votes(ts, o, d, hi, live)
        for i in range(o.shape[0]):
            def keep(c, v=votes[i]):
                return c // g < ts.bvh_bins and bool(v[c // g])

            out = _walk(ts, *(x[i].numpy() for x in (o, d, lo, hi)), any_hit, keep)
            (occ if any_hit else got).append(out)
    np.testing.assert_array_equal(_bits([x[0] for x in got]), _bits(ref[0].numpy()))
    np.testing.assert_array_equal([x[1] for x in got], ref[1].numpy())
    np.testing.assert_array_equal(_bits([x[2] for x in got]), _bits(ref[2].numpy()))
    np.testing.assert_array_equal(_bits([x[3] for x in got]), _bits(ref[3].numpy()))
    np.testing.assert_array_equal(occ, occ_r.numpy())


def test_walk_tests_need_the_card(pairs):
    """binned_walk_tests counts the kernels' own walk: none runs on the
    CPU (the plain versions vote for every bin), so it refuses."""
    _, ts = pairs["cornell"]
    o, d, lo, hi = field_rays(8, ts, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tb.binned_walk_tests(ts, o, d, lo, hi, False)
