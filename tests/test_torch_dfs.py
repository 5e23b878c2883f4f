"""PyTorch port: the plain versions of the dfs sweep (bvh/dfs_sweep.py: K7f
closest hit, K7g any hit) against the JAX package's dfs kernels in
interpret mode on Cornell, the zoo and the small textured sphere field; the
differentiable closest hit against JAX dfs_sweep.closest_diff(kernel="dfs");
the wavefront with bvh_kernel "dfs" against the JAX wavefront; the
block sweep's test counts against a walk of one block at a time; and the
plain walk against JAX on NaN lanes.  Both packages get the same scene
tables (scene_from_arrays of the JAX scene) and the same numpy rays.
Then the premise of the kernels' design (csrc/dfs.cu): a walk of one warp
at a time that gates each leaf cluster by the ray's own widened slab test,
as K7f / K7g do, gives the plain walk's results bit for bit, and
gated_tests counts its tests.  The CUDA kernels against these plain
versions: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.bvh import dfs_sweep as jdfs
from gpuspectral_tpu.integrator.path_tracer import render_sample as jax_render_sample
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
from gpuspectral_tpu_torch.bvh import dfs_sweep as ds
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.ops import math3d as m3
from gpuspectral_tpu_torch.ops import woop
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field, populate_zoo
from gpuspectral_tpu_torch.utils import RenderConfig

from chip_smoke import odd_lanes, soup_scene
from test_torch_bvh import SMALL_FIELD
from torch_common import assert_mega_gates, jax_scene_arrays, launches

SCENES = ["cornell", "zoo", "sphere_field"]


@pytest.fixture(scope="module")
def pairs(cornell_scene):
    """(JAX scene, the port's scene from the same tables) by name.  Every
    emitter has a BSDF row of its own: JAX's unpack_meta rounds half to
    even and misreads an emitter of row 0 with an even light index."""
    out = {}
    for name, js in (("cornell", cornell_scene), ("zoo", populate_zoo(JaxBuilder()).build()),
                     ("sphere_field", populate_sphere_field(JaxBuilder(), **SMALL_FIELD).build())):
        bsdf, light = np.asarray(js.tri_bsdf), np.asarray(js.tri_light_idx)
        assert not np.isin(bsdf[light >= 0], bsdf[light < 0]).any()
        out[name] = (js, scene_from_arrays(*jax_scene_arrays(js), "cpu"))
    assert out["sphere_field"][0].has_textures
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


def _jax_block(js, n_attr):
    return jdfs._block_size(js, n_attr)


@pytest.mark.parametrize("name", SCENES)
def test_plain_closest_matches_jax(pairs, name):
    """At JAX's block size: t, u, v and attrs bit for bit; prim equal except
    at exact-t ties (the JAX kernel keeps a best per lane and breaks a tie
    between lanes by lane position, the port takes the lowest slot)."""
    js, ts = pairs[name]
    o, d, _, t_max = _rays(js, 900, 2)
    t_j, prim_j, u_j, v_j, attrs_j = (np.asarray(x) for x in jdfs.dfs_closest(
        js, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max), interpret=True))
    block = _jax_block(js, jdfs.fused_attr_rows(js))
    t, prim, u, v, attrs = (x.numpy() for x in ds.dfs_closest_ref(ts, _t(o), _t(d),
                                                                   t_max=_t(t_max), block=block))
    hit = prim_j >= 0
    assert hit.sum() > 100 and prim.dtype == np.int32
    np.testing.assert_array_equal(t, t_j)
    np.testing.assert_array_equal(prim >= 0, hit)
    same = prim == prim_j
    assert np.mean(~same) < 0.01
    np.testing.assert_array_equal(u[same], u_j[same])
    np.testing.assert_array_equal(v[same], v_j[same])
    np.testing.assert_array_equal(attrs[same], attrs_j[same])
    assert (t[~hit] == 1e30).all() and (attrs[~hit] == 0).all() and (u[~hit] == 0).all()
    # the wrapper runs the plain version at BLOCK on the CPU, no launch
    n0 = launches(ds.dfs_closest)
    got = ds.dfs_closest(ts, _t(o), _t(d), t_max=_t(t_max))
    ref = ds.dfs_closest_ref(ts, _t(o), _t(d), t_max=_t(t_max), block=ds.BLOCK)
    assert launches(ds.dfs_closest) == n0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SCENES)
def test_plain_any_matches_jax(pairs, name):
    js, ts = pairs[name]
    o, d, t_min, t_max = _rays(js, 900, 3)
    active = np.random.default_rng(4).uniform(size=900) < 0.8
    occ_j = np.asarray(jdfs.dfs_any(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                                    jnp.asarray(t_max), active=jnp.asarray(active),
                                    interpret=True))
    block = _jax_block(js, 0)
    occ = ds.dfs_any_ref(ts, _t(o), _t(d), _t(t_min), _t(t_max), active=_t(active), block=block)
    assert 50 < occ_j.sum() < 800
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    # scalar segment ends, as the wavefront's shadow rays pass t_min
    occ_s = ds.dfs_any(ts, _t(o), _t(d), 0.01, 2.0)
    occ_sj = jdfs.dfs_any(js, jnp.asarray(o), jnp.asarray(d), 0.01, 2.0, interpret=True)
    np.testing.assert_array_equal(occ_s.numpy(), np.asarray(occ_sj))


def test_active_mask(pairs):
    js, ts = pairs["sphere_field"]
    o, d, t_min, _ = _rays(js, 512, 4)
    active = torch.arange(512) % 3 != 0
    t, prim, u, v, attrs = ds.dfs_closest(ts, _t(o), _t(d), active=active)
    assert (prim[~active] == -1).all() and (t[~active] == 1e30).all()
    assert (u[~active] == 0).all() and (attrs[~active] == 0).all()
    _, prim_j, _, _, _ = jdfs.dfs_closest(js, jnp.asarray(o), jnp.asarray(d),
                                          active=jnp.asarray(active.numpy()), interpret=True)
    np.testing.assert_array_equal(prim.numpy() >= 0, np.asarray(prim_j) >= 0)
    occ_all = ds.dfs_any(ts, _t(o), _t(d), _t(t_min), 3.0)
    occ = ds.dfs_any(ts, _t(o), _t(d), _t(t_min), 3.0, active=active)
    assert not occ[~active].any() and torch.equal(occ[active], occ_all[active])


@pytest.mark.parametrize("block", [32, 64, 128, 256])
@pytest.mark.parametrize("name", SCENES)
def test_block_sizes_agree_with_brute_force(pairs, name, block):
    """The result does not hang on the block size: at 32 (BLOCK), 64, 128
    and 256 rays a block, the walk's closest hit and occlusion equal the
    brute-force Woop scan's on >= 99.9% of rays (a block loses a hit only
    where every ray's slab test rounds the other way at a box's edge)."""
    _, ts = pairs[name]
    o, d, t_min, t_max = (_t(x) for x in _rays(ts, 2000, 5))
    got = ds.dfs_closest_ref(ts, o, d, t_max=t_max, block=block)
    ref = ftb.ftb_closest_ref(ts, o, d, t_max=t_max)
    same = got[1] == ref[1]
    assert int((ref[1] >= 0).sum()) > 200 and float(same.double().mean()) >= 0.999
    for a, b in zip(got, ref):
        assert torch.equal(a[same], b[same])
    occ = ds.dfs_any_ref(ts, o, d, t_min, t_max, block=block)
    assert float((occ == ftb.ftb_any_ref(ts, o, d, t_min, t_max)).double().mean()) >= 0.999


def test_wrappers_check_their_inputs(pairs):
    _, ts = pairs["cornell"]
    o, d, _, t_max = (_t(x) for x in _rays(ts, 300, 5))
    with pytest.raises(ValueError):
        ds.dfs_closest(ts, o[:, :2].contiguous(), d)
    with pytest.raises(ValueError):
        ds.dfs_any(ts, o, d.double(), 0.0, t_max)


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_closest_diff_grads_match_jax(pairs, name):
    """d(sum of weighted t, u, v)/d(o, d) through dfs_closest_diff against
    jax.grad through dfs_sweep.closest_diff(kernel="dfs"), over the rays
    whose hit is the same triangle, within 1e-6 of the gradient's scale."""
    js, ts = pairs[name]
    o, d, _, _ = _rays(js, 256, 6)
    w = np.random.default_rng(7).normal(size=(3, 256)).astype(np.float32)
    active = np.arange(256) % 5 != 0

    def loss_j(oo, dd):
        t, prim, u, v, _ = jdfs.closest_diff(js, oo, dd, active=jnp.asarray(active),
                                             kernel="dfs")
        m = (prim >= 0).astype(jnp.float32)
        return jnp.sum(m * (w[0] * jnp.where(prim >= 0, t, 0.0) + w[1] * u + w[2] * v))

    go_j, gd_j = (np.asarray(g) for g in jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(o), jnp.asarray(d)))
    prim_j = np.asarray(jdfs.closest_diff(js, jnp.asarray(o), jnp.asarray(d),
                                          active=jnp.asarray(active), kernel="dfs")[1])
    ot, dt = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    t, prim, u, v, attrs = ds.dfs_closest_diff(ts, ot, dt, active=_t(active))
    assert not attrs.requires_grad
    m = (prim >= 0).to(torch.float32)
    wt = _t(w)
    loss = (m * (wt[0] * torch.where(prim >= 0, t, 0.0) + wt[1] * u + wt[2] * v)).sum()
    go, gd = (g.numpy() for g in torch.autograd.grad(loss, (ot, dt)))
    same = prim.numpy() == prim_j
    assert same.mean() > 0.99 and (prim_j >= 0).sum() > 50
    for a, b in ((go, go_j), (gd, gd_j)):
        scale = np.abs(b).max()
        assert np.abs(a[same] - b[same]).max() <= 1e-6 * scale


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
def test_wavefront_matches_jax(pairs, name):
    """The BVH wavefront with bvh_kernel "dfs" (16x16, depth 3, intersector
    "pallas": the plain K7f / K7g on the CPU) against the JAX wavefront at
    the same config and timestamp, under the tests/test_mega.py gates: 1 spp
    on Cornell and on the textured sphere field under its sky."""
    js, ts = pairs[name]
    base = dict(width=16, height=16, max_depth=3, use_bvh=True, intersector="pallas",
                bvh_kernel="dfs")
    pix = np.arange(256, dtype=np.uint32)
    n0 = launches(ds.dfs_closest), launches(ds.dfs_any)
    ref, rays_ref = jax_render_sample(js, JaxConfig(**base), jnp.asarray(pix), jnp.uint32(3))
    got, rays_got = pt.render_sample(ts, RenderConfig(**base),
                                     torch.as_tensor(pix.astype(np.int64)), 3)
    assert_mega_gates(np.asarray(ref)[:, None], got.numpy()[:, None],
                      float(np.asarray(rays_ref).sum()), float(rays_got.sum()))
    assert (launches(ds.dfs_closest), launches(ds.dfs_any)) == n0


def test_wavefront_dispatch_reaches_the_dfs_wrappers(pairs, monkeypatch):
    """The wavefront, the differentiable wavefront of diff/gradcheck and the
    sort options call the dfs wrappers for bvh_kernel "dfs" (and the ftb and
    cluster wrappers never): they are looked up by name on their module."""
    from gpuspectral_tpu_torch.diff import gradcheck as tgc

    _, ts = pairs["cornell"]
    calls = dict(closest=0, closest_diff=0, any=0)
    for key, name in (("closest", "dfs_closest"), ("closest_diff", "dfs_closest_diff"),
                      ("any", "dfs_any")):
        real = getattr(ds, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ds, name, spy)
    for mod, names in ((ftb, ("ftb_closest", "ftb_closest_diff", "ftb_any")),
                       (cs, ("cluster_closest", "cluster_closest_diff", "cluster_any"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, **kw: pytest.fail("another kernel"))
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2, ray_batch=128, use_bvh=True,
                       intersector="pallas", bvh_kernel="dfs", sort_rays=True,
                       shadow_sort=True)
    img, rays = pt.render_image_stats(ts, cfg, 0)
    assert bool(torch.isfinite(img).all()) and rays > 0
    assert calls["closest"] > 0 and calls["any"] > 0 and calls["closest_diff"] == 0
    loss, g = tgc._loss_and_grad(ts, cfg, ts.bsdf_params, np.zeros((64, 3), np.float32))
    assert calls["closest_diff"] > 0 and bool(torch.isfinite(g).all())


def _block_walk(ts, o, d, lo, hi, any_hit):
    """One block of rays walked node by node in plain Python: (box tests,
    Woop tests, the closest hit's t or the occlusion flags), as the block
    sweep makes them (every slot of an entered leaf for every ray)."""
    bounds, meta = ts.bvh_dfs_bounds, ts.bvh_dfs_meta
    n_nodes, n_slots = bounds.shape[1], ts.tri_woop.shape[0]
    n = o.shape[0]
    mag = d.abs().clamp(min=1e-12)
    inv = torch.ones_like(d) / torch.where(d < 0, -mag, mag)
    horizon, occ = hi.clone(), torch.zeros(n, dtype=torch.bool)
    empty = ~(hi > lo)
    boxes, woops = torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64)
    ptr = n_nodes if any_hit and bool(empty.all()) else 0
    while ptr < n_nodes:
        t0 = (bounds[0:3, ptr] - o) * inv
        t1 = (bounds[3:6, ptr] - o) * inv
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = torch.maximum(near.amax(1), lo)
        t_far = torch.minimum(far.amin(1), horizon)
        boxes += 1
        if not bool((t_far >= t_near).any()):
            ptr = int(meta[0, ptr])
            continue
        off = int(meta[1, ptr])
        ptr += 1
        if off < 0:
            continue
        rows = ts.tri_woop[off:min(off + ds.SWEEP, n_slots)]
        for i in range(n):
            if any_hit and (occ[i] or empty[i]):
                continue
            if not any_hit and not hi[i] > 0:
                continue
            t = woop._chunk_t(o[i:i + 1], d[i:i + 1], rows, lo[i:i + 1], horizon[i:i + 1])[0]
            hit = torch.nonzero(t < 1e30)[:, 0]
            if any_hit:
                woops[i] += int(hit[0]) + 1 if hit.numel() else rows.shape[0]
                if hit.numel():
                    occ[i], horizon[i] = True, -1e30
            else:
                woops[i] += rows.shape[0]
                horizon[i] = torch.minimum(horizon[i], t.min())
        if any_hit and bool((occ | empty).all()):
            break
    return boxes, woops, (occ if any_hit else torch.where(horizon < hi, horizon, 1e30))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_dfs_tests_count_the_kernels_tests(pairs, any_hit):
    """dfs_tests (the block sweep's count, one of the bound's two) against
    a walk of one block of BLOCK rays at a time: a ray slab-tests each node
    its block visits; at an entered leaf K7f tests every slot for a ray
    with a segment, K7g each ray not yet occluded up to its first occluder,
    and its block ends when all are occluded."""
    _, ts = pairs["sphere_field"]
    o, d, t_min, t_max = (_t(x) for x in _rays(ts, 2 * ds.BLOCK + 40, 8))
    if not any_hit:
        t_min = torch.zeros_like(t_max)
    boxes, woops, out = ds.dfs_tests(ts, o, d, t_min, t_max, any_hit)
    if any_hit:
        assert torch.equal(out, ds.dfs_any_ref(ts, o, d, t_min, t_max))
    else:
        assert torch.equal(out[0], ds.dfs_closest_ref(ts, o, d, t_max=t_max)[0])
    for b0 in range(0, o.shape[0], ds.BLOCK):
        s = slice(b0, b0 + ds.BLOCK)
        ref = _block_walk(ts, o[s], d[s], t_min[s], t_max[s], any_hit)
        assert torch.equal(boxes[s], ref[0]) and torch.equal(woops[s], ref[1])
        assert torch.equal(out[s] if any_hit else out[0][s], ref[2])
    assert int(woops.sum()) > 0 and int(boxes.min()) > 1


GATED = ["cornell", "zoo", "slot_mode", "sphere_field", "soup_ties"]
_WALKS = {}


def _gated_scene(pairs, name):
    """The port's scene: one of `pairs`, a 3000-triangle soup (a slot-mode
    build) or a soup of exact-t twins."""
    if name == "slot_mode":
        ts = soup_scene(3000, 3, "cpu")
        assert ts.tri_woop.shape[0] == ts.bvh_clusters * ts.bvh_leaf_size  # slot-padded
        return ts
    if name == "soup_ties":
        return soup_scene(600, 5, "cpu", ties=True)
    return pairs[name][1]


def _warp_walk(ts, o, d, lo, hi, any_hit):
    """csrc/dfs.cu's K7f (any_hit False, on (0, hi): lo 0) or K7g, one warp
    of 32 rays at a time, op for op: the node vote of every lane's slab test
    on [lo, horizon] (torch's NaN rule), ptr + 1 or the skip pointer; at an
    entered leaf, for each of its clusters in order, each searching lane's
    widened slab test on (0, best) (K7f) or (lo, hi) (K7g) where the box is
    not inverted; where some lane enters a cluster, the Woop test of each
    slot in order for the lanes that entered it, a strict `<` against best.
    An any-hit lane stops at its first occluder, the warp once no lane is
    left.  Returns ((t, prim, u, v, attrs) or occ, node tests, cluster
    tests and Woop tests per ray, the node rows and slots some warp
    reads)."""
    r = o.shape[0]
    bounds, meta = ts.bvh_dfs_bounds, ts.bvh_dfs_meta
    n_nodes, n_slots, leaf = bounds.shape[1], ts.tri_woop.shape[0], ts.bvh_leaf_size
    c_lo, c_hi, c_empty = cs.cluster_boxes(ts)
    inv = m3.safe_div(torch.ones_like(d), d)  # common.cuh:inv_dir_nan
    best, prim = hi.clone(), torch.full((r,), -1, dtype=torch.int32)
    occ = torch.zeros((r,), dtype=torch.bool)
    nodes, clusters, tests = (torch.zeros((r,), dtype=torch.int64) for _ in range(3))
    node_rows = torch.zeros((n_nodes,), dtype=torch.bool)
    slots = torch.zeros((n_slots,), dtype=torch.bool)
    for w0 in range(0, r, ds.BLOCK):
        w = slice(w0, min(w0 + ds.BLOCK, r))
        wo, wd, wi, wl, wh = o[w], d[w], inv[w], lo[w], hi[w]
        b, wp, wocc = best[w].clone(), prim[w].clone(), occ[w].clone()
        go = wh > wl if any_hit else wh > 0
        ptr = n_nodes if any_hit and not bool(go.any()) else 0
        while ptr < n_nodes:
            nodes[w] += 1
            node_rows[ptr] = True
            t0 = (bounds[0:3, ptr] - wo) * wi
            t1 = (bounds[3:6, ptr] - wo) * wi
            near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
            t_near = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                                   torch.maximum(near[:, 2], wl))
            t_far = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                                  torch.minimum(far[:, 2], b))
            if not bool((t_far >= t_near).any()):
                ptr = int(meta[0, ptr])
                continue
            off = int(meta[1, ptr])
            ptr += 1
            if off < 0:
                continue
            end = off + min(ds.SWEEP, n_slots - off)
            for c in range(off // leaf, min(-(-end // leaf), c_lo.shape[0])):
                if not bool(go.any()):
                    break
                if c_empty[c]:
                    continue
                clusters[w][go] += 1
                seg_hi = wh if any_hit else b
                cin = go & cs.slab_entered(c_lo[c], c_hi[c], wo, wi, wl, seg_hi)
                for slot in range(c * leaf, min((c + 1) * leaf, end)):
                    if not bool(cin.any()):
                        break
                    tests[w][cin] += 1
                    slots[slot] = True
                    t = woop._chunk_t(wo, wd, ts.tri_woop[slot:slot + 1], wl,
                                      wh if any_hit else b)[:, 0]
                    hit = cin & (t < 1e30)
                    if any_hit:
                        wocc, go, cin = wocc | hit, go & ~hit, cin & ~hit
                        b = torch.where(hit, -1e30, b)
                    else:
                        b, wp = torch.where(hit, t, b), torch.where(hit, slot, wp)
            if any_hit and not bool(go.any()):
                break
        best[w], prim[w], occ[w] = b, wp, wocc
    counts = (nodes, clusters, tests, node_rows, slots)
    if any_hit:
        return (occ, *counts)
    t = torch.where(prim >= 0, best, 1e30)
    u, v = woop._recover_uv(o, d, ts.tri_woop, prim, torch.where(prim >= 0, best, 0.0))
    u, v = torch.where(prim >= 0, u, 0.0), torch.where(prim >= 0, v, 0.0)
    return ((t, prim, u, v, ftb._gather_attrs(ftb.attr_table(ts), prim)), *counts)


def _gated_rays(ts, n, seed):
    """n rays (not a whole number of warps) with NaN and inactive lanes
    (chip_smoke.odd_lanes) on top of _rays' inactive tenth."""
    return odd_lanes([_t(x) for x in _rays(ts, n, seed)])


def _walks(pairs, name):
    """(scene, rays, the warp walk's closest and any-hit outputs), once a
    scene."""
    if name not in _WALKS:
        ts = _gated_scene(pairs, name)
        o, d, lo, hi = rays = _gated_rays(ts, 300, 11)
        _WALKS[name] = (ts, rays, _warp_walk(ts, o, d, torch.zeros_like(hi), hi, False),
                        _warp_walk(ts, o, d, lo, hi, True))
    return _WALKS[name]


@pytest.mark.parametrize("name", GATED)
def test_warp_walk_equals_the_plain_walk(pairs, name):
    """The premise of K7f / K7g's cluster gate: a walk of one warp at a
    time that Woop-tests only the leaf clusters each lane's own widened slab
    test enters gives dfs_closest_ref / dfs_any_ref's t, prim, u, v, attrs
    and occ bit for bit, with NaN and inactive lanes (on twins, every hit a
    tie won by the lower slot)."""
    from chip_smoke import tied_hits

    ts, (o, d, lo, hi), closest, any_hit = _walks(pairs, name)
    ref = ds.dfs_closest_ref(ts, o, d, t_max=hi)
    for a, b in zip(closest[0], ref):
        assert torch.equal(a, b)
    occ_ref = ds.dfs_any_ref(ts, o, d, lo, hi)
    assert torch.equal(any_hit[0], occ_ref)
    hits = int((ref[1] >= 0).sum())
    assert hits > 20 and 20 < int(occ_ref.sum()) < 280
    if name == "soup_ties":
        assert tied_hits(ts, ref[1]) == hits


@pytest.mark.parametrize("n", [1, 31, 33, 64])
def test_warp_walk_on_part_warps(pairs, n):
    """The warp walk against the plain walk on 1, 31, 33 and 64 rays of the
    sphere field (part warps), the last case with a warp of NaN lanes only
    and a warp of inactive lanes only."""
    ts = pairs["sphere_field"][1]
    o, d, lo, hi = _gated_rays(ts, n, 12 + n)
    if n == 64:
        o[:32, 1], hi[32:] = float("nan"), -1e30
    got = _warp_walk(ts, o, d, torch.zeros_like(hi), hi, False)[0]
    for a, b in zip(got, ds.dfs_closest_ref(ts, o, d, t_max=hi)):
        assert torch.equal(a, b)
    occ = _warp_walk(ts, o, d, lo, hi, True)
    assert torch.equal(occ[0], ds.dfs_any_ref(ts, o, d, lo, hi))
    if n == 64:
        assert not bool((got[1] >= 0).any()) and not bool(occ[0].any())
        assert int(occ[1][32:].sum()) == 0  # a warp with nothing to search never walks


@pytest.mark.parametrize("name", GATED)
def test_gated_tests_count_the_warp_walk(pairs, name):
    """gated_tests (the bound's count of the two-gate walk) equals the
    node, cluster and Woop tests of the warp walk ray by ray, the node rows
    and slots it reads, and its result; its node tests are dfs_tests' box
    tests, and it never makes more Woop tests than the block sweep
    (dfs_tests), on the scenes of many leaves far fewer."""
    ts, (o, d, lo, hi), closest, any_hit = _walks(pairs, name)
    zero = torch.zeros_like(hi)
    for seg_lo, walk, hit in ((zero, closest, False), (lo, any_hit, True)):
        g = ds.gated_tests(ts, o, d, seg_lo, hi, hit)
        assert torch.equal(g.nodes, walk[1]) and torch.equal(g.clusters, walk[2])
        assert torch.equal(g.woop, walk[3])
        assert torch.equal(g.node_rows, walk[4]) and torch.equal(g.slots, walk[5])
        if hit:
            assert torch.equal(g.result, walk[0])
        else:
            assert torch.equal(g.result[0], walk[0][0]) and torch.equal(g.result[1], walk[0][1])
        boxes, woops, _ = ds.dfs_tests(ts, o, d, seg_lo, hi, hit)
        assert torch.equal(g.nodes, boxes) and bool((g.woop <= woops).all())
        assert int(g.woop.sum()) > 0 and bool((g.woop[~(hi > seg_lo)] == 0).all())
        if ts.bvh_dfs_meta.shape[1] > 8:
            assert int(g.woop.sum()) * 4 < int(woops.sum())


@pytest.mark.parametrize("name", SCENES)
def test_plain_walk_matches_jax_on_nan_lanes(pairs, name):
    """The node vote keeps torch's NaN rule, as JAX's kernels do
    (jnp.maximum keeps a NaN): on rays with NaN origin and direction
    components, zero direction components and inactive lanes
    (chip_smoke.odd_lanes), the plain walk at JAX's block size equals JAX
    dfs_closest / dfs_any in interpret mode: t and occ bit for bit on every
    lane, NaN lanes included (t 1e30, never occluded), prim under the tie
    rule of test_plain_closest_matches_jax."""
    js, ts = pairs[name]
    o, d, lo, hi = (x.numpy() for x in odd_lanes([_t(x) for x in _rays(js, 900, 21)]))
    nan = np.isnan(o).any(1) | np.isnan(d).any(1)
    assert nan.sum() > 10
    t_j, prim_j = (np.asarray(x) for x in jdfs.dfs_closest(
        js, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(hi), interpret=True)[:2])
    t, prim = (x.numpy() for x in ds.dfs_closest_ref(
        ts, _t(o), _t(d), t_max=_t(hi), block=_jax_block(js, jdfs.fused_attr_rows(js)))[:2])
    np.testing.assert_array_equal(t, t_j)
    np.testing.assert_array_equal(prim >= 0, prim_j >= 0)
    assert np.mean(prim != prim_j) < 0.01 and (prim_j >= 0).sum() > 100
    assert (t[nan] == 1e30).all() and (prim[nan] == -1).all()
    occ_j = np.asarray(jdfs.dfs_any(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                    jnp.asarray(hi), interpret=True))
    occ = ds.dfs_any_ref(ts, _t(o), _t(d), _t(lo), _t(hi), block=_jax_block(js, 0)).numpy()
    np.testing.assert_array_equal(occ, occ_j)
    assert 50 < occ.sum() and not occ[nan].any()


def test_leaf_clusters_checks_what_the_gate_needs(pairs):
    """The tables the gate skips by: leaf_clusters passes the built scenes
    and raises ValueError on leaves of 128 slots that are no whole number
    of clusters and on Woop rows off a 16-byte boundary; scene_from_arrays
    raises where the gate would skip a hit: a triangle in a slot of an
    empty cluster or a leaf that starts inside a cluster."""
    from gpuspectral_tpu_torch.scene.data import scene_to_arrays

    ts = pairs["sphere_field"][1]
    lo, hi, rows = ds.leaf_clusters(ts)
    assert lo.shape == (ts.bvh_clusters, 3) and rows is ts.tri_woop
    ds.leaf_clusters(soup_scene(3000, 3, "cpu"))
    off_rows = torch.zeros(ts.tri_woop.numel() + 1)[1:].view(ts.tri_woop.shape)
    off_rows.copy_(ts.tri_woop)
    for bad in (ts.replace(bvh_leaf_size=48), ts.replace(tri_woop=off_rows)):
        with pytest.raises(ValueError):
            ds.leaf_clusters(bad)
    arrays, meta = scene_to_arrays(ts)
    empty = np.nonzero(cs.cluster_boxes(ts)[2].numpy())[0]
    assert empty.size > 0
    w = np.array(arrays["tri_woop"], copy=True)
    w[int(empty[0]) * ts.bvh_leaf_size] = 1.0
    dfs_meta = np.array(arrays["bvh_dfs_meta"], copy=True)
    dfs_meta[1, np.nonzero(dfs_meta[1] > 0)[0][0]] += 1
    scene_from_arrays(arrays, meta, "cpu")
    for key, value in (("tri_woop", w), ("bvh_dfs_meta", dfs_meta)):
        with pytest.raises(ValueError):
            scene_from_arrays(dict(arrays, **{key: value}), meta, "cpu")
