"""PyTorch port: K7h's plain version, the packet traversal (bvh/traverse.py,
behind bvh/kernels.py's wrappers), against the JAX Pallas traversal
(gpuspectral_tpu/bvh/kernels.py:traverse_pallas) in interpret mode on
tests/test_pallas.py's soups and rays, with its tolerances; the tie rule
where the two differ; the packed leaf table bit for bit; K7h's node rows
(pack_nodes) on the sah, morton and slot-mode builds, and the plain walk
that skips their marked subtrees against the plain version and the JAX
XLA traversal; the kernel's test counts against a walk of one packet at a
time; the wrappers' dispatch and TraverseClosestDiff's backward; and the
wavefront with intersector "mt" and a BVH against the JAX wavefront.  Both
packages get the same numpy inputs.  The CUDA kernel against this plain
version: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.bvh import build as jax_bvh_build
from gpuspectral_tpu.bvh import traverse as jtr
from gpuspectral_tpu.bvh.build import build_bvh
from gpuspectral_tpu.bvh.kernels import _pack_tris, traverse_pallas
from gpuspectral_tpu.integrator.path_tracer import render_sample as jax_render_sample
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.bvh import build as port_bvh_build
from gpuspectral_tpu_torch.bvh import kernels as tk
from gpuspectral_tpu_torch.bvh import traverse as ttr
from gpuspectral_tpu_torch.scene import data as tdata
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field
from gpuspectral_tpu_torch.utils import RenderConfig

from chip_smoke import odd_lanes
from test_torch_bvh import SMALL_FIELD
from torch_common import assert_mega_gates, jax_scene_arrays, launches


def _pallas_soup(n_tris, seed, spread, size):
    """tests/test_pallas.py's soups: padded to 128, Morton-sorted."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-spread, spread, size=(n_tris, 1, 3))
    tris = (centers + rs.uniform(-size, size, size=(n_tris, 3, 3))).astype(np.float32)
    pad = -(-n_tris // 128) * 128 - n_tris
    padded = np.concatenate([tris, np.zeros((pad, 3, 3), np.float32)])
    bvh = build_bvh(padded, n_tris)
    return padded[bvh.perm], bvh, rs


def _unit_rays(rs, r, lo, hi, aim=None):
    """Origins in [lo, hi]^3, directions random or, with `aim`, towards
    points of [-aim, aim]^3."""
    o = rs.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)) if aim is None else rs.uniform(-aim, aim, size=(r, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _jax_tree(bvh):
    return (jnp.asarray(bvh.node_min), jnp.asarray(bvh.node_max), bvh.n_clusters, bvh.leaf_size,
            bvh.n_levels)


def _port_tree(tris, bvh):
    return (tk.pack_tris(torch.as_tensor(tris), bvh.n_clusters, bvh.leaf_size),
            torch.as_tensor(bvh.node_min), torch.as_tensor(bvh.node_max), bvh.n_levels)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("n_tris", [60, 500])
def test_closest_matches_pallas_interpret(n_tris):
    """tests/test_pallas.py:test_pallas_interpret_matches_bruteforce's case:
    prim equal, t within rtol 1e-5, u and v within atol 1e-5."""
    tris, bvh, rs = _pallas_soup(n_tris, 11, 3.0, 0.4)
    o, d = _unit_rays(rs, 64, -5, 5)
    ref = traverse_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), *_jax_tree(bvh),
                          t_min=jnp.zeros(()), t_max=jnp.full((), 1e30), packet_size=32,
                          interpret=True)
    t, prim, u, v = tk.traverse_closest(_t(o), _t(d), *_port_tree(tris, bvh), torch.zeros(64),
                                        torch.full((64,), 1e30), 32)
    t_r, prim_r, u_r, v_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(prim.numpy(), prim_r)
    hit = prim_r >= 0
    assert hit.any()
    np.testing.assert_allclose(t.numpy()[hit], t_r[hit], rtol=1e-5)
    np.testing.assert_allclose(u.numpy()[hit], u_r[hit], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit], v_r[hit], atol=1e-5)


def test_any_hit_matches_pallas_interpret():
    """tests/test_pallas.py:test_pallas_interpret_any_hit's case."""
    rs = np.random.default_rng(5)
    tris = rs.uniform(-1, 1, size=(100, 3, 3)).astype(np.float32)
    padded = np.concatenate([tris, np.zeros((28, 3, 3), np.float32)])
    bvh = build_bvh(padded, 100)
    tris = padded[bvh.perm]
    o, d = _unit_rays(rs, 32, -2, -1.5)
    _, prim, _, _ = traverse_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
                                    *_jax_tree(bvh), t_min=jnp.zeros(()), t_max=jnp.full((), 4.0),
                                    packet_size=32, any_hit=True, interpret=True)
    occ = tk.traverse_any(_t(o), _t(d), *_port_tree(tris, bvh), torch.zeros(32),
                          torch.full((32,), 4.0), 32)
    assert 0 < int(occ.sum()) < 32
    np.testing.assert_array_equal(occ.numpy(), np.asarray(prim) >= 0)


def _four_leaf_tie():
    """One triangle in slot 5 (leaf 0) and again in slot 55 (leaf 3) of a
    hand-built tree of 4 leaves x 16 slots; leaves 1 and 2 are empty."""
    tri = np.array([[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]], np.float32)
    tris = np.zeros((64, 3, 3), np.float32)
    tris[5] = tris[55] = tri
    node_min = np.full((7, 3), np.inf, np.float32)
    node_max = np.full((7, 3), -np.inf, np.float32)
    for leaf in (3, 6):
        node_min[leaf], node_max[leaf] = tri.min(0), tri.max(0)
    for n in (2, 1, 0):
        node_min[n] = np.minimum(node_min[2 * n + 1], node_min[2 * n + 2])
        node_max[n] = np.maximum(node_max[2 * n + 1], node_max[2 * n + 2])
    o = np.array([[0.25, 0.5, 0.0], [0.5, 0.25, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    return tris, node_min, node_max, o, d


def test_exact_t_ties_across_leaves():
    """JAX's Pallas kernel pushes 2n+1 then 2n+2 and so visits
    the right subtree first: of one triangle stored in leaves 0 and 3 it
    reports the later slot.  The port (and the JAX XLA traversal) visits
    the left subtree first and reports the earlier; t, u and v are equal."""
    tris, node_min, node_max, o, d = _four_leaf_tie()
    tree = (jnp.asarray(node_min), jnp.asarray(node_max), 4, 16, 3)
    pallas = traverse_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), *tree,
                             t_min=jnp.zeros(()), t_max=jnp.full((), 1e30), packet_size=8,
                             interpret=True)
    xla = jtr.intersect_closest_bvh(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), *tree,
                                    packet_size=8)
    port = ttr.intersect_closest_bvh(_t(o), _t(d), tk.pack_tris(_t(tris), 4, 16), _t(node_min),
                                     _t(node_max), 3, packet_size=8)
    assert np.asarray(pallas[1]).tolist() == [55, 55]
    assert np.asarray(xla[1]).tolist() == [5, 5] and port[1].tolist() == [5, 5]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(port[i].numpy(), np.asarray(pallas[i]))
        np.testing.assert_array_equal(port[i].numpy(), np.asarray(xla[i]))


@pytest.mark.parametrize("n_tris", [40, 64, 100])
def test_pack_tris_matches_jax(n_tris):
    """Shorter than, equal to and longer than C * leaf = 4 x 16 rows: the
    (C, leaf, 12) rows bit for bit."""
    tris = np.random.default_rng(n_tris).normal(size=(n_tris, 3, 3)).astype(np.float32)
    ref = np.asarray(_pack_tris(jnp.asarray(tris), 4, 16))
    got = tk.pack_tris(_t(tris), 4, 16)
    assert got.dtype == torch.float32 and got.shape == (4, 16, 12)
    np.testing.assert_array_equal(got.numpy(), ref)


def _build(mode, monkeypatch):
    """(sorted triangles (T, 3, 3), node_min, node_max, C, leaf, n_levels) of
    the port's build in `mode`: "sah" or "morton" on a 700-triangle soup
    (44 clusters padded to 64), "slot" the small sphere field in slot mode
    (bins of SAH subtrees, empty clusters between the real ones)."""
    if mode == "slot":
        import gpuspectral_tpu.integrator.mega  # noqa: F401  (it checks the threshold)

        monkeypatch.setattr(jax_bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        monkeypatch.setattr(port_bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        ts = populate_sphere_field(tdata.SceneBuilder(), **SMALL_FIELD).build("cpu")
        return (ts.tri_pos.numpy(), ts.bvh_node_min.numpy(), ts.bvh_node_max.numpy(),
                ts.bvh_clusters, ts.bvh_leaf_size, ts.bvh_levels)
    rs = np.random.default_rng(3)
    tris = (rs.uniform(-4.0, 4.0, size=(700, 1, 3))
            + rs.uniform(-0.3, 0.3, size=(700, 3, 3))).astype(np.float32)
    padded = np.concatenate([tris, np.zeros((68, 3, 3), np.float32)])
    bvh = port_bvh_build.build_bvh(padded, 700, order=mode)
    return (padded[bvh.perm], bvh.node_min, bvh.node_max, bvh.n_clusters, bvh.leaf_size,
            bvh.n_levels)


def _ancestors(node):
    while True:
        yield node
        if node == 0:
            return
        node = (node - 1) // 2


@pytest.mark.parametrize("mode", ["sah", "morton", "slot"])
def test_pack_nodes_marks_only_empty_clusters(mode, monkeypatch):
    """K7h's node rows [min, empty, max, 0] on each build mode: the boxes
    as built, `empty` exactly on the inverted boxes, and no marked node over
    a cluster whose packed rows are not all zero (every real cluster and
    its ancestors unmarked)."""
    tris, node_min, node_max, c, leaf, _ = _build(mode, monkeypatch)
    packed = tk.pack_tris(_t(tris), c, leaf)
    nodes = tk.pack_nodes(_t(node_min), _t(node_max), packed)
    assert nodes.dtype == torch.float32 and nodes.shape == (2 * c - 1, 8) and nodes.is_contiguous()
    np.testing.assert_array_equal(nodes[:, 0:3].numpy(), node_min)
    np.testing.assert_array_equal(nodes[:, 4:7].numpy(), node_max)
    assert (nodes[:, 7] == 0).all()
    marked = nodes[:, 3].numpy()
    np.testing.assert_array_equal(marked, (node_min > node_max).any(1).astype(np.float32))
    assert 0 < marked.sum() < 2 * c - 1
    full = (packed != 0).reshape(c, -1).any(1).numpy()
    assert full.sum() > 1
    for cluster in np.nonzero(full)[0]:
        assert not any(marked[n] for n in _ancestors(c - 1 + int(cluster)))
    for n in np.nonzero(marked)[0]:  # a marked node covers zero rows only
        first, count = int(n), 1
        while first < c - 1:
            first, count = 2 * first + 1, 2 * count
        assert not full[first - (c - 1):first - (c - 1) + count].any()


@pytest.mark.parametrize("mode", ["sah", "morton", "slot"])
def test_plain_walk_skipping_marked_subtrees_matches(mode, monkeypatch):
    """The plain traversal on the tree with pack_nodes' marked boxes made
    NaN (never entered) equals the plain traversal on the boxes as built
    and the JAX XLA traversal, bit for bit: t, prim, u, v and occ, with
    NaN and inactive lanes and a ragged last packet."""
    tris, node_min, node_max, c, leaf, levels = _build(mode, monkeypatch)
    port = (tk.pack_tris(_t(tris), c, leaf), _t(node_min), _t(node_max), levels)
    nodes = tk.pack_nodes(*port[1:3], port[0])
    marked = nodes[:, 3:4] == 1
    skip = (port[0], torch.where(marked, float("nan"), port[1]),
            torch.where(marked, float("nan"), port[2]), levels)
    lo_box, hi_box = node_min[0], node_max[0]
    rs = np.random.default_rng(11)
    o = rs.uniform(lo_box - 1, hi_box + 1, size=(700, 3)).astype(np.float32)
    d = (rs.uniform(lo_box, hi_box, size=(700, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rs.uniform(size=700) < 0.5, 0.0, rs.uniform(0, 0.5, 700)).astype(np.float32)
    t_max = np.where(rs.uniform(size=700) < 0.5, 1e30, rs.uniform(1, 9, 700)).astype(np.float32)
    o, d, t_min, t_max = odd_lanes([_t(x) for x in (o, d, t_min, t_max)])
    jtree = (jnp.asarray(node_min), jnp.asarray(node_max), c, leaf, levels)
    jray = [jnp.asarray(x.numpy()) for x in (o, d, t_min, t_max)]
    zero = torch.zeros_like(t_max)
    ref = jtr.intersect_closest_bvh(*jray[:2], jnp.asarray(tris), *jtree, t_min=jnp.zeros(700),
                                    t_max=jray[3], packet_size=64)
    occ_ref = jtr.intersect_any_bvh(*jray[:2], jnp.asarray(tris), *jtree, t_min=jray[2],
                                    t_max=jray[3], packet_size=64)
    assert int((np.asarray(ref[1]) >= 0).sum()) > 20 and 5 < int(np.asarray(occ_ref).sum()) < 690
    for tree in (port, skip):
        got = ttr.intersect_closest_bvh_ref(o, d, *tree, zero, t_max, 64)
        _assert_np_equal(got, ref)
        _assert_np_equal([ttr.intersect_any_bvh_ref(o, d, *tree, t_min, t_max, 64)], [occ_ref])


def _assert_np_equal(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("where", ["leaf", "internal"])
def test_pack_nodes_rejects_rows_under_a_marked_node(where):
    """A cluster under an inverted box must have all-zero rows: a non-zero
    row there (in an empty padding cluster, or under an internal node whose
    box was inverted by hand over real clusters) raises, since K7h would
    skip a row that can hit."""
    tris, bvh, _ = _pallas_soup(700, 3, 4.0, 0.3)
    packed, node_min, node_max, _ = _port_tree(tris, bvh)
    c = bvh.n_clusters
    tk.pack_nodes(node_min, node_max, packed)
    if where == "leaf":  # an empty padding cluster given a row
        leaf = int(torch.nonzero((node_min > node_max).any(1)[c - 1:])[0, 0])
        packed = packed.clone()
        packed[leaf, 3, 4] = 0.5
    else:  # the root's left child, over real clusters, inverted
        node_min, node_max = node_min.clone(), node_max.clone()
        node_min[1], node_max[1] = float("inf"), -float("inf")
    with pytest.raises(ValueError, match="inverted box"):
        tk.pack_nodes(node_min, node_max, packed)


def _walk_one_packet(rays, tree, any_hit):
    """(nodes popped, leaves entered) of one packet's plain walk, counted
    from the calls it makes to the slab and Moller-Trumbore tests."""
    calls = dict(box=0, leaf=0)
    real_box, real_mt = ttr._ray_aabb, ttr._mt_edges

    def box(*a):
        calls["box"] += 1
        return real_box(*a)

    def mt(*a):
        calls["leaf"] += a[2].shape[0]
        return real_mt(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "_ray_aabb", box)
        mp.setattr(ttr, "_mt_edges", mt)
        out = ttr.traverse_ref(*rays[:2], *tree, *rays[2:], any_hit, rays[0].shape[0])
    return calls["box"], calls["leaf"], out


@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_tests_count_the_walk(any_hit):
    """traverse_tests against the plain walk of one packet at a time: every
    ray of a packet slab-tests each node it pops (any hit: a ray that ends
    unoccluded) and a ray with a window tests every slot of each leaf the
    packet enters (any hit: an occluded ray fewer, at least one)."""
    tris, bvh, rs = _pallas_soup(700, 3, 4.0, 0.3)
    tree = _port_tree(tris, bvh)
    o, d = _unit_rays(rs, 96, -6, 6)
    t_max = np.where(rs.uniform(size=96) < 0.5, 1e30, rs.uniform(2, 9, 96)).astype(np.float32)
    t_max[::9] = -1e30  # inactive: an empty window tests no slot
    rays = [_t(o), _t(d), torch.zeros(96), _t(t_max)]
    boxes, tests, out = tk.traverse_tests(*rays[:2], *tree, *rays[2:], any_hit, 32)
    ref = tk.traverse_any(*rays[:2], *tree, *rays[2:], 32) if any_hit else \
        tk.traverse_closest(*rays[:2], *tree, *rays[2:], 32)
    for a, b in zip([out] if any_hit else out, [ref] if any_hit else ref):
        assert torch.equal(a, b)
    leaf_size = tree[0].shape[1]
    for p in range(3):
        s = slice(32 * p, 32 * (p + 1))
        nodes, leaves, res = _walk_one_packet([x[s] for x in rays], tree, any_hit)
        window = rays[3][s] > 0
        full = window & ~res if any_hit else window
        assert leaves > 0 and nodes > leaves
        assert (boxes[s][full] == nodes).all() and (tests[s][full] == leaf_size * leaves).all()
        assert (tests[s][~window] == 0).all()
        if any_hit:
            occ = res & window
            assert occ.any() and ((boxes[s][occ] <= nodes) & (tests[s][occ] >= 1)).all()
            assert (tests[s][occ] <= leaf_size * leaves).all()
        else:
            assert (boxes[s] == nodes).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_skip_empty_counts_the_needed_tests(any_hit):
    """traverse_tests with skip_empty (every inverted box, an empty cluster
    or a node over empty ones only, made NaN): the same result as K7h's
    walk, never more tests for a ray, and fewer Moller-Trumbore tests in
    all on a soup whose tree pads 44 clusters to 64 (the tests its bound
    counts)."""
    tris, bvh, rs = _pallas_soup(700, 3, 4.0, 0.3)
    tree = _port_tree(tris, bvh)
    assert bool((tree[1] > tree[2]).any())
    o, d = _unit_rays(rs, 96, -6, 6)
    rays = [_t(o), _t(d), torch.zeros(96), torch.full((96,), 1e30)]
    if any_hit:
        rays[3] = _t(rs.uniform(2, 9, 96).astype(np.float32))
    walk = tk.traverse_tests(*rays[:2], *tree, *rays[2:], any_hit, 32)
    need = tk.traverse_tests(*rays[:2], *tree, *rays[2:], any_hit, 32, skip_empty=True)
    for a, b in zip([walk[2]] if any_hit else walk[2], [need[2]] if any_hit else need[2]):
        assert torch.equal(a, b)
    assert (need[0] <= walk[0]).all() and (need[1] <= walk[1]).all()
    assert int(need[1].sum()) < int(walk[1].sum()) and int(need[1].sum()) > 0


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain versions (no launch);
    intersect_closest_bvh / intersect_any_bvh dispatch only through them
    (the closest hit through traverse_closest_diff), so they give the plain
    versions' results; another device is refused."""
    tris, bvh, rs = _pallas_soup(500, 11, 3.0, 0.4)
    tree = _port_tree(tris, bvh)
    o, d = (_t(x) for x in _unit_rays(rs, 100, -5, 5))
    lo, hi = torch.zeros(100), torch.full((100,), 1e30)
    n0 = (launches(tk.traverse_closest), launches(tk.traverse_any))
    got = tk.traverse_closest(o, d, *tree, lo, hi, 16)
    occ = tk.traverse_any(o, d, *tree, lo, torch.full((100,), 3.0), 16)
    assert (launches(tk.traverse_closest), launches(tk.traverse_any)) == n0
    for a, b in zip(got, ttr.intersect_closest_bvh_ref(o, d, *tree, lo, hi, 16)):
        assert torch.equal(a, b)
    assert torch.equal(occ, ttr.intersect_any_bvh_ref(o, d, *tree, lo, torch.full((100,), 3.0),
                                                       16))
    calls = []
    for fn in ("traverse_closest_diff", "traverse_any"):
        real = getattr(tk, fn)
        monkeypatch.setattr(tk, fn, lambda *a, _r=real: calls.append(1) or _r(*a))
    plain = ttr.intersect_closest_bvh(o, d, *tree, packet_size=16)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    assert torch.equal(ttr.intersect_any_bvh(o, d, *tree, lo, 3.0, packet_size=16), occ)
    assert len(calls) == 2
    meta = [x.to("meta") for x in (o, d, *tree[:3], lo, hi)]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.traverse_closest(*meta[:5], tree[3], *meta[5:])


def test_closest_diff_backward_matches_autograd_through_the_plain_version():
    """TraverseClosestDiff with the plain forward (what traverse_closest_diff
    runs on CPU tensors): its backward, the winner's Moller-Trumbore test
    evaluated again, equals autograd through the plain traversal."""
    tris, bvh, rs = _pallas_soup(700, 3, 4.0, 0.3)
    tree = _port_tree(tris, bvh)
    o, d = _unit_rays(rs, 300, -6, 6, aim=4)
    w = _t(rs.normal(size=(3, 300)).astype(np.float32))
    lo, hi = torch.zeros(300), torch.full((300,), 1e30)
    grads = []
    for fn in (tk.traverse_closest_diff, ttr.intersect_closest_bvh_ref):
        oo, dd = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
        t, prim, u, v = fn(oo, dd, *tree, lo, hi, 64)
        hit = prim >= 0
        loss = torch.where(hit, w[0] * t + w[1] * u + w[2] * v, 0.0).sum()
        grads.append(torch.autograd.grad(loss, (oo, dd)))
    assert int((prim >= 0).sum()) > 40 and float(grads[0][1].abs().max()) > 0
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_wavefront_mt_bvh_matches_jax(monkeypatch):
    """The slice's path at a small size: render_sample (16x16, depth 3) on
    the small sphere field with intersector "mt" and a BVH against the JAX
    wavefront under the tests/test_mega.py gates; the leaf rows and K7h's
    node rows are packed once for the render, not once per bounce."""
    js = populate_sphere_field(JaxBuilder(), **SMALL_FIELD).build()
    ts = scene_from_arrays(*jax_scene_arrays(js), "cpu")
    packs = []
    for name in ("pack_tris", "pack_nodes"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _r=real, _n=name: packs.append(_n) or _r(*a))
    base = dict(width=16, height=16, max_depth=3, use_bvh=True, intersector="mt")
    pix = np.arange(256, dtype=np.uint32)
    ref, rays_ref = jax_render_sample(js, JaxConfig(**base), jnp.asarray(pix), jnp.uint32(5))
    got, rays_got = pt.render_sample(ts, RenderConfig(**base),
                                     torch.as_tensor(pix.astype(np.int64)), 5)
    assert packs == ["pack_tris", "pack_nodes"]
    assert_mega_gates(np.asarray(ref)[:, None], got.numpy()[:, None],
                      float(np.asarray(rays_ref).sum()), float(rays_got.sum()))
