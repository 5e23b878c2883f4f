"""The packed rows of the BVH walk of K3, K4 and K6 (csrc/bvh.cuh), on the CPU.

The scene packs them once when it is made (scene/data.py:scene_from_arrays,
bvh/tables.py:build_pair_rows; the Woop rows are the scene's (T, 12)
tri_woop):

  * the Woop and child-pair rows decode to the SoA tables of
    bvh/ftb.py:kernel_tables (the preorder walk's: its Woop table and its
    cluster boxes) and to the heap boxes bit for bit;
  * the pair table reaches every cluster that holds a triangle exactly
    once, each as a leaf of its own, and no empty (padding) cluster; those
    are the non-empty clusters of the preorder table's leaves;
  * a numpy walk over the pair table, written here as csrc/bvh.cuh's walk
    is (both children tested, the nearer first, the farther stacked and
    culled on pop by its entry distance), gives the plain K3's t, prim, u,
    v and occ (the brute-force Woop scan) bit for bit, exact-t ties, NaN
    and inactive lanes included.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch.bvh import build as bvh_build
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.bvh.tables import EMPTY_ROOT, build_pair_rows
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field, build_zoo

from chip_smoke import field_rays, odd_lanes, soup_scene
from torch_common import CORNELL_XML

SLAB_MARGIN = np.float32(1.0 / 16384.0)  # csrc/bvh.cuh:kSlabMargin
BIG = np.float32(1e30)
F32 = np.float32


def _scene(name, monkeypatch):
    if name == "cornell":
        return load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]
    if name == "zoo":
        return build_zoo("cpu")
    if name == "soup2048":
        return soup_scene(2048, 7, "cpu")
    if name == "field_small":
        return build_sphere_field("cpu", n_side=2, segs=16, rings=8)
    if name == "slot_mode":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        return build_sphere_field("cpu", n_side=2, segs=16, rings=8)
    if name == "morton":
        return soup_scene(700, 3, "cpu", order="morton")
    assert name == "ties"
    return soup_scene(600, 5, "cpu", ties=True)


SCENES = ["cornell", "zoo", "soup2048", "field_small", "slot_mode", "morton", "ties"]


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _codes(pairs):
    """(P, 2) int32 child codes of the pair rows (lanes 3 and 7)."""
    return pairs.view(np.int32)[:, [3, 7]]


def _heap_of(code, codes, n_clusters):
    """Heap index of the implicit-tree node a code stands for: cluster ~code
    for a leaf, a pair's the lowest common ancestor of its two children's
    nodes."""
    if code < 0:
        return n_clusters - 1 + ~int(code)
    a, b = (_heap_of(int(c), codes, n_clusters) for c in codes[code])
    while a != b:
        a, b = ((a - 1) // 2, b) if a > b else (a, (b - 1) // 2)
    return a


def _leaves(pairs, root):
    """The clusters the pair table reaches, one a leaf, in walk order."""
    codes = _codes(pairs)
    out, todo = [], [] if root == EMPTY_ROOT else [root]
    while todo:
        code = todo.pop()
        if code < 0:
            out.append(~code)
        else:
            todo.extend(int(c) for c in codes[code])
    return out


@pytest.mark.parametrize("name", SCENES)
def test_packed_rows_decode_to_kernel_tables(name, monkeypatch):
    """The Woop rows are tri_woop_t transposed; a pair's child boxes are the
    heap boxes of its children, a leaf child's the cluster's box of the
    (6, C) table of kernel_tables; its two spare lanes are zero;
    walk_tables hands the scene's own tensors."""
    ts = _scene(name, monkeypatch)
    nodes, meta, clusters, woop_t, ip = ftb.kernel_tables(ts)
    woop = ts.tri_woop.numpy()
    assert ts.tri_woop.dtype == torch.float32 and ts.tri_woop.is_contiguous()
    np.testing.assert_array_equal(_bits(woop), _bits(woop_t.numpy().T))

    pairs = ts.bvh_pairs.numpy()
    c = ts.bvh_clusters
    assert pairs.shape[1] == 16 and ts.bvh_pairs.is_contiguous()
    assert (pairs[:, 11] == 0).all() and (pairs[:, 15] == 0).all()
    codes = _codes(pairs)
    node_min, node_max = ts.bvh_node_min.numpy(), ts.bvh_node_max.numpy()
    box = clusters.numpy()
    for i in range(pairs.shape[0]):
        for k in range(2):
            code = int(codes[i, k])
            h = _heap_of(code, codes, c)
            np.testing.assert_array_equal(_bits(pairs[i, 8 * k:8 * k + 3]), _bits(node_min[h]))
            np.testing.assert_array_equal(_bits(pairs[i, 8 * k + 4:8 * k + 7]),
                                          _bits(node_max[h]))
            if code < 0:
                np.testing.assert_array_equal(_bits(pairs[i, 8 * k:8 * k + 3]),
                                              _bits(box[0:3, ~code]))
                np.testing.assert_array_equal(_bits(pairs[i, 8 * k + 4:8 * k + 7]),
                                              _bits(box[3:6, ~code]))

    tables = ftb.walk_tables(ts)
    assert tables[0] is ts.bvh_pairs and tables[1] is ts.tri_woop
    assert tables[2].tolist() == [woop.shape[0], ts.bvh_leaf_size, ts.bvh_root]
    assert ip.tolist()[1:4] == [c, woop.shape[0], ts.bvh_leaf_size]


@pytest.mark.parametrize("name", SCENES)
def test_pair_rows_reach_each_full_cluster_once(name, monkeypatch):
    """The pair table reaches each cluster with a triangle exactly once, as
    a leaf of its own, and no empty cluster: the non-empty clusters of the
    preorder table's leaves (build_dfs_tables, the scene's bvh_dfs_meta),
    so no padding subtree is left.  Its rows are in breadth-first order (a
    child after its parent), and a path from the root holds at most
    log2(C) of them (the walk's stack, csrc/bvh.cuh:kMaxDepth)."""
    ts = _scene(name, monkeypatch)
    leaves = _leaves(ts.bvh_pairs.numpy(), ts.bvh_root)
    assert len(leaves) == len(set(leaves))
    lo, hi = ts.bvh_node_min.numpy(), ts.bvh_node_max.numpy()
    c = ts.bvh_clusters
    full = lo[c - 1:, 0] <= hi[c - 1:, 0]
    first = ts.bvh_dfs_meta[1].numpy()
    span = max(2, 128 // ts.bvh_leaf_size)
    in_dfs = {k for f in first[first >= 0] for k in range(f // ts.bvh_leaf_size,
                                                          f // ts.bvh_leaf_size + span)}
    want = sorted(k for k in in_dfs if k < c and full[k])
    assert sorted(leaves) == want == sorted(np.nonzero(full)[0].tolist())
    codes = _codes(ts.bvh_pairs.numpy())
    depth = np.zeros(codes.shape[0] + 1, int)
    for i in range(codes.shape[0] - 1, -1, -1):
        kids = [int(x) for x in codes[i] if x >= 0]
        assert all(k > i for k in kids)
        depth[i] = 1 + max((depth[k] for k in kids), default=0)
    assert (depth[0] if codes.shape[0] else 0) <= int(np.log2(c))
    assert (ts.bvh_root == 0) == (codes.shape[0] > 0)


def _tree(mode, monkeypatch):
    """(node_min, node_max, C, leaf size, cluster holds a triangle) of the
    port's build: "sah" or "morton" on a 700-triangle soup (44 clusters
    padded to 64), "slot" a slot-mode build of it (bins of SAH subtrees,
    empty clusters between the real ones)."""
    rs = np.random.default_rng(3)
    tris = (rs.uniform(-4.0, 4.0, size=(700, 1, 3))
            + rs.uniform(-0.3, 0.3, size=(700, 3, 3))).astype(np.float32)
    padded = np.concatenate([tris, np.zeros((68, 3, 3), np.float32)])
    if mode == "slot":
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
    bvh = bvh_build.build_bvh(padded, 700, order="sah" if mode == "slot" else mode)
    slots = np.full(bvh.n_clusters * bvh.leaf_size, -1)
    slots[:bvh.perm.shape[0]] = np.where(bvh.perm < 700, bvh.perm, -1)
    full = (slots.reshape(bvh.n_clusters, -1) >= 0).any(1)
    return bvh.node_min, bvh.node_max, bvh.n_clusters, bvh.leaf_size, full


@pytest.mark.parametrize("order", ["sah", "morton"])
def test_scene_build_takes_the_tree_order(order):
    """SceneBuilder.build(order=...) builds the scene's tree in that order:
    its heap boxes are bvh/build.py's in that order and not in the other
    (the morton cases here and on the card rest on it)."""
    from gpuspectral_tpu_torch.bsdf.table import diffuse
    from gpuspectral_tpu_torch.scene.data import SceneBuilder

    rs = np.random.default_rng(11)
    tris = (rs.uniform(-2.0, 2.0, size=(700, 1, 3))
            + rs.normal(scale=0.15, size=(700, 3, 3))).astype(np.float32)
    b = SceneBuilder()
    b.add_object(tris, tris, None, np.eye(4, dtype=np.float32), b.add_bsdf(diffuse((0.5,) * 3)))
    ts = b.build("cpu", order=order)
    padded = np.concatenate([tris, np.zeros((ts.tri_pos.shape[0] - 700, 3, 3), np.float32)])
    for other in ("sah", "morton"):
        want = bvh_build.build_bvh(padded, 700, order=other).node_min
        assert np.array_equal(ts.bvh_node_min.numpy(), want) == (other == order)


@pytest.mark.parametrize("mode", ["sah", "morton", "slot"])
def test_pair_rows_of_each_build(mode, monkeypatch):
    """build_pair_rows on the sah, morton and slot-mode builds: the leaves
    are exactly the clusters that hold a triangle (the slot mode's empty
    clusters between real ones pruned too), each child box is its heap
    node's box, and there is one row fewer than leaves."""
    node_min, node_max, c, leaf_size, full = _tree(mode, monkeypatch)
    assert full.any() and (mode != "slot" or not full[:np.nonzero(full)[0].max()].all())
    pairs, root = build_pair_rows(node_min, node_max, c)
    codes = _codes(pairs)
    assert sorted(_leaves(pairs, root)) == np.nonzero(full)[0].tolist()
    for i in range(pairs.shape[0]):
        for k in range(2):
            h = _heap_of(int(codes[i, k]), codes, c)
            np.testing.assert_array_equal(pairs[i, 8 * k:8 * k + 3], node_min[h])
            np.testing.assert_array_equal(pairs[i, 8 * k + 4:8 * k + 7], node_max[h])
    assert pairs.shape[0] == full.sum() - 1


def test_pair_rows_of_tiny_trees():
    """A tree without a triangle has no row and the root EMPTY_ROOT; a tree
    of one full cluster no row and that cluster as its root; two full
    clusters one row."""
    inf = np.full((1, 3), np.inf, np.float32)
    assert build_pair_rows(inf, -inf, 1)[1] == EMPTY_ROOT
    lo = np.zeros((31, 3), np.float32)
    pairs, root = build_pair_rows(lo, lo + 1, 1)
    assert pairs.shape == (0, 16) and root == ~0
    hi = lo + 1
    hi[15:] = -1  # clusters 0-15 empty but for 3 and 9
    hi[15 + 3] = hi[15 + 9] = 1
    for n in range(14, -1, -1):
        hi[n] = np.maximum(hi[2 * n + 1], hi[2 * n + 2])
    pairs, root = build_pair_rows(lo, hi, 16)
    assert pairs.shape == (1, 16) and root == 0
    assert _codes(pairs).tolist() == [[~3, ~9]]
    hi[15 + 9] = -1
    assert build_pair_rows(lo, hi, 16)[0].shape == (0, 16)
    assert build_pair_rows(lo, hi, 16)[1] == ~3


# ----------------------------------------------- the walk, in numpy -------
def _fma(a, b, c):
    """m3.fma: the float32 product exact in float64, one rounding to float32."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _woop(w, o, d, t_lo, t_hi):
    """common.cuh:woop_eval on one row of 12 floats: (hit, t, u, v)."""
    opz = _fma(o[2], w[8], _fma(o[0], w[6], o[1] * w[7])) + w[11]
    dpz = _fma(d[2], w[8], _fma(d[0], w[6], d[1] * w[7]))
    live = abs(dpz) > F32(1e-12)
    t = -opz / (dpz if live else F32(1.0))
    p = [_fma(t, d[k], o[k]) for k in range(3)]
    u = _fma(p[2], w[2], _fma(p[0], w[0], p[1] * w[1])) + w[9]
    v = _fma(p[2], w[5], _fma(p[0], w[3], p[1] * w[4])) + w[10]
    hit = live and u >= 0 and v >= 0 and u + v <= 1 and t > t_lo and t < t_hi
    return hit, t, u, v


def _inv(x):
    """csrc/bvh.cuh:inv_dir1 (fmaxf: a NaN component gives 1e-12)."""
    mag = np.fmax(abs(x), F32(1e-12))
    return F32(1.0) / (-mag if x < 0 else mag)


def _slab(lo_box, hi_box, o, inv, lo, hi):
    """csrc/bvh.cuh:slab_entered: (entered, widened entry distance)."""
    with np.errstate(invalid="ignore", over="ignore"):
        t0 = (lo_box - o) * inv
        t1 = (hi_box - o) * inv
    # fminf / fmaxf: a NaN operand gives the other
    near = [np.fmin(t0[k], t1[k]) for k in range(3)]
    far = [np.fmax(t0[k], t1[k]) for k in range(3)]
    tn = np.fmax(np.fmax(near[0], near[1]), np.fmax(near[2], lo))
    tf = np.fmin(np.fmin(far[0], far[1]), np.fmin(far[2], hi))
    n = F32(tn - SLAB_MARGIN * abs(tn))
    return bool(n <= F32(tf + SLAB_MARGIN * abs(tf))), n


def _walk(scene, o, d, t_lo, t_hi, any_hit, keep=None):
    """One ray down the pair table as csrc/bvh.cuh walks it: closest hit
    (t, prim, u, v) on (0, t_hi), or any hit on (t_lo, t_hi); `keep(c)`,
    the leaf filter, says whether cluster c's slots are tested (all when
    None)."""
    pairs = scene.bvh_pairs.numpy()
    codes = _codes(pairs)
    woop = scene.tri_woop.numpy()
    leaf_size, n_slots = scene.bvh_leaf_size, woop.shape[0]
    inv = np.array([_inv(x) for x in d], np.float32)
    t_lo, t_hi = F32(t_lo), F32(t_hi)
    best = (min(t_hi, BIG), -1, F32(0), F32(0))
    if any_hit and not t_hi > t_lo:
        return False
    lo = t_lo if any_hit else F32(0)
    stack, code = [], scene.bvh_root
    while code != EMPTY_ROOT:
        if code >= 0:
            hi = t_hi if any_hit else best[0]
            ea, na = _slab(pairs[code, 0:3], pairs[code, 4:7], o, inv, lo, hi)
            eb, nb = _slab(pairs[code, 8:11], pairs[code, 12:15], o, inv, lo, hi)
            ca, cb = int(codes[code, 0]), int(codes[code, 1])
            if ea and eb:
                far_first = not any_hit and nb < na  # any hit: the left child first
                stack.append((ca, na) if far_first else (cb, nb))
                assert len(stack) <= int(np.log2(scene.bvh_clusters))
                code = cb if far_first else ca
                continue
            if ea or eb:
                code = ca if ea else cb
                continue
        elif keep is None or keep(~code):
            c = ~code
            for s in range(c * leaf_size, min((c + 1) * leaf_size, n_slots)):
                hit, t, u, v = _woop(woop[s], o, d, lo, t_hi)
                if hit and any_hit:
                    return True
                if hit and (t < best[0] or (t == best[0] and s < best[1])):
                    best = (t, s, u, v)
        code = EMPTY_ROOT
        while stack:
            c, near = stack.pop()
            hi = t_hi if any_hit else best[0]
            if any_hit or near <= F32(hi + SLAB_MARGIN * abs(hi)):
                code = c
                break
    if any_hit:
        return False
    return best if best[1] >= 0 else (BIG, -1, F32(0), F32(0))


@pytest.mark.parametrize("name", SCENES)
def test_numpy_pair_walk_matches_plain_k3(name, monkeypatch):
    """The pair walk gives the brute-force scan's closest hit and occlusion
    bit for bit, on random rays through the scene's box with NaN and
    inactive lanes mixed in; on the duplicated soup the lowest slot of each
    exactly tied pair wins."""
    ts = _scene(name, monkeypatch)
    o, d, lo, hi = odd_lanes(field_rays(160, ts, 40, "cpu"), seed=6)
    t_r, prim_r, u_r, v_r, _ = ftb.ftb_closest_ref(ts, o, d, t_max=hi)
    occ_r = ftb.ftb_any_ref(ts, o, d, lo, hi)
    assert int((prim_r >= 0).sum()) > 10 and bool(occ_r.any())
    got = [_walk(ts, *(x.numpy() for x in (o[i], d[i], lo[i], hi[i])), False)
           for i in range(o.shape[0])]
    occ = [_walk(ts, *(x.numpy() for x in (o[i], d[i], lo[i], hi[i])), True)
           for i in range(o.shape[0])]
    np.testing.assert_array_equal(_bits([g[0] for g in got]), _bits(t_r.numpy()))
    np.testing.assert_array_equal([g[1] for g in got], prim_r.numpy())
    np.testing.assert_array_equal(_bits([g[2] for g in got]), _bits(u_r.numpy()))
    np.testing.assert_array_equal(_bits([g[3] for g in got]), _bits(v_r.numpy()))
    np.testing.assert_array_equal(occ, occ_r.numpy())
    if name == "ties":
        # each hit triangle has a copy at the same t in another slot
        pos = ts.tri_pos.numpy().reshape(ts.padded_tris, 9)
        hit = prim_r.numpy()[prim_r.numpy() >= 0]
        twins = [np.nonzero((pos == pos[p]).all(1))[0] for p in hit]
        assert all(len(w) == 2 and p == w.min() for p, w in zip(hit, twins))


def test_walk_tests_need_the_card(monkeypatch):
    """walk_tests counts the tests of the kernels' own walk: there is no
    walk on the CPU (the plain versions scan every slot), so it refuses."""
    ts = _scene("field_small", monkeypatch)
    o, d, lo, hi = field_rays(8, ts, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ftb.walk_tests(ts, o, d, lo, hi, False)


def _offset(x):
    """A contiguous copy of x that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("call,table", [("walk_tables", "tri_woop"), ("walk_tables", "bvh_pairs"),
                                        ("cluster_closest", "tri_woop"),
                                        ("cluster_any", "tri_woop")])
def test_row_tables_must_be_aligned(call, table):
    """The walk (csrc/bvh.cuh) and K7d / K7e (csrc/cluster.cu) read the
    scene's pair and Woop rows with 128-bit loads: ftb.walk_tables and the
    cluster wrappers raise ValueError on a table that is not 16-byte
    aligned (on the card it would be a misaligned-address fault), and take
    the scene as built, whose tables are fresh allocations."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs

    ts = soup_scene(300, 4, "cpu")
    o, d, lo, hi = field_rays(40, ts, 3, "cpu")
    run = dict(walk_tables=lambda s: ftb.walk_tables(s),
               cluster_closest=lambda s: cs.cluster_closest(s, o, d, t_max=hi),
               cluster_any=lambda s: cs.cluster_any(s, o, d, lo, hi))[call]
    bad = ts.replace(**{table: _offset(getattr(ts, table))})
    assert getattr(bad, table).is_contiguous() and getattr(bad, table).data_ptr() % 16 == 4
    with pytest.raises(ValueError, match=f"scene.{table} must be 16-byte aligned"):
        run(bad)
    assert getattr(ts, table).data_ptr() % 16 == 0
    run(ts)
