"""K7f / K7g: the gated depth-first walk (csrc/dfs.cu), the BVH kernels of
the wavefront with cfg.bvh_kernel "dfs".

The counterpart of gpuspectral_tpu/bvh/dfs_sweep.py.  Rays go in blocks of
BLOCK consecutive rays, the rays of one warp on the card, and a block walks
the scene's preorder tables (`bvh_dfs_bounds` (6, N) boxes, `bvh_dfs_meta`
(2, N): the skip pointer past a node's subtree and, for a leaf, its first
slot, -1 for an internal node) from node 0:

  * every ray slab-tests the node's box on its segment [t_min, horizon]
    (torch's NaN rule: a ray with a NaN origin, direction or segment end
    never passes); the block enters the node if any of its rays passes
    (ptr + 1), else it jumps the subtree (ptr = skip);
  * at an entered leaf each ray takes its hits among the leaf's SWEEP = 128
    slots;
  * K7f `dfs_closest` commits t in (0, best) with a strict `<` in slot
    order, and a ray's horizon is its best hit so far, which culls the rest
    of the walk (dfs_sweep.py:187-278); the winner's attribute rows ride
    out with (t, prim, u, v);
  * K7g `dfs_any` marks a ray occluded at a hit in (t_min, t_max); an
    occluded ray's horizon falls to -1e30, so it stops voting
    (dfs_sweep.py:281-350).

The result is not always the exact closest hit: a hit in a subtree that no
ray of the block voted for (a slab test that rounds the other way at a
box's edge) is lost, as on the TPU.  The plain versions (`*_ref`) run the
same block-gated walk in torch, every block at once, each with its own
node pointer, a leaf's sweep one Woop test of ops/woop.py over (blocks,
block, SWEEP); at block=BLOCK they give exactly what the kernels give,
ties included (leaves come in ascending slot order, and the lowest slot
wins among exactly tied t).  The JAX kernels keep a best per lane and
break ties between lanes by lane position.

On the card a lane Woop-tests only the slots of the leaf clusters (of
`scene.bvh_leaf_size` slots) whose box its own widened slab test
(cluster_sweep.slab_entered) enters, on (0, best) for K7f and (t_min,
t_max) for K7g: no slot of a cluster it skips holds a hit it would take, so
the result is the same (csrc/dfs.cu, header).  The wrappers raise
ValueError unless the scene meets what that gate needs (`leaf_clusters`).

`active`, `t_min` and `t_max` mean what they mean in bvh/ftb.py: closest
hits take t in (0, t_max) and inactive rays miss; any hits take t in
(t_min, t_max) and inactive rays are never occluded.  Inactive rays carry
t_max = -1e30 and so never vote.  For CUDA tensors the wrappers launch the
kernels or raise, and count their launches in utils.profiling; for CPU tensors
they run the plain versions.  `dfs_tests` counts the tests of the block
sweep (every slot of an entered leaf for every ray), `gated_tests` those
the kernels make, for their bounds.

Not carried over from the TPU: `_block_size_arrays`' VMEM plan (the block
is a warp, BLOCK rays), `fused_attr_rows`' threshold, and the XLA
traversal above MAX_VMEM_SLOTS (gpuspectral_tpu/integrator/path_tracer.py:
213-221).  K7f always returns the attribute rows, at any scene size.

`dfs_closest_diff` is the differentiable closest hit
(dfs_sweep.closest_diff with kernel "dfs"): K7f forward, the backward of
ops/cuda_isect.woop_vjp (ftb.ClosestDiff); attrs are detached.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import math3d as m3
from ..ops import woop
from ..utils import profiling
from . import cluster_sweep, ftb

_BIG = 1e30
BLOCK = 32  # rays a block, one warp (csrc/dfs.cu:kBlock)
SWEEP = 128  # slots of a leaf (dfs_sweep.py:SWEEP)


def _blocked(x, block: int, fill: float):
    """(R, ...) -> (ceil(R / block), block, ...), the last block padded."""
    r = x.shape[0]
    nb = -(-r // block)
    pad = nb * block - r
    if pad:
        x = torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(nb, block, *x.shape[1:])


class _Gated:
    """The two-gate walk's counts while _walk runs (gated_tests): per lane,
    cluster slab tests and Woop tests; the walk's own result; the node rows
    and Woop rows some warp reads."""

    def __init__(self, scene, hi, n_nodes, n_slots):
        """Counts for the blocked segment ends `hi` (blocks, block)."""
        dev = hi.device
        self.leaf = scene.bvh_leaf_size
        self.k = SWEEP // self.leaf
        self.c_lo, self.c_hi, _ = leaf_clusters(scene)
        self.c_empty = self.c_lo[:, 0] > self.c_hi[:, 0]
        self.clusters = torch.zeros(hi.shape, dtype=torch.int64, device=dev)
        self.woops = torch.zeros_like(self.clusters)
        self.occluded = torch.zeros(hi.shape, dtype=torch.bool, device=dev)
        self.best = hi.clone()  # the closest hit's t so far
        self.prim = torch.full(hi.shape, -1, dtype=torch.int64, device=dev)
        self.nodes_read = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
        self.slots_read = torch.zeros((n_slots,), dtype=torch.bool, device=dev)

    def leaf_clusters(self, off, n_valid):
        """(clusters (n, K), their slots tested (n, K), non-empty (n, K)) of
        leaves at `off` with n_valid slots: the clusters of [off, off +
        n_valid) below the last cluster."""
        dev = off.device
        n_clusters = self.c_lo.shape[0]
        c = off[:, None] // self.leaf + torch.arange(self.k, device=dev)
        n_in = torch.clamp(off[:, None] + n_valid - c * self.leaf, 0, self.leaf)
        n_in = torch.where(c < n_clusters, n_in, 0)
        c = torch.clamp(c, max=n_clusters - 1)
        return c, n_in, (n_in > 0) & ~self.c_empty[c]

    def entered(self, c, o, inv, lo, hi):
        """(n, block) whether each lane's widened slab test enters cluster
        c (n,) on [lo, hi]."""
        return cluster_sweep.slab_entered(self.c_lo[c][:, None], self.c_hi[c][:, None], o, inv,
                                          lo, hi)

    def read(self, c, n_in, tested):
        """Mark the slots of clusters c (n, K) that `tested` (n, K, leaf)
        says some lane Woop-tests."""
        pos = c[..., None] * self.leaf + torch.arange(self.leaf, device=c.device)
        keep = tested & (torch.arange(self.leaf, device=c.device) < n_in[..., None])
        self.slots_read[pos[keep]] = True


def _walk(scene, origin, direction, t_min, t_max, any_hit: bool, block: int,
          count: bool = False):
    """The block-gated walk of K7f (any_hit False) or K7g over (R,) rays
    with segments (t_min, t_max).  Returns (best t (R,), 1e30 on a miss;
    prim (R,) int64, -1 on a miss), or with any_hit the occlusion flags
    (R,); with count, also (node tests (R,), the block sweep's Woop tests
    (R,), the two-gate walk's _Gated counts), the tests each ray makes."""
    r = origin.shape[0]
    dev = origin.device
    bounds, meta = scene.bvh_dfs_bounds, scene.bvh_dfs_meta
    n_nodes = bounds.shape[1]
    woop_rows = scene.tri_woop
    n_slots = woop_rows.shape[0]
    o = _blocked(origin.detach(), block, 0.0)
    d = _blocked(direction.detach(), block, 1.0)
    lo = _blocked(t_min, block, 0.0)
    hi = _blocked(t_max, block, -_BIG)
    # a tensor numerator: `1.0 / t` is a reciprocal then a multiply in torch
    inv = m3.safe_div(torch.ones_like(d), d)
    nb = o.shape[0]
    ptr = torch.zeros((nb,), dtype=torch.int64, device=dev)
    horizon = hi.clone()  # closest hits: the best t so far
    prim = torch.full((nb, block), -1, dtype=torch.int64, device=dev)
    occluded = torch.zeros((nb, block), dtype=torch.bool, device=dev)
    empty = ~(hi > lo)  # no t lies in (t_min, t_max): never hits
    boxes = torch.zeros((nb, block), dtype=torch.int64, device=dev)
    woops = torch.zeros((nb, block), dtype=torch.int64, device=dev)
    g = _Gated(scene, hi, n_nodes, n_slots) if count else None
    lanes = torch.arange(SWEEP, device=dev)
    if any_hit:  # a block whose rays are all empty ends at once, as K7g
        ptr = torch.where(empty.all(1), n_nodes, ptr)
    while True:
        walking = ptr < n_nodes
        if not bool(walking.any()):
            break
        node = torch.clamp(ptr, max=n_nodes - 1)
        box = bounds[:, node].t()[:, None, :]  # (nb, 1, 6)
        t0 = (box[..., 0:3] - o) * inv
        t1 = (box[..., 3:6] - o) * inv
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(near[..., 0], near[..., 1]),
                               torch.maximum(near[..., 2], lo))
        t_far = torch.minimum(torch.minimum(far[..., 0], far[..., 1]),
                              torch.minimum(far[..., 2], horizon))
        voted = walking & (t_far >= t_near).any(1)
        if count:
            boxes += walking[:, None].to(torch.int64)
            g.nodes_read[node[walking]] = True
        off = meta[1, node]
        ptr = torch.where(walking, torch.where(voted, ptr + 1, meta[0, node]), ptr)
        sweep = torch.nonzero(voted & (off >= 0))[:, 0]
        if not sweep.numel():
            continue
        slots = off[sweep, None] + lanes  # (n, SWEEP); slots past the table never hit
        w = torch.where((slots < n_slots)[..., None],
                        woop_rows[torch.clamp(slots, max=n_slots - 1)], 0.0)
        n_valid = torch.clamp(n_slots - off[sweep], max=SWEEP)[:, None]  # slots tested
        if any_hit:
            testing = ~(occluded[sweep] | empty[sweep])
            hit = (woop._chunk_t(o[sweep], d[sweep], w, lo[sweep], hi[sweep]) < _BIG
                   ) & testing[..., None]
            if count:
                first = torch.where(hit.any(2), hit.to(torch.int32).argmax(2) + 1, n_valid)
                woops[sweep] += torch.where(testing, first, 0)
                _gated_any(g, sweep, off[sweep], n_valid, hit, testing, o[sweep], inv[sweep],
                           lo[sweep], hi[sweep])
            occ = occluded[sweep] | hit.any(2)
            occluded[sweep] = occ
            horizon[sweep] = torch.where(occ, -_BIG, horizon[sweep])
            # a block whose rays are all occluded or empty ends, as K7g
            done = (occ | empty[sweep]).all(1)
            ptr[sweep] = torch.where(done, n_nodes, ptr[sweep])
            continue
        t = woop._chunk_t(o[sweep], d[sweep], w, torch.zeros_like(lo[sweep]), horizon[sweep])
        if count:  # rays with a segment test every slot
            woops[sweep] += torch.where(hi[sweep] > 0, n_valid, 0)
            _gated_closest(g, sweep, off[sweep], n_valid, t, hi[sweep] > 0, o[sweep],
                           inv[sweep])
        arg = torch.argmin(t, dim=2, keepdim=True)
        t_new = torch.gather(t, 2, arg)[..., 0]
        closer = t_new < horizon[sweep]
        prim[sweep] = torch.where(closer, slots.gather(1, arg[..., 0]), prim[sweep])
        horizon[sweep] = torch.where(closer, t_new, horizon[sweep])
    flat = lambda x: x.reshape(-1)[:r]  # noqa: E731
    if any_hit:
        out = flat(occluded)
    else:
        found = prim >= 0
        out = flat(torch.where(found, horizon, _BIG)), flat(prim)
    if not count:
        return out
    g.clusters, g.woops, g.occluded, g.prim, g.best = (
        flat(x) for x in (g.clusters, g.woops, g.occluded, g.prim, g.best))
    return out, flat(boxes), flat(woops), g


def _gated_closest(g: _Gated, sweep, off, n_valid, t, act, o, inv):
    """K7f's two-gate leaf sweep for the blocks `sweep` at leaves `off`: in
    cluster order, each lane with a segment (act) slab-tests each non-empty
    cluster on (0, best) and Woop-tests the slots of those it enters; best
    falls to the closest t of the entered clusters so far.  `t`: the
    leaf's t (n, block, SWEEP) on the segment at the leaf's start."""
    c, n_in, full = g.leaf_clusters(off, n_valid)
    tc = t.reshape(t.shape[0], t.shape[1], g.k, g.leaf)
    b = g.best[sweep]
    p = g.prim[sweep]
    cin = torch.zeros(tc.shape[:3], dtype=torch.bool, device=t.device)
    zero = torch.zeros_like(b)
    for j in range(g.k):
        tests = act & full[:, j, None]
        cin[..., j] = tests & g.entered(c[:, j], o, inv, zero, b)
        g.clusters[sweep] += tests.to(torch.int64)
        # the cluster's first closest slot, taken where it beats best
        tj = torch.where(cin[..., j, None], tc[..., j, :], _BIG)
        arg = torch.argmin(tj, dim=2)
        t_new = torch.gather(tj, 2, arg[..., None])[..., 0]
        closer = t_new < b
        p = torch.where(closer, c[:, j, None] * g.leaf + arg, p)
        b = torch.where(closer, t_new, b)
    g.woops[sweep] += (cin * n_in[:, None, :]).sum(2)
    g.best[sweep], g.prim[sweep] = b, p
    g.read(c, n_in, cin.any(1)[..., None].expand(-1, -1, g.leaf))


def _gated_any(g: _Gated, sweep, off, n_valid, hit, testing, o, inv, lo, hi):
    """K7g's two-gate leaf sweep for the blocks `sweep` at leaves `off`:
    each lane still searching (testing) slab-tests each non-empty cluster
    on (t_min, t_max) up to and including the cluster of its first
    occluder, and Woop-tests the slots of those it enters up to that
    occluder.  `hit`: the leaf's hits (n, block, SWEEP) of the searching
    lanes."""
    c, n_in, full = g.leaf_clusters(off, n_valid)
    n, lanes = hit.shape[:2]
    ks = torch.arange(g.k, device=hit.device)
    cin = testing[..., None] & full[:, None, :] & torch.stack(
        [g.entered(c[:, j], o, inv, lo, hi) for j in range(g.k)], 2)
    flat = (hit.reshape(n, lanes, g.k, g.leaf) & cin[..., None]).reshape(n, lanes, -1)
    found = flat.any(2)
    first = torch.where(found, flat.to(torch.int32).argmax(2), g.k * g.leaf - 1)
    fc = first // g.leaf  # the cluster of the first occluder (or the last)
    g.clusters[sweep] += (testing[..., None] & full[:, None, :]
                          & (ks <= fc[..., None])).sum(2)
    before = ((cin & (ks < fc[..., None])) * n_in[:, None, :]).sum(2)
    last = torch.gather(cin, 2, fc[..., None])[..., 0] * torch.gather(
        n_in[:, None, :].expand(-1, lanes, -1), 2, fc[..., None])[..., 0]
    g.woops[sweep] += before + torch.where(found, first % g.leaf + 1, last)
    pos = torch.arange(g.k * g.leaf, device=hit.device)
    tested = cin.repeat_interleave(g.leaf, 2) & (pos <= first[..., None])
    g.read(c, n_in, tested.any(1).reshape(n, g.k, g.leaf))
    g.occluded[sweep] |= found


def _closest_out(scene, origin, direction, t, prim, attr):
    """(t, prim int32, u, v, attrs) from the walk's (t, prim), u and v
    recovered as woop.closest_scan does (the kernel's arithmetic)."""
    prim = prim.to(torch.int32)
    u, v = woop._recover_uv(origin, direction, scene.tri_woop, prim,
                            torch.where(prim >= 0, t, 0.0))
    u = torch.where(prim >= 0, u, 0.0)
    v = torch.where(prim >= 0, v, 0.0)
    attr = ftb.attr_table(scene) if attr is None else attr
    return t, prim, u, v, ftb._gather_attrs(attr, prim)


def dfs_closest_ref(scene, origin, direction, active=None, t_max=None, attr=None,
                    block: int = BLOCK):
    """Plain torch version of dfs_closest with blocks of `block` rays."""
    t_max = ftb._tmax(origin, t_max, active)
    t, prim = _walk(scene, origin, direction, torch.zeros_like(t_max), t_max, False, block)
    return _closest_out(scene, origin, direction, t, prim, attr)


def dfs_any_ref(scene, origin, direction, t_min, t_max, active=None, block: int = BLOCK):
    """Plain torch version of dfs_any with blocks of `block` rays."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    return _walk(scene, origin, direction, t_min, t_max, True, block)


def _check(scene, origin, direction, *scalars):
    ftb._check_rays(origin, direction, *scalars)
    ftb._check_scene(scene, origin.device)
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dfs_sweep: unsupported device {origin.device}")


def leaf_clusters(scene):
    """The tables of the kernels' cluster gate: the leaf clusters' (C, 3)
    lo and hi corners (cluster_sweep.cluster_boxes) and the (T, 12) Woop
    rows.  Raises ValueError unless the Woop rows are contiguous float32 on
    a 16-byte boundary (_build.check_aligned), a leaf's SWEEP slots are a
    whole number of clusters, and the node tables hold a row for each of
    the scene's clusters.  That a leaf starts on a cluster and that every
    slot the gate skips, of an empty cluster or past the last one, is a
    zero row, scene_from_arrays checks once when the scene is made
    (bvh/tables.py:check_leaf_clusters)."""
    from .. import _build

    rows = scene.tri_woop
    _build.check_aligned("dfs_sweep", **{"scene.tri_woop": rows})
    leaf = scene.bvh_leaf_size
    if SWEEP % leaf:
        raise ValueError(f"dfs_sweep: a leaf of {SWEEP} slots is no whole number of "
                         f"{leaf}-slot clusters")
    lo, hi, _ = cluster_sweep.cluster_boxes(scene)
    if lo.shape[0] != scene.bvh_clusters or hi.shape != lo.shape:
        raise ValueError(f"dfs_sweep: want {scene.bvh_clusters} leaf clusters' boxes, got "
                         f"{tuple(lo.shape)} / {tuple(hi.shape)}")
    return lo.contiguous(), hi.contiguous(), rows


def _launch_args(scene):
    """(the tensors the kernels read, held until the launch returns; their
    arguments: the preorder tables, the leaf clusters' boxes, the Woop
    rows)."""
    bounds, meta = scene.bvh_dfs_bounds.contiguous(), scene.bvh_dfs_meta.contiguous()
    cmin, cmax, rows = leaf_clusters(scene)
    keep = (bounds, meta, cmin, cmax, rows)
    return keep, (bounds.data_ptr(), meta.data_ptr(), meta.shape[1], cmin.data_ptr(),
                  cmax.data_ptr(), cmin.shape[0], scene.bvh_leaf_size, rows.data_ptr(),
                  rows.shape[0])


def dfs_closest(scene, origin, direction, active=None, t_max=None, attr=None):
    """K7f: closest hit with t in (0, t_max) by the block-gated walk.
    Returns (t (R,) float32, 1e30 on a miss; prim (R,) int32, -1 on a miss;
    u, v (R,) float32, 0 on a miss; attrs (R, A), the rows of `attr`
    (default ftb.attr_table(scene)), 0 on a miss)."""
    t_max = ftb._tmax(origin, t_max, active)
    _check(scene, origin, direction, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return dfs_closest_ref(scene, origin, direction, t_max=t_max, attr=attr)
    attr = ftb.attr_table(scene) if attr is None else attr
    a = attr.shape[1]
    if attr.device != dev or attr.dtype != torch.float32 or attr.shape[0] != scene.padded_tris:
        raise ValueError(f"attr: want float32 ({scene.padded_tris}, A) on {dev}")
    from .. import _build

    lib = _build.load()
    attr = attr.contiguous()
    _keep, args = _launch_args(scene)
    r = origin.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    attrs = torch.empty((r, a), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_dfs_closest(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), r,
                                 *args, attr.data_ptr(), a, t.data_ptr(), prim.data_ptr(),
                                 u.data_ptr(), v.data_ptr(), attrs.data_ptr(), stream)
    _build.check(rc, "dfs_closest")
    profiling.count("dfs_closest.launch")
    return t, prim, u, v, attrs


def dfs_any(scene, origin, direction, t_min, t_max, active=None):
    """K7g: True where a triangle lies strictly inside (t_min, t_max), by
    the block-gated walk; t_min / t_max are scalars or (R,) tensors."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    _check(scene, origin, direction, t_min, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return dfs_any_ref(scene, origin, direction, t_min, t_max)
    from .. import _build

    lib = _build.load()
    _keep, args = _launch_args(scene)
    r = origin.shape[0]
    occ = torch.empty((r,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_dfs_any(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                             t_max.data_ptr(), r, *args, occ.data_ptr(), stream)
    _build.check(rc, "dfs_any")
    profiling.count("dfs_any.launch")
    return occ


def dfs_closest_diff(scene, origin, direction, active=None, attr=None):
    """dfs_closest with exact (t, u, v) gradients w.r.t. (origin,
    direction); attrs carry none (the scene's tables are detached)."""
    t_max = ftb._tmax(origin, None, active)
    attr = (ftb.attr_table(scene) if attr is None else attr).detach()
    return ftb.ClosestDiff.apply(dfs_closest, origin, direction, t_max, scene, attr)


def dfs_tests(scene, origin, direction, t_min, t_max, any_hit: bool):
    """((R,) int64 box tests, (R,) int64 Woop tests, the walk's result):
    the tests of the block sweep of K7f (any_hit False, on (0, t_max)) or
    K7g (on (t_min, t_max)) at BLOCK, the kernels' earlier design and one
    of the bound's two counts.  A ray slab-tests every node its block
    visits; at an entered leaf K7f tests all SWEEP slots for each ray with
    t_max > 0, K7g each ray not yet occluded and with t_max > t_min up to
    its first occluder; K7g's block ends once its rays are all occluded or
    empty.  The result is the walk's (t, prim) or occlusion, for holding the
    count to the kernel.  It measures work; nothing renders with it."""
    if not any_hit:
        t_min = torch.zeros_like(t_max)
    out, boxes, woops, _ = _walk(scene, origin, direction, t_min, t_max, any_hit, BLOCK, True)
    return boxes, woops, out


class GatedTests(NamedTuple):
    """gated_tests' counts: per ray, node slab tests, cluster slab tests,
    Woop tests and the walk's own result ((t, prim) or occlusion); per node
    and per slot, whether some warp reads its row."""
    nodes: torch.Tensor
    clusters: torch.Tensor
    woop: torch.Tensor
    result: object
    node_rows: torch.Tensor
    slots: torch.Tensor


def gated_tests(scene, origin, direction, t_min, t_max, any_hit: bool) -> GatedTests:
    """GatedTests ((R,) int64 node tests, (R,) int64 cluster tests, (R,)
    int64 Woop tests, the result, (N,) bool node rows read, (T,) bool slots
    some ray Woop-tests): the tests the two-gate walk of K7f (any_hit False,
    on (0, t_max)) or K7g (on (t_min, t_max)) makes for each ray at BLOCK,
    the bound's other count.  A ray slab-tests every node its warp visits
    (the block-gated walk's nodes).  At an entered leaf, in cluster order,
    a K7f ray with t_max > 0 slab-tests each non-empty cluster of the leaf
    on (0, best), best its closest t so far, and a K7g ray not yet occluded
    and with t_max > t_min each one on (t_min, t_max) up to the cluster of
    its first occluder; it Woop-tests the slots of the clusters its own
    widened test (cluster_sweep.slab_entered) enters, K7g up to that
    occluder.  The result is computed over those slots only, for holding it
    to the kernel's.  It measures the kernels' work; nothing renders with
    it."""
    if not any_hit:
        t_min = torch.zeros_like(t_max)
    _, nodes, _, g = _walk(scene, origin, direction, t_min, t_max, any_hit, BLOCK, True)
    result = g.occluded if any_hit else (torch.where(g.prim >= 0, g.best, _BIG), g.prim)
    return GatedTests(nodes, g.clusters, g.woops, result, g.nodes_read, g.slots_read)
