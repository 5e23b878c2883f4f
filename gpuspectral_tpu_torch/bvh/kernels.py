"""K7h: the packet traversal of the implicit cluster tree (csrc/traverse.cu),
the BVH intersector of the wavefront with intersector "woop" or "mt".

The counterpart of gpuspectral_tpu/bvh/kernels.py (traverse_pallas): packets
of `packet_size` rays walk the tree of bvh/build.py together, one stack per
packet, the packet entering a node when any of its rays passes the slab
test, every ray of the packet Moller-Trumbore testing the leaves the packet
enters, and an any-hit packet stopping once all its rays are occluded.  The
semantics are bvh/traverse.py's, which is the plain version: the left
subtree first, so exact-t ties go to the lowest prim (JAX's Pallas kernel
visits the right subtree first, so of a tie across leaves it reports the
higher prim), and the arithmetic of ops/intersect.py:_mt_edges, whose
multiply-adds are fused where XLA-CPU fuses them.  K7h equals the plain
version bit for bit.

  * `pack_tris`: the (C, leaf, 12) table [v0, e1, e2, 0, 0, 0] of the
    sorted triangles (bvh/kernels.py:_pack_tris), zero rows past the scene
    (they never hit) and the table cut at C * leaf rows.  The wavefront
    builds it once per render (integrator/path_tracer.py:_tables).
  * `pack_nodes`: K7h's (2C - 1, 8) node rows [min.xyz, empty, max.xyz, 0],
    `empty` marking each subtree whose box is inverted (an empty padding
    cluster, or a node over such clusters only), after checking that every
    cluster under a marked node has all-zero rows, which never hit: K7h
    enters no marked subtree, and no result changes.  Built once per render
    beside pack_tris.
  * `traverse_closest` -> (t, prim, u, v) and `traverse_any` -> occluded:
    for CUDA tensors they launch the kernel or raise, and count their
    launches in utils.profiling; for CPU tensors they run the plain versions
    (traverse.intersect_closest_bvh_ref / intersect_any_bvh_ref), which
    walk the boxes as built.
  * `TraverseClosestDiff` / `traverse_closest_diff`: the closest hit with
    (t, u, v) gradients w.r.t. (origin, direction); the backward re-runs the
    winning triangle's Moller-Trumbore test in plain torch.  The tables are
    detached, as for every intersector of the wavefront.
  * `traverse_tests`: the slab and Moller-Trumbore tests of PR 8's walk
    (a vote per node popped, csrc/traverse.cu:gst_traverse_count) for each
    ray, or with `skip_empty` those the function needs (the same walk
    entering no empty cluster), for K7h's bound.

Rays are (R, 3) origins and directions with (R,) t_min / t_max (inactive
rays at t_max = -1e30); hits take t in (t_min, t_max).  Not carried over
from the TPU: the (P, B) ray planes (the kernel reads the (R, 3) arrays and
pads the ragged last packet itself) and the SMEM stack's size from n_levels
(the kernel's stack holds the pending right children, log2(C) at most).
"""

from __future__ import annotations

import torch

from . import traverse
from ..ops.intersect import _mt_edges
from ..utils import profiling

_BIG = 1e30
MAX_PACKET = 2048  # 1024 threads a CTA of up to 2 rays each (csrc/traverse.cu:kMaxPacket)
MAX_LEAF = 1024  # 48 KB of staged rows a leaf in the counting walk
MAX_CLUSTERS = 1 << 30  # csrc/traverse.cu: a bit of `pending` per level of the tree


def pack_tris(tri_pos, n_clusters: int, leaf_size: int) -> torch.Tensor:
    """(T, 3, 3) sorted triangles -> (C, leaf, 12) float32 rows [v0.xyz,
    e1.xyz, e2.xyz, 0, 0, 0], e1 = p1 - v0 and e2 = p2 - v0, the table
    zero-padded or cut to C * leaf triangles."""
    need = n_clusters * leaf_size
    t = tri_pos.shape[0]
    if t < need:
        tri_pos = torch.cat([tri_pos, tri_pos.new_zeros((need - t, 3, 3))])
    else:
        tri_pos = tri_pos[:need]
    v0 = tri_pos[:, 0]
    rows = torch.cat([v0, tri_pos[:, 1] - v0, tri_pos[:, 2] - v0, v0.new_zeros((need, 3))], 1)
    return rows.reshape(n_clusters, leaf_size, 12)


def pack_nodes(node_min, node_max, packed) -> torch.Tensor:
    """(2C - 1, 3) node boxes and the (C, leaf, 12) rows of pack_tris ->
    K7h's (2C - 1, 8) float32 node rows [min.xyz, empty, max.xyz, 0], empty
    1.0 where the box is inverted (lo > hi on an axis).  Raises ValueError
    if a cluster under a marked node has a non-zero row: K7h skips marked
    subtrees, which is exact only because their rows never hit."""
    n_clusters = packed.shape[0]
    n_nodes = node_min.shape[0]
    if n_nodes != 2 * n_clusters - 1 or tuple(node_max.shape) != (n_nodes, 3):
        raise ValueError(f"pack_nodes: want (2C - 1, 3) boxes for C = {n_clusters}, got "
                         f"{tuple(node_min.shape)} and {tuple(node_max.shape)}")
    empty = (node_min > node_max).any(1)
    # rows[n]: some cluster under node n has a non-zero row (children 2n + 1, 2n + 2)
    rows = torch.zeros((n_nodes,), dtype=torch.bool, device=packed.device)
    rows[n_clusters - 1:] = (packed != 0).reshape(n_clusters, -1).any(1)
    first = n_clusters - 1
    while first:
        first //= 2  # the level above: nodes [first, 2 * first + 1)
        idx = torch.arange(first, 2 * first + 1, device=packed.device)
        rows[idx] = rows[2 * idx + 1] | rows[2 * idx + 2]
    bad = empty & rows
    if bool(bad.any()):
        node = int(torch.nonzero(bad)[0, 0])
        raise ValueError(f"pack_nodes: node {node} has an inverted box but a cluster under it "
                         "has non-zero rows (an empty cluster's rows must be zero)")
    flag = empty.to(torch.float32)[:, None]
    return torch.cat([node_min, flag, node_max, torch.zeros_like(flag)], 1).contiguous()


def _check(origin, direction, packed, node_min, node_max, t_min, t_max, packet_size):
    r = origin.shape[0]
    dev = origin.device
    n_clusters, leaf_size = packed.shape[:2]
    want = (("origin", origin, (r, 3)), ("direction", direction, (r, 3)), ("t_min", t_min, (r,)),
            ("t_max", t_max, (r,)), ("packed", packed, (n_clusters, leaf_size, 12)),
            ("node_min", node_min, (2 * n_clusters - 1, 3)),
            ("node_max", node_max, (2 * n_clusters - 1, 3)))
    for name, x, shape in want:
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"traverse: {name} wants float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"traverse: {name} must be contiguous")
    if n_clusters & (n_clusters - 1) or n_clusters > MAX_CLUSTERS or not 1 <= leaf_size <= MAX_LEAF:
        raise ValueError(f"traverse: want a power-of-two cluster count up to {MAX_CLUSTERS} and "
                         f"1-{MAX_LEAF} slots a leaf, got {n_clusters} x {leaf_size}")
    if packet_size < 1:
        raise ValueError(f"traverse: packet_size {packet_size}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"traverse: unsupported device {dev}")
    if dev.type == "cuda" and min(packet_size, r) > MAX_PACKET:
        raise ValueError(f"traverse: K7h takes packets of up to {MAX_PACKET} rays, got "
                         f"{packet_size}")
    return max(1, min(packet_size, r))


def _node_rows(nodes, node_min, node_max, packed):
    """K7h's node rows: `nodes` (pack_nodes of the same tree, built once per
    render) checked, or pack_nodes now."""
    if nodes is None:
        return pack_nodes(node_min, node_max, packed)
    shape = (node_min.shape[0], 8)
    if nodes.device != packed.device or nodes.dtype != torch.float32 or \
            tuple(nodes.shape) != shape or not nodes.is_contiguous():
        raise ValueError(f"traverse: nodes wants contiguous float32 {shape} on {packed.device} "
                         f"(pack_nodes), got {nodes.dtype} {tuple(nodes.shape)} on {nodes.device}")
    return nodes


def _launch(fn, origin, direction, packed, boxes, t_min, t_max, packet, outs, *flags):
    """Launch `fn` of csrc/traverse.cu on the current stream: the rays, the
    node tables `boxes` (K7h's node rows, or the counting walk's min and max
    boxes), the leaf rows, the int `flags`, then the output pointers."""
    from .. import _build

    _build.check_aligned("traverse", leaves=packed,
                         **{f"nodes{i}": x for i, x in enumerate(boxes)})
    lib = _build.load()
    n_clusters, leaf_size = packed.shape[:2]
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                              t_max.data_ptr(), origin.shape[0], packet,
                              *[x.data_ptr() for x in boxes], packed.data_ptr(), n_clusters,
                              leaf_size, *flags, *[x.data_ptr() for x in outs], stream)
    _build.check(rc, fn)


def traverse_closest(origin, direction, packed, node_min, node_max, n_levels: int, t_min, t_max,
                     packet_size: int = 1024, nodes=None):
    """K7h closest hit with t in (t_min, t_max).  Returns (t (R,) float32,
    1e30 on a miss; prim (R,) int32, -1 on a miss; u, v (R,) float32, the
    barycentric weights of corners 1 and 2, 0 on a miss).  `nodes`:
    pack_nodes of the tree (built here if None; the plain version needs
    none)."""
    packet = _check(origin, direction, packed, node_min, node_max, t_min, t_max, packet_size)
    if origin.device.type == "cpu":
        return traverse.intersect_closest_bvh_ref(origin, direction, packed, node_min, node_max,
                                                  n_levels, t_min, t_max, packet_size)
    r = origin.shape[0]
    outs = [torch.empty((r,), dtype=dt, device=origin.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    if r:
        rows = _node_rows(nodes, node_min, node_max, packed)
        _launch("gst_traverse_closest", origin, direction, packed, [rows], t_min, t_max, packet,
                outs)
        profiling.count("traverse_closest.launch")
    return tuple(outs)


def traverse_any(origin, direction, packed, node_min, node_max, n_levels: int, t_min, t_max,
                 packet_size: int = 1024, nodes=None):
    """K7h any hit: (R,) bool, True where a triangle lies strictly inside
    (t_min, t_max).  `nodes` as for traverse_closest."""
    packet = _check(origin, direction, packed, node_min, node_max, t_min, t_max, packet_size)
    if origin.device.type == "cpu":
        return traverse.intersect_any_bvh_ref(origin, direction, packed, node_min, node_max,
                                              n_levels, t_min, t_max, packet_size)
    occ = torch.empty((origin.shape[0],), dtype=torch.bool, device=origin.device)
    if origin.shape[0]:
        rows = _node_rows(nodes, node_min, node_max, packed)
        _launch("gst_traverse_any", origin, direction, packed, [rows], t_min, t_max, packet,
                [occ])
        profiling.count("traverse_any.launch")
    return occ


def launch_shape(packet_size: int = 1024) -> dict:
    """K7h's launch at packets of `packet_size` rays, as csrc/traverse.cu
    chooses it: CTAs a packet (a thread block cluster if more than one),
    threads a CTA and rays a thread.  Needs the built kernels (a card)."""
    import ctypes

    from .. import _build

    shape = (ctypes.c_int * 3)()
    _build.check(_build.load().gst_traverse_shape(packet_size, ctypes.addressof(shape)),
                 "gst_traverse_shape")
    return dict(ctas_per_packet=shape[0], threads_per_cta=shape[1], rays_per_thread=shape[2])


def _winner_tuv(origin, direction, packed, prim):
    """(t, u, v) of each ray's Moller-Trumbore test against its hit triangle
    `prim` (0 where prim is -1), differentiable w.r.t. origin and direction:
    the winning test of the traversal, evaluated again."""
    rows = packed.reshape(-1, 12)[torch.clamp(prim, min=0).long()][:, None]  # (R, 1, 12)
    zero = torch.zeros((origin.shape[0], 1), dtype=origin.dtype, device=origin.device)
    _, t, u, v = _mt_edges(origin[:, None], direction[:, None], rows[..., 0:3], rows[..., 3:6],
                           rows[..., 6:9], zero, zero)
    hit = prim >= 0
    return tuple(torch.where(hit, x[:, 0, 0], 0.0) for x in (t, u, v))


class TraverseClosestDiff(torch.autograd.Function):
    """A packet-traversal closest hit `closest(o, d, packed, node_min,
    node_max, n_levels, t_min, t_max, packet_size)` (K7h's traverse_closest,
    or the plain version) forward; the backward re-evaluates each hit ray's
    winning Moller-Trumbore test (`_winner_tuv`) and returns (t, u, v)
    gradients w.r.t. (origin, direction)."""

    @staticmethod
    def forward(ctx, closest, origin, direction, packed, node_min, node_max, n_levels, t_min,
                t_max, packet_size, nodes=None):
        t, prim, u, v = closest(origin, direction, packed, node_min, node_max, n_levels, t_min,
                                t_max, packet_size, nodes=nodes)
        ctx.save_for_backward(origin, direction, packed, prim)
        ctx.mark_non_differentiable(prim)
        return t, prim, u, v

    @staticmethod
    def backward(ctx, ct_t, _ct_prim, ct_u, ct_v):
        o, d, packed, prim = ctx.saved_tensors
        with torch.enable_grad():
            o = o.detach().requires_grad_(True)
            d = d.detach().requires_grad_(True)
            t, u, v = _winner_tuv(o, d, packed, prim)
            do, dd = torch.autograd.grad((t, u, v), (o, d), (ct_t, ct_u, ct_v),
                                         allow_unused=True)
        return None, do, dd, None, None, None, None, None, None, None, None


def traverse_closest_diff(origin, direction, packed, node_min, node_max, n_levels: int, t_min,
                          t_max, packet_size: int = 1024, nodes=None):
    """traverse_closest with exact (t, u, v) gradients w.r.t. (origin,
    direction); the tables carry none."""
    return TraverseClosestDiff.apply(traverse_closest, origin, direction, packed.detach(),
                                     node_min.detach(), node_max.detach(), n_levels,
                                     t_min.detach(), t_max.detach(), packet_size,
                                     None if nodes is None else nodes.detach())


def nan_empty(node_min, node_max):
    """The node boxes with every inverted box (lo > hi on an axis: an empty
    cluster of bvh/build.py, or a node over empty clusters only) made NaN.
    A NaN box fails every slab test, so no packet enters an empty subtree;
    an inverted one passes every slab test (t_enter = -inf, t_exit = +inf),
    and the zero rows of its leaves never hit."""
    empty = (node_min > node_max).any(1, keepdim=True)
    return (torch.where(empty, float("nan"), node_min).contiguous(),
            torch.where(empty, float("nan"), node_max).contiguous())


def traverse_tests(origin, direction, packed, node_min, node_max, n_levels: int, t_min, t_max,
                   any_hit: bool, packet_size: int = 1024, skip_empty: bool = False):
    """((R,) int64 slab tests, (R,) int64 Moller-Trumbore tests, the
    result): what PR 8's walk (the plain version's: a vote per node popped)
    does for each ray.  Closest hit: a slab test for every node its packet
    pops, and at every leaf the packet enters the leaf's leaf_size tests if
    the ray's window (t_min, best) is not empty.  Any hit: the same while
    the ray is not occluded, and in a leaf the tests up to its first hit.
    The result is (t, prim, u, v) or the occlusion flags, for holding the
    count to the kernel.  With `skip_empty`, the same walk of the tree with
    nan_empty's boxes: the tests the function needs, with the same result,
    since an empty cluster's rows never hit (K7h's bound counts these; K7h
    enters the same leaves, so its Moller-Trumbore tests are these).  For
    CUDA tensors the walk runs on the card with counters
    (csrc/traverse.cu:gst_traverse_count, as ftb.ftb_walk_tests counts
    K3's); for CPU tensors the plain walk counts them.  It measures work;
    nothing renders with it, and it adds no launch to the wrappers'
    counts."""
    packet = _check(origin, direction, packed, node_min, node_max, t_min, t_max, packet_size)
    if skip_empty:
        node_min, node_max = nan_empty(node_min, node_max)
    if origin.device.type == "cpu":
        out, boxes, tests = traverse.traverse_ref(origin, direction, packed, node_min, node_max,
                                                  n_levels, t_min, t_max, any_hit, packet_size,
                                                  count=True)
        return boxes, tests, out
    r = origin.shape[0]
    outs = [torch.empty((r,), dtype=dt, device=origin.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32, torch.bool,
                       torch.int32, torch.int32)]
    if r:
        _launch("gst_traverse_count", origin, direction, packed, [node_min, node_max], t_min,
                t_max, packet, outs, int(any_hit))
    out = outs[4] if any_hit else tuple(outs[:4])
    return outs[5].long(), outs[6].long(), out
