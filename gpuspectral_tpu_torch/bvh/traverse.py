"""BVH packet traversal (port of gpuspectral_tpu/bvh/traverse.py).

The wavefront's BVH intersector for intersector "woop" or "mt" (and "auto"
for CPU tensors), as in the JAX package: packets of `packet_size` rays walk
the implicit cluster tree of bvh/build.py together, one stack per packet.

  * A packet enters a node if any of its live rays passes the slab test
    against the node's box on [t_min, best_t] (the packet-wide vote).
  * Internal nodes push the right child first, so the left subtree is
    visited first: leaves in ascending prim order, and exact-t ties go to
    the lowest prim, as in the brute-force scan and the JAX XLA traversal.
    (The JAX Pallas kernel, bvh/kernels.py, pops the right child first and
    so reports the higher prim of a tie across leaves.)
  * Every ray of a packet that enters a leaf Moller-Trumbore tests its
    leaf_size Morton-sorted triangles, the rows of kernels.pack_tris
    (ops/intersect.py:_mt_edges), against its current best_t, which culls
    the rest of its walk.
  * Any-hit packets stop once every ray is occluded.

`intersect_closest_bvh` / `intersect_any_bvh` call the wrappers of
bvh/kernels.py (the closest hit through kernels.TraverseClosestDiff),
which launch K7h (csrc/traverse.cu) for CUDA tensors, or raise, and run
the plain versions `intersect_closest_bvh_ref` / `intersect_any_bvh_ref`,
which K7h equals bit for bit, for CPU tensors.  The plain versions step
every packet at once: the stacks are one (packets, stack_cap) tensor, and
the loop runs as long as the longest packet's walk, each iteration popping
one node per live packet and testing the leaves that packets entered.
t, u and v carry autograd through the leaf tests (the slab tests are
comparisons and take none), as jax.grad flows through the XLA loop; the
wrapper's backward, which re-evaluates each ray's winning test, gives the
same (origin, direction) gradients.
"""

from __future__ import annotations

import torch

from ..ops import math3d as m3
from ..ops.intersect import _mt_edges, _segment

_BIG = 1e30


def _ray_aabb(origin, inv_dir, bb_min, bb_max):
    """Slab test of (..., B,3) rays against one box per packet, bb_min /
    bb_max (..., 3).  Returns (t_enter, t_exit), each (..., B)."""
    t0 = (bb_min.unsqueeze(-2) - origin) * inv_dir
    t1 = (bb_max.unsqueeze(-2) - origin) * inv_dir
    return torch.amax(torch.minimum(t0, t1), dim=-1), torch.amin(torch.maximum(t0, t1), dim=-1)


def _traverse_packet(origin, direction, t_min, t_max, packed, node_min, node_max,
                     n_levels: int, any_hit: bool, count: bool = False):
    """(P, B) rays of P packets against the tree, `packed` the (C, leaf, 12)
    rows of kernels.pack_tris.  Returns (t, prim, u, v), each (P, B), prim
    indexing the sorted triangle array, or with any_hit the (P, B) occluded
    mask.  With `count`, also ((P, B) box tests, (P, B) Moller-Trumbore
    tests): what K7h does for each ray (kernels.traverse_tests)."""
    p, b = t_min.shape
    n_clusters, leaf_size = packed.shape[:2]
    dev = origin.device
    o_box = origin.detach()
    d = direction.detach()
    # a tensor numerator: `1.0 / t` is a reciprocal then a multiply in torch
    inv_dir = m3.safe_div(torch.ones_like(d), d)
    first_leaf = n_clusters - 1
    stack = torch.zeros((p, 2 * n_levels + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((p,), dtype=torch.int64, device=dev)  # the root, index 0, pushed
    best_t = torch.where(t_max > t_min, t_max, -_BIG)  # per-ray search window
    prim = torch.full((p, b), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((p, b), dtype=torch.float32, device=dev)
    v = torch.zeros((p, b), dtype=torch.float32, device=dev)
    occluded = torch.zeros((p, b), dtype=torch.bool, device=dev)
    boxes = torch.zeros((p, b), dtype=torch.int64, device=dev)
    tests = torch.zeros((p, b), dtype=torch.int64, device=dev)
    while True:
        live = sp > 0
        if any_hit:
            live = live & ~occluded.all(1)
        if not bool(live.any()):
            break
        sp = sp - live.to(torch.int64)
        node = stack.gather(1, torch.clamp(sp, min=0)[:, None])[:, 0]
        t_enter, t_exit = _ray_aabb(o_box, inv_dir, node_min[node], node_max[node])
        node_hit = (t_exit >= t_enter) & (t_exit >= t_min) & (t_enter <= best_t.detach())
        if any_hit:
            node_hit = node_hit & ~occluded
        if count:  # every ray of a live packet slab-tests (any hit: while not occluded)
            boxes += (live[:, None] & ~occluded) if any_hit else live[:, None]
        go = live & node_hit.any(1)
        is_leaf = node >= first_leaf
        inner = torch.nonzero(go & ~is_leaf)[:, 0]
        if inner.numel():
            top = sp[inner]
            stack[inner, top] = 2 * node[inner] + 2
            stack[inner, top + 1] = 2 * node[inner] + 1
            sp = sp.index_add(0, inner, torch.full_like(top, 2))
        leaf = torch.nonzero(go & is_leaf)[:, 0]
        if not leaf.numel():
            continue
        cluster = node[leaf] - first_leaf
        off = cluster * leaf_size
        rows = packed[cluster]  # (n, leaf_size, 12)
        hit, t, tu, tv = _mt_edges(origin[leaf], direction[leaf], rows[..., 0:3], rows[..., 3:6],
                                   rows[..., 6:9], t_min[leaf], best_t[leaf])
        if count:  # a ray with an empty window tests nothing
            window = best_t[leaf].detach() > t_min[leaf]
            n = torch.full_like(window, leaf_size, dtype=torch.int64)
            if any_hit:  # up to its first hit, while not occluded
                first = torch.where(hit.any(2), hit.to(torch.int64).argmax(2) + 1, leaf_size)
                n = torch.where(occluded[leaf], 0, first)
            tests = tests.index_add(0, leaf, torch.where(window, n, 0))
        if any_hit:
            occluded = occluded.index_copy(0, leaf, occluded[leaf] | hit.any(2))
            continue
        t = torch.where(hit, t, _BIG)
        arg = torch.argmin(t, dim=2, keepdim=True)
        t_new = torch.gather(t, 2, arg)[..., 0]
        closer = t_new < best_t[leaf]

        def pick(new, old):
            return old.index_copy(0, leaf, torch.where(closer, new, old[leaf]))

        prim = pick((off[:, None] + arg[..., 0]).to(torch.int32), prim)
        u = pick(torch.gather(tu, 2, arg)[..., 0], u)
        v = pick(torch.gather(tv, 2, arg)[..., 0], v)
        best_t = pick(t_new, best_t)
    out = occluded if any_hit else (torch.where(prim >= 0, best_t, _BIG), prim, u, v)
    return (out, boxes, tests) if count else out


def _packets(origin, direction, t_min, t_max, packet_size: int):
    """The rays cut into packets of min(packet_size, R), the last padded
    with rays that hit nothing (t_max = -1e30)."""
    r = origin.shape[0]
    b = max(1, min(packet_size, r))
    n_packets = -(-r // b)
    pad = n_packets * b - r

    def padf(x, val):
        if not pad:
            return x
        return torch.cat([x, torch.full((pad,) + x.shape[1:], val, dtype=x.dtype,
                                        device=x.device)])

    return (padf(origin, 0.0).reshape(n_packets, b, 3),
            padf(direction, 1.0).reshape(n_packets, b, 3),
            padf(t_min, 0.0).reshape(n_packets, b), padf(t_max, -_BIG).reshape(n_packets, b))


def traverse_ref(origin, direction, packed, node_min, node_max, n_levels: int, t_min, t_max,
                 any_hit: bool, packet_size: int = 1024, count: bool = False):
    """The plain traversal of (R,) rays with (R,) t_min / t_max: (t, prim,
    u, v), or with any_hit the occlusion flags; with `count` also the (R,)
    box and Moller-Trumbore tests of each ray."""
    r = origin.shape[0]
    packs = _packets(origin, direction, t_min, t_max, packet_size)
    out = _traverse_packet(*packs, packed, node_min, node_max, n_levels, any_hit, count)
    res, boxes, tests = out if count else (out, None, None)
    if any_hit:
        res = res.reshape(-1)[:r]
    else:
        t, prim, u, v = (x.reshape(-1)[:r] for x in res)
        res = t, torch.where(t < _BIG, prim, -1), u, v
    return (res, boxes.reshape(-1)[:r], tests.reshape(-1)[:r]) if count else res


def intersect_closest_bvh_ref(origin, direction, packed, node_min, node_max, n_levels: int,
                              t_min, t_max, packet_size: int = 1024):
    """Plain torch version of kernels.traverse_closest (K7h)."""
    return traverse_ref(origin, direction, packed, node_min, node_max, n_levels, t_min, t_max,
                        False, packet_size)


def intersect_any_bvh_ref(origin, direction, packed, node_min, node_max, n_levels: int, t_min,
                          t_max, packet_size: int = 1024):
    """Plain torch version of kernels.traverse_any (K7h)."""
    return traverse_ref(origin, direction, packed, node_min, node_max, n_levels, t_min, t_max,
                        True, packet_size)


def intersect_closest_bvh(origin, direction, packed, node_min, node_max, n_levels: int,
                          t_min=None, t_max=None, active=None, packet_size: int = 1024,
                          nodes=None):
    """Closest hit via the BVH, the contract of ops.intersect.intersect_closest:
    (t, prim, u, v), t = 1e30 and prim = -1 on a miss; prim indexes the
    sorted triangle array.  `packed`: kernels.pack_tris of that array;
    `nodes`: kernels.pack_nodes of the tree, K7h's node rows (built per call
    if None).  Through kernels.traverse_closest_diff: K7h for CUDA tensors,
    the plain version for CPU tensors, with (t, u, v) gradients w.r.t.
    (origin, direction)."""
    from .kernels import traverse_closest_diff

    t_min, t_max = _segment(origin, t_min, t_max, active, -_BIG)
    if origin.shape[0] == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=origin.device)
        return z, z.to(torch.int32), z, z
    o, d, lo, hi = (x.contiguous() for x in (origin, direction, t_min, t_max))
    return traverse_closest_diff(o, d, packed, node_min, node_max, n_levels, lo, hi, packet_size,
                                 nodes)


def intersect_any_bvh(origin, direction, packed, node_min, node_max, n_levels: int, t_min, t_max,
                      active=None, packet_size: int = 1024, nodes=None):
    """Any hit via the BVH: True where a triangle lies strictly inside
    (t_min, t_max); packets stop once all their rays are occluded.  Through
    kernels.traverse_any (`nodes` as for intersect_closest_bvh): K7h for
    CUDA tensors, the plain version for CPU tensors."""
    from .kernels import traverse_any

    t_min, t_max = _segment(origin, t_min, t_max, active, -_BIG)
    if origin.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=origin.device)
    o, d, lo, hi = (x.contiguous() for x in (origin, direction, t_min, t_max))
    return traverse_any(o, d, packed, node_min, node_max, n_levels, lo, hi, packet_size, nodes)
