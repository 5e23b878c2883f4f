"""BVH packet traversal in plain torch (port of gpuspectral_tpu/bvh/traverse.py).

The wavefront's BVH intersector for intersector "woop" or "mt" (and "auto"
for CPU tensors), as in the JAX package: packets of `packet_size` rays walk
the implicit cluster tree of bvh/build.py together, one stack per packet.

  * A packet enters a node if any of its live rays passes the slab test
    against the node's box on [t_min, best_t] (the packet-wide vote).
  * Internal nodes push the right child first, so leaves are visited in
    ascending prim order and exact-t ties go to the lowest prim, as in the
    brute-force scan.
  * A leaf's leaf_size Morton-sorted triangles are Moller-Trumbore tested
    (ops/intersect.py:_mt_chunk) against each ray's current best_t, which
    culls the rest of the walk.
  * Any-hit packets stop once every ray is occluded.

Every packet steps at once: the stacks are one (packets, stack_cap) tensor,
and the loop runs as long as the longest packet's walk, each iteration
popping one node per live packet and testing the leaves that packets
entered.  t, u and v carry autograd through the leaf tests (the slab tests
are comparisons and take none), as jax.grad flows through the XLA loop.
"""

from __future__ import annotations

import torch

from ..ops import math3d as m3
from ..ops.intersect import _mt_chunk, _segment

_BIG = 1e30


def _ray_aabb(origin, inv_dir, bb_min, bb_max):
    """Slab test of (..., B,3) rays against one box per packet, bb_min /
    bb_max (..., 3).  Returns (t_enter, t_exit), each (..., B)."""
    t0 = (bb_min.unsqueeze(-2) - origin) * inv_dir
    t1 = (bb_max.unsqueeze(-2) - origin) * inv_dir
    return torch.amax(torch.minimum(t0, t1), dim=-1), torch.amin(torch.maximum(t0, t1), dim=-1)


def _traverse_packet(origin, direction, t_min, t_max, tri_pos, node_min, node_max,
                     n_clusters: int, leaf_size: int, n_levels: int, any_hit: bool):
    """(P, B) rays of P packets against the tree.  Returns (t, prim, u, v),
    each (P, B), prim indexing the sorted triangle array, or with any_hit
    the (P, B) occluded mask."""
    p, b = t_min.shape
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
    slots = torch.arange(leaf_size, device=dev)
    # leaves of padding clusters reach past the table: zero-area triangles,
    # which never hit, stand in for the slots there (the JAX package's
    # dynamic_slice clamps the start instead, onto the table's last slots)
    short = n_clusters * leaf_size - tri_pos.shape[0]
    if short > 0:
        tri_pos = torch.cat([tri_pos, tri_pos.new_zeros((short, 3, 3))])
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
        off = (node[leaf] - first_leaf) * leaf_size
        tris = tri_pos[off[:, None] + slots]  # (n, leaf_size, 3, 3)
        hit, t, tu, tv = _mt_chunk(origin[leaf], direction[leaf], tris, t_min[leaf],
                                   best_t[leaf])
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
    if any_hit:
        return occluded
    t = torch.where(prim >= 0, best_t, _BIG)
    return t, prim, u, v


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


def intersect_closest_bvh(origin, direction, tri_pos, node_min, node_max, n_clusters: int,
                          leaf_size: int, n_levels: int, t_min=None, t_max=None, active=None,
                          packet_size: int = 1024):
    """Closest hit via the BVH, the contract of ops.intersect.intersect_closest:
    (t, prim, u, v), t = 1e30 and prim = -1 on a miss; prim indexes the
    sorted triangle array (tri_pos)."""
    r = origin.shape[0]
    t_min, t_max = _segment(origin, t_min, t_max, active, -_BIG)
    if r == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=origin.device)
        return z, z.to(torch.int32), z, z
    packs = _packets(origin, direction, t_min, t_max, packet_size)
    t, prim, u, v = _traverse_packet(*packs, tri_pos, node_min, node_max, n_clusters,
                                     leaf_size, n_levels, any_hit=False)
    t, prim, u, v = (x.reshape(-1)[:r] for x in (t, prim, u, v))
    return t, torch.where(t < _BIG, prim, -1), u, v


def intersect_any_bvh(origin, direction, tri_pos, node_min, node_max, n_clusters: int,
                      leaf_size: int, n_levels: int, t_min, t_max, active=None,
                      packet_size: int = 1024):
    """Any hit via the BVH: True where a triangle lies strictly inside
    (t_min, t_max); packets stop once all their rays are occluded."""
    r = origin.shape[0]
    t_min, t_max = _segment(origin, t_min, t_max, active, -_BIG)
    if r == 0:
        return torch.zeros((0,), dtype=torch.bool, device=origin.device)
    packs = _packets(origin, direction, t_min, t_max, packet_size)
    occ = _traverse_packet(*packs, tri_pos, node_min, node_max, n_clusters, leaf_size,
                           n_levels, any_hit=True)
    return occ.reshape(-1)[:r]
