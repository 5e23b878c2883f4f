"""Brute-force ray-triangle intersection (port of
gpuspectral_tpu/ops/intersect.py): the Moller-Trumbore scans of the
wavefront's intersector "mt", and the leaf test of the BVH packet
traversal (bvh/traverse.py).

Rays are (R,3) origins and directions, triangles (T,3,3).  The triangle
loop runs `tri_chunk` triangles at a time, so peak memory is R * tri_chunk
whatever the scene size.  The JAX functions' `woop=` branch is not carried
over: it calls the Woop scans, which the port has as ops/woop.py's
closest_scan / any_scan.

The arithmetic is XLA-CPU's for the JAX package's jitted `_mt_chunk`: it
fuses each cross product's component a1*b2 - a2*b1 into fma(a1, b2,
-(a2*b1)) and each 3-term dot product into fma(x2, y2, fma(x1, y1, x0*y0))
(m3.cross_fma, m3.dot_fma), so t, u and v agree bit for bit.  Ties: among
exactly equal t the lowest prim id wins.
"""

from __future__ import annotations

import torch

from . import math3d as m3

TRI_CHUNK = 512
_EPS_PARALLEL = 1e-12
_BIG = 1e30


def _mt_chunk(origin, direction, tri_chunk, t_min, t_max):
    """Moller-Trumbore: (..., R,3) rays x (..., C,3,3) triangles -> (hit, t,
    u, v), each (..., R,C); t_min / t_max are (..., R).  Leading axes
    broadcast."""
    v0 = tri_chunk[..., 0, :]
    return _mt_edges(origin, direction, v0, tri_chunk[..., 1, :] - v0,
                     tri_chunk[..., 2, :] - v0, t_min, t_max)


def _mt_edges(origin, direction, v0, e1, e2, t_min, t_max):
    """_mt_chunk on triangles given as corner v0 and edges e1 = p1 - v0, e2 =
    p2 - v0, each (..., C,3): the rows of bvh/kernels.pack_tris, which the
    packet traversal (bvh/traverse.py, the packet axis leading) tests."""
    e1 = e1.unsqueeze(-3)  # (..., 1,C,3)
    e2 = e2.unsqueeze(-3)
    d = direction.unsqueeze(-2)  # (..., R,1,3)
    h = m3.cross_fma(d, e2)  # (..., R,C,3)
    a = m3.dot_fma(e1, h)
    parallel = torch.abs(a) < _EPS_PARALLEL
    # a tensor numerator: `1.0 / t` is a reciprocal then a multiply in torch
    f = torch.ones_like(a) / torch.where(parallel, 1.0, a)
    s = origin.unsqueeze(-2) - v0.unsqueeze(-3)
    u = f * m3.dot_fma(s, h)
    q = m3.cross_fma(s, e1)
    v = f * m3.dot_fma(d, q)
    t = f * m3.dot_fma(e2, q)
    hit = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[..., None])
        & (t < t_max[..., None])
    )
    return hit, t, u, v


def _segment(origin, t_min, t_max, active, inactive_max):
    r = origin.shape[0]
    dev = origin.device

    def full(x, fill):
        if x is None:
            return torch.full((r,), fill, dtype=torch.float32, device=dev)
        return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32, device=dev), (r,))

    t_min, t_max = full(t_min, 0.0), full(t_max, _BIG)
    if active is not None:
        t_max = torch.where(active, t_max, inactive_max)
    return t_min, t_max


def _chunks(tri_pos, tri_chunk: int):
    """(base, (chunk,3,3)) over the table, the last chunk padded with
    zero-area triangles, which never hit."""
    tcount = tri_pos.shape[0]
    chunk = min(tri_chunk, tcount)
    n_chunks = -(-tcount // chunk)
    pad = n_chunks * chunk - tcount
    if pad:
        tri_pos = torch.cat([tri_pos, tri_pos.new_zeros((pad, 3, 3))])
    for base in range(0, n_chunks * chunk, chunk):
        yield base, tri_pos[base:base + chunk]


def intersect_closest(origin, direction, tri_pos, t_min=None, t_max=None, active=None,
                      tri_chunk: int = TRI_CHUNK):
    """Closest hit with t in (t_min, t_max) (default (0, 1e30)); inactive
    rays hit nothing.  Returns (t (R,), 1e30 on a miss; prim (R,) int32, -1
    on a miss; u, v (R,), the barycentric weights of corners 1 and 2)."""
    t_min, t_max = _segment(origin, t_min, t_max, active, -_BIG)
    r = origin.shape[0]
    dev = origin.device
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=dev)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    for base, tris in _chunks(tri_pos, tri_chunk):
        hit, t, u, v = _mt_chunk(origin, direction, tris, t_min, t_max)
        t = torch.where(hit, t, _BIG)
        arg = torch.argmin(t, dim=1)[:, None]
        t_new = torch.gather(t, 1, arg)[:, 0]
        closer = t_new < best_t
        best_prim = torch.where(closer, (base + arg[:, 0]).to(torch.int32), best_prim)
        best_u = torch.where(closer, torch.gather(u, 1, arg)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, arg)[:, 0], best_v)
        best_t = torch.where(closer, t_new, best_t)
    prim = torch.where(best_t < _BIG, best_prim, -1)
    return best_t, prim, best_u, best_v


def intersect_any(origin, direction, tri_pos, t_min, t_max, active=None,
                  tri_chunk: int = TRI_CHUNK):
    """Any hit: True where a triangle lies strictly inside (t_min, t_max);
    inactive rays are never occluded."""
    t_min, t_max = _segment(origin, t_min, t_max, active, -1.0)
    occ = torch.zeros((origin.shape[0],), dtype=torch.bool, device=origin.device)
    for _, tris in _chunks(tri_pos, tri_chunk):
        occ = occ | torch.any(_mt_chunk(origin, direction, tris, t_min, t_max)[0], dim=1)
    return occ
