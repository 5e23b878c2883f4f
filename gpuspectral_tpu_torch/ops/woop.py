"""Woop-transform ray-triangle intersection (port of
gpuspectral_tpu/ops/woop.py).

Per triangle, an affine map M sends the triangle to the unit triangle
(v0 -> origin, e1 -> x, e2 -> y, normal -> z); a ray (o, d) then hits at

    t = -(M o + b)_z / (M d)_z,   (u, v) = ((M p + b)_x, (M p + b)_y),
    p = o + t d,  hit = u >= 0 & v >= 0 & u + v <= 1 & t in (t_min, t_max).

`closest_scan` and `any_scan` are the plain torch versions of the CUDA
brute-force kernels (ops/cuda_isect.py) and the CPU intersector of the
wavefront.  Ties: among exactly equal t the lowest prim id wins (argmin
returns the first minimum, and later chunks replace only on strictly
smaller t).  The test's multiply-adds are fused, as XLA fuses them: a
hit point rounded differently moves the next ray's origin, and at a seam
that picks another triangle.
"""

from __future__ import annotations

import numpy as np
import torch

from . import math3d as m3

_BIG = 1e30


def woop_transform(tri_pos: np.ndarray) -> np.ndarray:
    """(T,3,3) triangles -> (T,12) float32 [M rows x,y,z | b = -M v0]
    (numpy, identical to the JAX package's)."""
    t = tri_pos.shape[0]
    v0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - v0
    e2 = tri_pos[:, 2] - v0
    n = np.cross(e1, e2)
    mat = np.stack([e1, e2, n], axis=-1)  # (T,3,3) columns [e1 e2 n]
    det = np.linalg.det(mat)
    ok = np.abs(det) > 1e-18
    safe = mat.copy()
    safe[~ok] = np.eye(3)
    minv = np.linalg.inv(safe)
    minv[~ok] = 0.0
    b = -np.einsum("tij,tj->ti", minv, v0)
    b[~ok] = 0.0
    return np.concatenate([minv.reshape(t, 9), b], axis=1).astype(np.float32)


def _chunk_t(origin, direction, w, t_min, t_max):
    """(R,3) rays x (C,12) Woop rows -> (R,C) t with misses at 1e30; leading
    axes broadcast ((..., R,3) rays x (..., C,12) rows -> (..., R,C)).
    Multiply-adds are fused (m3.fma) as XLA fuses them in the JAX package,
    a*b + c*d + e*f as fma(e, f, fma(a, b, c*d)), and as the CUDA kernels
    call fmaf (csrc/common.cuh:woop_test)."""
    ox, oy, oz = origin[..., 0:1], origin[..., 1:2], origin[..., 2:3]
    dx, dy, dz = direction[..., 0:1], direction[..., 1:2], direction[..., 2:3]
    w = w.unsqueeze(-3)
    az0, az1, az2, bz = w[..., 6], w[..., 7], w[..., 8], w[..., 11]
    opz = m3.fma(oz, az2, m3.fma(ox, az0, oy * az1)) + bz
    dpz = m3.fma(dz, az2, m3.fma(dx, az0, dy * az1))
    live = torch.abs(dpz) > 1e-12
    t = -opz / torch.where(live, dpz, 1.0)

    px, py, pz = m3.fma(t, dx, ox), m3.fma(t, dy, oy), m3.fma(t, dz, oz)
    ax0, ax1, ax2, bx = w[..., 0], w[..., 1], w[..., 2], w[..., 9]
    u = m3.fma(pz, ax2, m3.fma(px, ax0, py * ax1)) + bx
    ay0, ay1, ay2, by = w[..., 3], w[..., 4], w[..., 5], w[..., 10]
    v = m3.fma(pz, ay2, m3.fma(px, ay0, py * ay1)) + by

    hit = (
        live
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[..., None])
        & (t < t_max[..., None])
    )
    return torch.where(hit, t, _BIG)


def _recover_uv(origin, direction, woop, prim, t):
    """(u, v) of each ray's winning triangle — (R,) work."""
    w = woop[torch.clamp(prim, min=0)]  # (R,12)
    p = m3.fma(direction, t[:, None], origin)
    u = m3.fma(p[:, 2], w[:, 2], m3.fma(p[:, 0], w[:, 0], p[:, 1] * w[:, 1])) + w[:, 9]
    v = m3.fma(p[:, 2], w[:, 5], m3.fma(p[:, 0], w[:, 3], p[:, 1] * w[:, 4])) + w[:, 10]
    return u, v


def _chunks(woop, chunk: int):
    tcount = woop.shape[0]
    for base in range(0, tcount, chunk):
        yield base, woop[base:base + chunk]


def _gated_t(origin, direction, base, w, t_min, t_max, gate):
    t = _chunk_t(origin, direction, w, t_min, t_max)
    return t if gate is None else torch.where(gate(base, w.shape[0]), t, _BIG)


def closest_scan(origin, direction, woop, t_min, t_max, chunk: int = 512, gate=None):
    """Closest hit over all triangles of the (T,12) table, `chunk` at a
    time.  Returns (t, prim, u, v): t = 1e30 and prim = -1 on a miss.
    gate(base, n) -> (R, n) bool, when given, keeps only the triangles
    base .. base + n - 1 that each ray may test (bvh/cluster_sweep.py)."""
    r = origin.shape[0]
    best_t = torch.full((r,), _BIG, dtype=torch.float32, device=origin.device)
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=origin.device)
    for base, w in _chunks(woop, chunk):
        t = _gated_t(origin, direction, base, w, t_min, t_max, gate)
        arg = torch.argmin(t, dim=1)
        t_new = torch.gather(t, 1, arg[:, None])[:, 0]
        closer = t_new < best_t
        best_prim = torch.where(closer, (base + arg).to(torch.int32), best_prim)
        best_t = torch.where(closer, t_new, best_t)
    prim = torch.where(best_t < _BIG, best_prim, -1)
    u, v = _recover_uv(origin, direction, woop, prim, torch.where(prim >= 0, best_t, 0.0))
    u = torch.where(prim >= 0, u, 0.0)
    v = torch.where(prim >= 0, v, 0.0)
    return best_t, prim, u, v


def any_scan(origin, direction, woop, t_min, t_max, chunk: int = 512, gate=None):
    """Any-hit over all triangles (those `gate` keeps, as in closest_scan):
    True where something lies in (t_min, t_max)."""
    occ = torch.zeros((origin.shape[0],), dtype=torch.bool, device=origin.device)
    for base, w in _chunks(woop, chunk):
        t = _gated_t(origin, direction, base, w, t_min, t_max, gate)
        occ = occ | torch.any(t < _BIG, dim=1)
    return occ
