"""Exact closest-hit and any-hit queries of the plain reference.

The ray-triangle test is the Woop test of the port's plain scans (a frozen
copy of gpuspectral_tpu_torch/ops/woop.py:_chunk_t, its multiply-adds fused
through float64 as there), so a hit point is rounded as the kernels round
it.  A closest hit is the smallest t in (t_min, t_max), ties to the lowest
triangle index; an any hit is True where some triangle lies in the open
interval.

Small scenes are scanned whole (`brute`).  Large ones are culled first by
boxes of 64 triangles each, taken in Morton order of their centroids and
widened by a margin, so that a box a ray misses holds no triangle it could
hit: the answer is the whole scan's, only cheaper to get.  The culling is
the reference's own; it reads nothing of the port's BVH.
"""

from __future__ import annotations

import numpy as np
import torch

from . import math3d as m3

BIG = 1e30
CLUSTER = 64
BRUTE_MAX_TRIS = 4096  # scenes up to this many triangles are scanned whole
PAIR_CHUNK = 1 << 16  # (ray, box) pairs tested a step


def woop_t(origin, direction, w, t_min, t_max):
    """(..., R,3) rays x (..., C,12) Woop rows -> (..., R,C) t, misses at
    1e30 (gpuspectral_tpu_torch/ops/woop.py:_chunk_t)."""
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
    hit = (live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[..., None]) & (t < t_max[..., None]))
    return torch.where(hit, t, BIG)


def recover_uv(origin, direction, woop, prim, t):
    """(u, v) of each ray's hit triangle (ops/woop.py:_recover_uv)."""
    w = woop[torch.clamp(prim, min=0).long()]
    p = m3.fma(direction, t[:, None], origin)
    u = m3.fma(p[:, 2], w[:, 2], m3.fma(p[:, 0], w[:, 0], p[:, 1] * w[:, 1])) + w[:, 9]
    v = m3.fma(p[:, 2], w[:, 5], m3.fma(p[:, 0], w[:, 3], p[:, 1] * w[:, 4])) + w[:, 10]
    return u, v


def _morton(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(0), c.max(0)
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-12) * 1023.0, 0, 1023).astype(np.int64)
    code = np.zeros(c.shape[0], np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return code


class Intersector:
    """Closest and any hits over a scene's (T, 12) Woop rows and (T, 3, 3)
    triangles."""

    def __init__(self, woop: torch.Tensor, tri_pos: torch.Tensor):
        self.woop = woop
        self.n = woop.shape[0]
        self.brute = self.n <= BRUTE_MAX_TRIS
        if self.brute:
            return
        pos = tri_pos.cpu().numpy().astype(np.float64)
        order = np.argsort(_morton(pos.mean(1)), kind="stable")
        k = -(-self.n // CLUSTER)
        ids = np.full(k * CLUSTER, -1, np.int64)
        ids[:self.n] = order
        ids = ids.reshape(k, CLUSTER)
        p = pos[np.maximum(ids, 0)]  # (k, C, 3, 3)
        valid = (ids >= 0)[..., None, None]
        lo = np.where(valid, p, np.inf).min(axis=(1, 2))
        hi = np.where(valid, p, -np.inf).max(axis=(1, 2))
        margin = 1e-4 * np.maximum(hi - lo, 1.0).max(1, keepdims=True) + 1e-6
        dev = woop.device
        self.ids = torch.as_tensor(ids, device=dev)
        self.lo = torch.as_tensor((lo - margin).astype(np.float32), device=dev)
        self.hi = torch.as_tensor((hi + margin).astype(np.float32), device=dev)
        rows = torch.zeros((k * CLUSTER, 12), dtype=torch.float32, device=dev)
        flat = self.ids.reshape(-1)
        rows[flat >= 0] = woop[flat[flat >= 0]]
        self.rows = rows.reshape(k, CLUSTER, 12)

    # -- the whole scan, in chunks of triangles
    def _scan(self, origin, direction, t_min, t_max):
        """(R, T) t of every ray against every triangle, chunked."""
        return torch.cat([woop_t(origin, direction, self.woop[b:b + 512], t_min, t_max)
                          for b in range(0, self.n, 512)], dim=1)

    # -- (ray, box) pairs whose widened box the ray's segment enters
    def _pairs(self, origin, direction, t_min, t_max):
        inv = 1.0 / torch.where(direction.abs() < 1e-20,
                                torch.where(direction < 0, -1e-20, 1e-20), direction)
        out = []
        for b in range(0, origin.shape[0], 4096):
            o, iv = origin[b:b + 4096, None, :], inv[b:b + 4096, None, :]
            t1, t2 = (self.lo[None] - o) * iv, (self.hi[None] - o) * iv
            near = torch.minimum(t1, t2).amax(-1)
            far = torch.maximum(t1, t2).amin(-1)
            keep = ((near <= far) & (far >= t_min[b:b + 4096, None])
                    & (near <= t_max[b:b + 4096, None]))
            r, c = torch.nonzero(keep, as_tuple=True)
            out.append((r + b, c))
        return torch.cat([r for r, _ in out]), torch.cat([c for _, c in out])

    def closest(self, origin, direction, t_min, t_max):
        """(t, prim, u, v): t = 1e30 and prim = -1 on a miss."""
        r = origin.shape[0]
        dev = origin.device
        if self.brute:
            t = self._scan(origin, direction, t_min, t_max)
            best = t.amin(1)
            ids = torch.arange(self.n, device=dev)
            prim = torch.where(t == best[:, None], ids, self.n).amin(1)
        else:
            best = torch.full((r,), BIG, dtype=torch.float32, device=dev)
            pair_t, pair_id, pair_ray = [], [], []
            rays, boxes = self._pairs(origin, direction, t_min, t_max)
            for b in range(0, rays.shape[0], PAIR_CHUNK):
                ri, bi = rays[b:b + PAIR_CHUNK], boxes[b:b + PAIR_CHUNK]
                t = woop_t(origin[ri, None, :], direction[ri, None, :], self.rows[bi],
                           t_min[ri, None], t_max[ri, None])[:, 0, :]
                tb = t.amin(1)
                gid = torch.where(t == tb[:, None], self.ids[bi], self.n).amin(1)
                best.scatter_reduce_(0, ri, tb, "amin")
                pair_t.append(tb), pair_id.append(gid), pair_ray.append(ri)
            prim = torch.full((r,), self.n, dtype=torch.int64, device=dev)
            if pair_t:
                tb, gid, ri = torch.cat(pair_t), torch.cat(pair_id), torch.cat(pair_ray)
                prim.scatter_reduce_(0, ri, torch.where(tb == best[ri], gid, self.n), "amin")
        prim = torch.where(best < BIG, prim, -1)
        u, v = recover_uv(origin, direction, self.woop, prim, torch.where(prim >= 0, best, 0.0))
        return best, prim, torch.where(prim >= 0, u, 0.0), torch.where(prim >= 0, v, 0.0)

    def any_hit(self, origin, direction, t_min, t_max):
        """(occluded, first): first is the lowest index of a triangle in the
        segment (the tests a scan in index order makes before it stops,
        less one), or -1."""
        r = origin.shape[0]
        dev = origin.device
        if self.brute:
            hit = self._scan(origin, direction, t_min, t_max) < BIG
            ids = torch.arange(self.n, device=dev)
            first = torch.where(hit, ids, self.n).amin(1)
        else:
            first = torch.full((r,), self.n, dtype=torch.int64, device=dev)
            rays, boxes = self._pairs(origin, direction, t_min, t_max)
            for b in range(0, rays.shape[0], PAIR_CHUNK):
                ri, bi = rays[b:b + PAIR_CHUNK], boxes[b:b + PAIR_CHUNK]
                t = woop_t(origin[ri, None, :], direction[ri, None, :], self.rows[bi],
                           t_min[ri, None], t_max[ri, None])[:, 0, :]
                gid = torch.where(t < BIG, self.ids[bi], self.n).amin(1)
                first.scatter_reduce_(0, ri, gid, "amin")
        return first < self.n, torch.where(first < self.n, first, -1)
