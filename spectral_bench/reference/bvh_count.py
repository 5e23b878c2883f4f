"""The benchmark's own count of the work a BVH megakernel needs: a
bounding-volume hierarchy built here from the reference's triangles, and a
walk over it that counts the box and triangle tests of each ray.

The tree: triangles in Morton order of their centroids, leaves of LEAF
consecutive triangles, then adjacent nodes paired level by level (a node
left over at the end of a level moves up alone).  The walk: from the root,
both children's boxes tested at each inner node, the nearer entered first
and the farther pushed; a closest-hit ray skips a box that starts beyond
its nearest hit so far, a shadow ray stops at its first occluder.  The
counts are a yardstick of this tree and this walk, not of the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..harness import roofline
from .isect import BIG, woop_t

LEAF = 4
STACK = 64


class Tree:
    def __init__(self, tri_pos: torch.Tensor, woop: torch.Tensor):
        from .isect import _morton

        pos = tri_pos.cpu().numpy().astype(np.float64)
        n = pos.shape[0]
        order = np.argsort(_morton(pos.mean(1)), kind="stable")
        n_leaves = -(-n // LEAF)
        slots = np.full(n_leaves * LEAF, -1, np.int64)
        slots[:n] = order
        leaf_tris = slots.reshape(n_leaves, LEAF)
        p = pos[np.maximum(leaf_tris, 0)]
        valid = (leaf_tris >= 0)[..., None, None]
        lo = [np.where(valid, p, np.inf).min(axis=(1, 2))]
        hi = [np.where(valid, p, -np.inf).max(axis=(1, 2))]
        child = [np.full((n_leaves, 2), -1, np.int64)]
        level = np.arange(n_leaves)
        next_id = n_leaves
        while level.size > 1:
            pairs = level[: level.size // 2 * 2].reshape(-1, 2)
            ids = np.arange(next_id, next_id + pairs.shape[0])
            lo_all, hi_all = np.concatenate(lo), np.concatenate(hi)
            lo.append(np.minimum(lo_all[pairs[:, 0]], lo_all[pairs[:, 1]]))
            hi.append(np.maximum(hi_all[pairs[:, 0]], hi_all[pairs[:, 1]]))
            child.append(pairs)
            next_id += pairs.shape[0]
            level = np.concatenate([ids, level[pairs.size:]])
        dev = woop.device
        self.root = int(level[0])
        self.n_leaves = n_leaves
        self.lo = torch.as_tensor(np.concatenate(lo).astype(np.float32), device=dev)
        self.hi = torch.as_tensor(np.concatenate(hi).astype(np.float32), device=dev)
        self.child = torch.as_tensor(np.concatenate(child), device=dev)
        rows = torch.zeros((n_leaves * LEAF, 12), dtype=torch.float32, device=dev)
        flat = torch.as_tensor(slots, device=dev)
        rows[flat >= 0] = woop[flat[flat >= 0]]
        self.rows = rows.reshape(n_leaves, LEAF, 12)
        self.n_tris = torch.as_tensor((leaf_tris >= 0).sum(1), device=dev)
        self.n_nodes = int(self.lo.shape[0])

    def nbytes(self) -> int:
        return self.n_nodes * 6 * 4 + self.rows.numel() * 4

    def _enter(self, node, o, inv, t_min, t_max):
        t1 = (self.lo[node] - o) * inv
        t2 = (self.hi[node] - o) * inv
        near = torch.clamp(torch.minimum(t1, t2).amax(-1), min=0.0)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (far >= t_min) & (near <= t_max)
        return hit, near

    def count(self, origin, direction, t_min, t_max, any_hit, return_best=False):
        """(box tests, triangle tests) of each ray's walk, and with
        return_best the nearest hit it found (t_max where none)."""
        r, dev = origin.shape[0], origin.device
        inv = 1.0 / torch.where(direction.abs() < 1e-20,
                                torch.where(direction < 0, -1e-20, 1e-20), direction)
        boxes = torch.ones(r, dtype=torch.int64, device=dev)
        tris = torch.zeros(r, dtype=torch.int64, device=dev)
        best = t_max.clone()
        root = torch.full((r,), self.root, dtype=torch.int64, device=dev)
        hit, _ = self._enter(root, origin, inv, t_min, best)
        node = torch.where(hit, root, -1)
        stack = torch.full((r, STACK), -1, dtype=torch.int64, device=dev)
        stack_t = torch.zeros((r, STACK), dtype=torch.float32, device=dev)
        sp = torch.zeros(r, dtype=torch.int64, device=dev)
        done = torch.zeros(r, dtype=torch.bool, device=dev)
        idx = torch.arange(r, device=dev)
        while True:
            act = (node >= 0) & ~done
            if not bool(act.any()):
                break
            a = idx[act]
            nd = node[a]
            leaf = nd < self.n_leaves
            # leaves: test their triangles
            la = a[leaf]
            if la.numel():
                ln = nd[leaf]
                t = woop_t(origin[la, None, :], direction[la, None, :], self.rows[ln],
                           t_min[la, None], best[la, None])[:, 0, :]
                tris[la] += self.n_tris[ln]
                tb = t.amin(1)
                best[la] = torch.minimum(best[la], tb)
                done[la] |= any_hit[la] & (tb < BIG)
                node[la] = -1
            # inner nodes: test both children, enter the nearer
            ia = a[~leaf]
            if ia.numel():
                c = self.child[nd[~leaf]]
                boxes[ia] += 2
                h0, n0 = self._enter(c[:, 0], origin[ia], inv[ia], t_min[ia], best[ia])
                h1, n1 = self._enter(c[:, 1], origin[ia], inv[ia], t_min[ia], best[ia])
                first0 = n0 <= n1
                near_c = torch.where(first0, c[:, 0], c[:, 1])
                far_c = torch.where(first0, c[:, 1], c[:, 0])
                near_h = torch.where(first0, h0, h1)
                far_h = torch.where(first0, h1, h0)
                far_t = torch.where(first0, n1, n0)
                both = near_h & far_h
                s = sp[ia]
                if bool((s >= STACK).any()):
                    raise RuntimeError("bvh_count: stack overflow")
                stack[ia[both], s[both]] = far_c[both]
                stack_t[ia[both], s[both]] = far_t[both]
                sp[ia] = s + both.long()
                node[ia] = torch.where(near_h, near_c, torch.where(far_h, far_c, -1))
            # rays without a node pop the next box that still starts before
            # their nearest hit
            while True:
                pop = (node < 0) & (sp > 0) & ~done
                if not bool(pop.any()):
                    break
                pa = idx[pop]
                top = sp[pa] - 1
                sp[pa] = top
                keep = stack_t[pa, top] <= best[pa]
                node[pa] = torch.where(keep, stack[pa, top], -1)
        return (boxes, tris, best) if return_best else (boxes, tris)


def frame_counts(rs, tally, rays_per_frame: float, n_pixels: int) -> dict:
    """The roofline inputs of a BVH fused kernel (K4) a frame: the tree's
    tests per ray on the tally's recorded rays plus the shaded vertices,
    times the frame's rays; bytes of the lanes, the tree and the tables."""
    tree = Tree(rs.tri_pos, rs.woop)
    o, d, lo, hi, anyh = (torch.cat([r[k] for r in tally.rays]) for k in range(5))
    ops = 0.0
    for b in range(0, o.shape[0], 1 << 15):
        sl = slice(b, b + (1 << 15))
        bx, tr = tree.count(o[sl], d[sl], lo[sl], hi[sl], anyh[sl])
        ops += float(bx.sum()) * roofline.SLAB_FLOPS + float(tr.sum()) * roofline.WOOP_FLOPS
    per_ray = ops / max(o.shape[0], 1)
    shade = tally.hits * roofline.SHADE_FLOPS / max(tally.closest + tally.shadow, 1)
    n_bytes = (n_pixels * roofline.LANE_BYTES + tree.nbytes() + rs.num_tris * 41 * 4
               + rs.num_lights * 48)
    return dict(flops=(per_ray + shade) * rays_per_frame, bytes=n_bytes,
                rays_counted=int(o.shape[0]))
