"""Binned-SAH triangle ordering for the cluster-sweep BVH.

The port's copy of gpuspectral_tpu/bvh/sah.py (numpy only).

The cluster sweep (bvh/cluster_sweep.py) tests fixed 64-triangle runs of the
*sorted* triangle array, so its efficiency is set entirely by how spatially
tight contiguous runs are.  Morton order (bvh/build.py) is cheap but loose:
measured on staircase2 (31k tris, 512 clusters), a ray's slab test passes
~34 cluster AABBs — an order of magnitude above a quality tree.  This module
orders triangles by the depth-first traversal of a binned-SAH BVH (the
standard top-down build, e.g. Wald 2007, binned surface-area heuristic):
subtrees become contiguous runs, so the fixed-size clusters cut from the
order inherit SAH tightness.

This replaces the build-quality half of what `vkCmdBuildAccelerationStructuresKHR`
(reference: backend/vulkan/VulkanRays.cpp:6-86, PREFER_FAST_TRACE) does in
the graphics stack; the traversal half lives in the sweep kernels.

Pure numpy, runs once at scene load.  O(N log N) with vectorized binning.
"""

from __future__ import annotations

import numpy as np

BINS = 16


def _sa(lo, hi):
    """Surface area of AABBs: lo/hi (..., 3)."""
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def sah_dfs_order(tri_pos: np.ndarray, num_tris: int, leaf_target: int = 64) -> np.ndarray:
    """Permutation of [0, num_tris) by SAH-BVH DFS preorder (leaves merged)."""
    order, _sizes = sah_leaves(tri_pos, num_tris, leaf_target)
    return order


def sah_leaves(tri_pos: np.ndarray, num_tris: int, leaf_target: int = 64):
    """Return (order, leaf_sizes): a permutation of [0, num_tris) ordering
    triangles by the DFS preorder of a binned-SAH BVH, plus the size of each
    leaf in DFS order (variable, <= leaf_target; consecutive runs of `order`).

    The *real* (variable-size) leaves matter: slab-vote selectivity of
    fixed-size cuts of the DFS order is ~5-10x worse than of the true leaves
    (measured on staircase2 — mixing neighbouring subtrees into one cluster
    inflates its AABB).

    tri_pos: (T, 3, 3); only the first num_tris rows are used.
    """
    order, sizes, _ = sah_cuts(tri_pos, num_tris, leaf_target, 0)
    return order, sizes


def sah_cuts(tri_pos: np.ndarray, num_tris: int, leaf_target: int = 64,
             bin_target: int = 0):
    """sah_leaves plus *subtree-cut bins*: return (order, leaf_sizes,
    bin_sizes) where bin_sizes partitions [0, num_tris) of the DFS order into
    contiguous runs, each run being a maximal SAH subtree of <= bin_target
    triangles.  Because a cut node IS a node of the SAH tree, its AABB is as
    tight as the build could make it — unlike a union of `k` consecutive DFS
    leaves, which routinely straddles subtree boundaries (measured ~2x looser
    entry rates on staircase2).  bin_target=0 disables bin recording."""
    if num_tris <= leaf_target:
        return (np.arange(num_tris), np.array([num_tris]),
                np.array([num_tris] if num_tris else [], np.int64))

    pos = np.asarray(tri_pos[:num_tris], np.float64)
    tlo = pos.min(axis=1)  # (N,3) triangle AABBs
    thi = pos.max(axis=1)
    cen = 0.5 * (tlo + thi)

    order_out = np.empty(num_tris, np.int64)
    leaf_sizes = []
    bin_ends = []  # exclusive end offsets of subtree-cut bins, in DFS order
    out_at = 0
    # explicit stack of index arrays, preorder (left pushed last -> popped first)
    stack = [np.arange(num_tris)]
    while stack:
        idx = stack.pop()
        n = idx.shape[0]
        # DFS + stack discipline: when a node is popped, everything emitted so
        # far is exactly the triangles preceding its subtree, so the subtree
        # will occupy [out_at + pending, ...) — and `pending` is zero because
        # ancestors' left siblings complete before this node surfaces.  The
        # first pop at or past the last bin's end therefore starts a new bin.
        if bin_target and n <= bin_target and out_at >= (
            bin_ends[-1] if bin_ends else 0
        ):
            bin_ends.append(out_at + n)
        if n <= leaf_target:
            order_out[out_at : out_at + n] = idx
            out_at += n
            leaf_sizes.append(n)
            continue

        c = cen[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin

        best_cost = np.inf
        best_axis = -1
        best_bin = -1
        best_ids = None
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            b = ((c[:, axis] - cmin[axis]) * (BINS / ext[axis])).astype(np.int64)
            np.clip(b, 0, BINS - 1, out=b)
            counts = np.bincount(b, minlength=BINS)
            # per-bin AABB over triangle AABBs
            blo = np.full((BINS, 3), np.inf)
            bhi = np.full((BINS, 3), -np.inf)
            np.minimum.at(blo, b, tlo[idx])
            np.maximum.at(bhi, b, thi[idx])
            # left/right sweeps
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = n - lcnt
            # split after bin k: left = bins[0..k], right = bins[k+1..]
            cost = np.where(
                (lcnt[:-1] > 0) & (rcnt[:-1] > 0),
                _sa(llo[:-1], lhi[:-1]) * lcnt[:-1] + _sa(rlo[1:], rhi[1:]) * rcnt[:-1],
                np.inf,
            )
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_axis, best_bin, best_ids = axis, k, b

        if best_axis < 0:
            # all centroids coincide: unsplittable by SAH — halve arbitrarily
            mid = n // 2
            stack.append(idx[mid:])
            stack.append(idx[:mid])
            continue

        go_left = best_ids <= best_bin
        left = idx[go_left]
        right = idx[~go_left]
        if left.size == 0 or right.size == 0:  # defensive; cost=inf guards this
            mid = n // 2
            left, right = idx[:mid], idx[mid:]
        stack.append(right)
        stack.append(left)

    assert out_at == num_tris
    if bin_target:
        assert leaf_target <= bin_target, (leaf_target, bin_target)
        assert bin_ends and bin_ends[-1] == num_tris, bin_ends[-3:]
        bin_sizes = np.diff(np.concatenate([[0], bin_ends]))
    else:
        bin_sizes = np.asarray([], np.int64)
    return order_out, np.asarray(leaf_sizes, np.int64), bin_sizes
