"""Host-side BVH tables of the scene (numpy copies of the JAX package's
builders, so the port builds the same tables without importing JAX).

  sah               bvh/build.py, the SAH build itself (the port's copy
                    of gpuspectral_tpu/bvh/build.py)
  build_bins        gpuspectral_tpu/bvh/binned.py:75   sweep-bin AABBs
  build_dfs_tables  gpuspectral_tpu/bvh/dfs_sweep.py:66 preorder walk with
                    skip pointers (K7f / K7g's tree, and the counting walk
                    of K3's bound)
  build_pair_rows   the child-pair rows that K3, K4 and K6 walk
                    (csrc/bvh.cuh)
  build_bin_rows    the bins' boxes as the rows K7a / K7b vote on
                    (csrc/binned.cu)
  check_leaf_clusters  what the cluster gates of K7d-g assume of the
                    tables (csrc/dfs.cu, csrc/cluster.cu)
"""

from __future__ import annotations

import sys

import numpy as np

from . import build as sah  # noqa: F401

LANE = 128  # triangle slots per sweep chunk
SWEEP = 128  # slots per preorder leaf
WORD_BITS = 24  # bin-table padding multiple of the JAX vote words
MAX_BINS = 512  # gpuspectral_tpu/bvh/binned.py:MAX_BINS


def build_bins(node_min, node_max, n_clusters: int, n_clusters_real: int,
               leaf_size: int, max_bins: int = MAX_BINS,
               slots_per_bin: int = 0):
    """Group consecutive SAH leaves into sweep bins.

    Returns (bounds (6, ceil(bins/24)*24) float32, n_bins, slots_per_bin):
    bin b covers triangle slots [b*slots, (b+1)*slots).  Padding bins are
    distant point boxes (lo == hi == (1e17, 2e17, 3e17)) that no finite
    slab test enters."""
    assert LANE % leaf_size == 0, (LANE, leaf_size)
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    first_leaf = n_clusters - 1
    lo = node_min[first_leaf: first_leaf + n_clusters_real]
    hi = node_max[first_leaf: first_leaf + n_clusters_real]

    g = (slots_per_bin or LANE) // leaf_size
    while -(-n_clusters_real // g) > max_bins:
        g *= 2
    n_bins = -(-n_clusters_real // g)
    slots = g * leaf_size

    far = np.array([1e17, 2e17, 3e17], np.float32)
    blo = np.tile(far, (n_bins, 1))
    bhi = np.tile(far, (n_bins, 1))
    for b in range(n_bins):
        chunk_lo = lo[b * g: (b + 1) * g]
        chunk_hi = hi[b * g: (b + 1) * g]
        # empty (padding) leaves carry +/-inf bounds: keep them out
        ok = np.isfinite(chunk_lo).all(1) & np.isfinite(chunk_hi).all(1)
        if ok.any():
            blo[b] = chunk_lo[ok].min(0)
            bhi[b] = chunk_hi[ok].max(0)
    padded = -(-n_bins // WORD_BITS) * WORD_BITS
    bounds = np.tile(far, (2, padded, 1)).transpose(0, 2, 1).reshape(6, padded)
    bounds[0:3, :n_bins] = blo.T
    bounds[3:6, :n_bins] = bhi.T
    return np.ascontiguousarray(bounds), int(n_bins), int(slots)


BIN_COLS = 8  # floats of a bin row: 2 x float4 (32 bytes)


def build_bin_rows(bounds, n_bins: int):
    """(n_bins, 8) float32: bin b's box of build_bins' (6, C_pad) bounds as
    one 32-byte row [lo xyz, 0, hi xyz, 0], two 128-bit loads where the
    (6, C_pad) table takes six strided ones."""
    bounds = np.asarray(bounds, np.float32)
    rows = np.zeros((n_bins, BIN_COLS), np.float32)
    rows[:, 0:3] = bounds[0:3, :n_bins].T
    rows[:, 4:7] = bounds[3:6, :n_bins].T
    return rows


def build_dfs_tables(node_min, node_max, n_clusters: int, real_clusters: int,
                     leaf_size: int):
    """Flatten the implicit complete binary tree of bvh/build.py into
    preorder arrays with skip pointers, pruning padding subtrees.

    Returns (bounds (6, N) f32: rows 0-2 lo, 3-5 hi; meta (2, N) i32:
    meta[0] = preorder index after the node's subtree, meta[1] = first
    triangle slot of a leaf, -1 for an inner node).  A leaf covers
    max(2, SWEEP // leaf_size) clusters, SWEEP slots at the build's
    leaf_size of 16."""
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    real_clusters = max(1, real_clusters)
    leaf_span = max(2, SWEEP // leaf_size)
    out_lo, out_hi, out_skip, out_leaf = [], [], [], []

    if n_clusters == 1:
        out_lo.append(node_min[0])
        out_hi.append(node_max[0])
        out_skip.append(1)
        out_leaf.append(0)
    else:
        def walk(heap: int, lo: int, hi: int) -> int:
            if lo >= real_clusters:
                return 0
            k = len(out_lo)
            out_lo.append(node_min[heap])
            out_hi.append(node_max[heap])
            out_skip.append(0)  # patched below
            if hi - lo <= leaf_span:
                out_leaf.append(lo * leaf_size)
                size = 1
            else:
                out_leaf.append(-1)
                mid = (lo + hi) // 2
                size = 1 + walk(2 * heap + 1, lo, mid) + walk(2 * heap + 2, mid, hi)
            out_skip[k] = k + size
            return size

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * int(np.log2(n_clusters) + 2) + 64))
        walk(0, 0, n_clusters)
        sys.setrecursionlimit(old)

    bounds = np.stack([np.stack(out_lo, 1), np.stack(out_hi, 1)]).reshape(6, -1)
    meta = np.stack([np.asarray(out_skip, np.int32), np.asarray(out_leaf, np.int32)])
    return bounds.astype(np.float32), meta


PAIR_COLS = 16  # floats of a child-pair row: 4 x float4 (64 bytes)
EMPTY_ROOT = 0x7FFFFFFF  # the root code of a tree without a triangle (csrc/bvh.cuh: kPop)


def build_pair_rows(node_min, node_max, n_clusters: int):
    """The child-pair table of the walk of csrc/bvh.cuh.

    The implicit complete binary tree of bvh/build.py down to its clusters
    (its leaf level, heap nodes n_clusters - 1 on), with every empty cluster
    (an inverted box: padding) and every subtree of empty clusters pruned;
    an inner node left with one child is replaced by that child.  Each
    remaining inner node is one row, in breadth-first order (so the top
    levels are a prefix), holding both children's boxes, the heap boxes:
      [a.lo xyz, code a, a.hi xyz, code b, b.lo xyz, 0, b.hi xyz, 0]
    with the int32 codes stored bit for bit in the float32 lanes: a row
    index for an inner child, ~c for cluster c.  Returns (rows (P, 16)
    float32, root code): the code the walk starts from, a cluster when only
    one holds triangles, EMPTY_ROOT when none does.  A path from the root
    holds at most log2(n_clusters) rows."""
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    first_leaf = n_clusters - 1

    def child(heap: int):
        """(heap index, inner children or None for a cluster) of the
        subtree at `heap`, or None when it holds no triangle."""
        if heap >= first_leaf:
            return None if node_min[heap, 0] > node_max[heap, 0] else (heap, None)
        a, b = child(2 * heap + 1), child(2 * heap + 2)
        if a is None or b is None:
            return a if b is None else b
        return heap, (a, b)

    root = child(0)
    order = [] if root is None or root[1] is None else [root]
    for node in order:  # breadth first: `order` grows while it is read
        order.extend(c for c in node[1] if c[1] is not None)
    index = {id(node): i for i, node in enumerate(order)}

    def code(node) -> int:
        return ~(node[0] - first_leaf) if node[1] is None else index[id(node)]

    rows = np.zeros((len(order), PAIR_COLS), np.float32)
    codes = rows.view(np.int32)
    for i, node in enumerate(order):
        for k, c in enumerate(node[1]):
            rows[i, 8 * k:8 * k + 3] = node_min[c[0]]
            rows[i, 8 * k + 4:8 * k + 7] = node_max[c[0]]
            codes[i, 3 + 4 * k] = code(c)
    return rows, EMPTY_ROOT if root is None else code(root)


def last_tri_row(woop) -> int:
    """1 + the last non-zero row of the (T, 12) Woop table (0 if none): the
    rows K2 (csrc/isect.cu) tests, since a zero row passes no Woop test."""
    nz = np.flatnonzero(np.asarray(woop).any(1))
    return int(nz[-1]) + 1 if nz.size else 0


def check_leaf_clusters(woop, node_min, node_max, n_clusters: int, leaf_size: int, dfs_meta):
    """Raise ValueError unless the tables meet what the kernels' cluster
    gates assume (csrc/dfs.cu, csrc/cluster.cu): a preorder leaf starts on
    a leaf cluster, and every Woop row that a gate never tests, a slot of a
    cluster whose box is inverted (empty) or past the last cluster, is
    zero, which no Woop test passes."""
    woop = np.asarray(woop)
    offs = np.asarray(dfs_meta)[1]
    if (offs[offs >= 0] % leaf_size).any():
        raise ValueError(f"a preorder leaf starts inside a {leaf_size}-slot cluster")
    first_leaf = n_clusters - 1
    empty = np.asarray(node_min)[first_leaf:, 0] > np.asarray(node_max)[first_leaf:, 0]
    skipped = np.ones(woop.shape[0], bool)
    n = min(woop.shape[0], n_clusters * leaf_size)
    skipped[:n] = np.repeat(empty, leaf_size)[:n]
    if (woop[skipped] != 0).any():
        raise ValueError("a slot of an empty cluster (an inverted box) or past the last cluster "
                         "holds a triangle")
