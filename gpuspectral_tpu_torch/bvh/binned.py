"""K7a / K7b: the binned sweep (csrc/binned.cu), the BVH kernels of the
wavefront with cfg.bvh_kernel "binned".

The counterpart of gpuspectral_tpu/bvh/binned.py.  The scene's SAH leaves
are grouped into `bvh_bins` sweep bins (scene/data.py, bvh/tables.py:
build_bins): bin b covers the triangle slots [b * slots, (b + 1) * slots)
of the slot-ordered Woop table, slots = `bvh_bin_slots`, and has one box in
`bvh_bin_bounds` (6, C_pad), C_pad >= bvh_bins.  Slots past the Woop table
(n_bins * slots may exceed or fall short of its width) are never tested.

  * VOTE: every ray slab-tests every bin's box on its segment [0, t_max]
    (binned.py:183-191: no widening; the inverse direction is
    math3d.safe_div(1, d), binned.py:_inv_dir1).  The votes are fixed
    before the sweep: a ray's best t does not cull its later bins.
  * K7a `binned_closest`: each ray Woop-tests the slots of the bins it
    voted for and keeps the closest hit with t in (0, t_max), exact-t ties
    to the lowest slot (binned.py:243-302: within a 128-slot chunk argmin
    takes the first minimum, and a later chunk or bin replaces the best
    only on a strictly smaller t).
  * K7b `binned_any`: True where a voted bin holds a hit in (t_min, t_max);
    the votes still use [0, t_max] (binned.py:320-340).

The result is not always the exact closest hit: a hit in a bin whose slab
test rounds the other way at its box's edge is lost, as on the TPU.  The
plain versions (`*_ref`) compute the votes (R, n_bins), then one Woop test
(ops/woop.py) of each voted (ray, bin) pair's slots, and take per ray the
smallest (t, slot); they equal the kernels bit for bit, ties included.  The
JAX kernel breaks ties the same way, so prim matches it exactly.

`active`, `t_min` and `t_max` mean what they mean in bvh/ftb.py: closest
hits take t in (0, t_max) and inactive rays miss; any hits take t in
(t_min, t_max) and inactive rays are never occluded.  Inactive rays carry
t_max = -1e30 and so never vote.  For CUDA tensors the wrappers launch the
kernels or raise, and count their launches in utils.profiling; for CPU tensors
they run the plain versions.  The attribute rows are gathered after the
kernel, as in JAX (binned.py:387-391).

The kernels compute the same function on another schedule: each ray walks
the BVH of K3 (csrc/bvh.cuh, `ftb.walk_tables`) and tests a leaf cluster
only where the ray votes for its bin, on the bins' packed rows
(`bin_rows`: scene.bvh_bin_rows, built once with the scene).  That needs a
bin to be g = slots / leaf_size whole clusters, which the wrappers check.
Two counts of the work, for the kernels' bounds: `binned_tests`, the block
sweep's (every bin's vote for every ray, every voted slot Woop-tested, the
bins a warp's union of votes visits) and `binned_walk_tests`, the walk's
own (CUDA tensors only).

Not carried over from the TPU: `fused_eligible` and MAX_VMEM_SLOTS (the
TPU's VMEM plan, above which the JAX wavefront runs its XLA traversal,
gpuspectral_tpu/integrator/path_tracer.py:213-221), the MXU's 24-bit vote
packing and the block's while_loop over its minimum voted bin.

`binned_closest_diff` is the differentiable closest hit
(binned.binned_closest_diff): K7a forward, the backward of
ops/cuda_isect.woop_vjp (ftb.ClosestDiff); attrs are detached.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import math3d as m3
from ..ops import woop
from ..utils import profiling
from . import dfs_sweep, ftb

_BIG = 1e30
BLOCK = 32  # rays a block of the block sweep that binned_tests counts (one warp)
# elements per (rays x bins) or (pairs x slots) intermediate of the plain versions
_REF_ELEMS = 1 << 21


def _votes(scene, origin, direction, t_max, live):
    """(R, n_bins) bool: the slab test of every bin's box on [0, t_max]
    (binned.py:_vote_words) for the rays where `live` holds; the others,
    which could not hit, cast no vote."""
    n_bins = scene.bvh_bins
    box = scene.bvh_bin_bounds[:, :n_bins]
    lo, hi = box[None, 0:3], box[None, 3:6]
    o = origin.detach()[:, :, None]
    # a tensor numerator: `1.0 / t` is a reciprocal then a multiply in torch
    inv = m3.safe_div(torch.ones_like(direction), direction).detach()[:, :, None]
    step = max(1, _REF_ELEMS // max(3 * n_bins, 1))
    out = []
    for i in range(0, origin.shape[0], step):
        s = slice(i, i + step)
        t0 = (lo - o[s]) * inv[s]
        t1 = (hi - o[s]) * inv[s]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                               torch.clamp(near[:, 2], min=0.0))
        t_far = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                              torch.minimum(far[:, 2], t_max[s, None]))
        out.append((t_far >= t_near) & live[s, None])
    if not out:
        return torch.zeros((0, n_bins), dtype=torch.bool, device=origin.device)
    return torch.cat(out)


def _valid(scene, dev):
    """(n_bins,) int64: the slots of each bin that lie inside the Woop table."""
    slots, n_slots = scene.bvh_bin_slots, scene.tri_woop.shape[0]
    first = torch.arange(scene.bvh_bins, device=dev) * slots
    return torch.clamp(n_slots - first, 0, slots)


def _pairs(scene, origin, direction, votes, lo, hi):
    """For each voted (ray, bin) pair, in ray then bin order: (ray, bin,
    t (P, slots) with misses at 1e30), chunked; the Woop test of
    ops/woop.py over the bin's slots on (lo, hi)."""
    slots, rows = scene.bvh_bin_slots, scene.tri_woop
    n_slots = rows.shape[0]
    ray, bins = torch.nonzero(votes, as_tuple=True)
    lanes = torch.arange(slots, device=origin.device)
    o, d = origin.detach(), direction.detach()
    step = max(1, _REF_ELEMS // slots)
    for i in range(0, ray.shape[0], step):
        r, b = ray[i:i + step], bins[i:i + step]
        s = b[:, None] * slots + lanes
        w = torch.where((s < n_slots)[..., None], rows[torch.clamp(s, max=n_slots - 1)], 0.0)
        t = woop._chunk_t(o[r, None], d[r, None], w, lo[r, None], hi[r, None])[:, 0]
        yield r, b, t


def _closest(scene, origin, direction, t_max):
    """(best t, 1e30 on a miss; prim int64, -1 on a miss; the votes) over
    the voted bins, ties to the lowest slot."""
    r = origin.shape[0]
    dev = origin.device
    votes = _votes(scene, origin, direction, t_max, t_max > 0)
    hi = torch.clamp(t_max, max=_BIG)
    best = torch.full((r,), _BIG, dtype=torch.float32, device=dev)
    cands = []
    for ray, b, t in _pairs(scene, origin, direction, votes, torch.zeros_like(hi), hi):
        arg = torch.argmin(t, dim=1)
        t_pair = t.gather(1, arg[:, None])[:, 0]
        best.scatter_reduce_(0, ray, t_pair, "amin")
        cands.append((ray, t_pair, b * scene.bvh_bin_slots + arg))
    prim = torch.full((r,), scene.tri_woop.shape[0], dtype=torch.int64, device=dev)
    for ray, t_pair, slot in cands:
        win = (t_pair == best[ray]) & (t_pair < _BIG)
        prim.scatter_reduce_(0, ray[win], slot[win], "amin")
    found = best < _BIG
    return best, torch.where(found, prim, -1), votes


def _any(scene, origin, direction, t_min, t_max):
    """(the occlusion flags (R,) over the voted bins; the first occluding
    bin, n_bins where none; the slots tested in it up to the first
    occluder; the votes)."""
    r = origin.shape[0]
    dev = origin.device
    n_bins = scene.bvh_bins
    votes = _votes(scene, origin, direction, t_max, t_max > t_min)
    occ_bin = torch.full((r,), n_bins, dtype=torch.int64, device=dev)
    first = torch.zeros((r,), dtype=torch.int64, device=dev)
    for ray, b, t in _pairs(scene, origin, direction, votes, t_min, t_max):
        hit = t < _BIG
        h = hit.any(1)
        occ_bin.scatter_reduce_(0, ray[h], b[h], "amin")
        # pairs come in bin order, so a ray's first hit pair is its occluding bin
        at = h & (b == occ_bin[ray])
        first[ray[at]] = hit[at].to(torch.int64).argmax(1) + 1
    return occ_bin < n_bins, occ_bin, first, votes


def binned_closest_ref(scene, origin, direction, active=None, t_max=None, attr=None):
    """Plain torch version of binned_closest."""
    t_max = ftb._tmax(origin, t_max, active)
    t, prim, _ = _closest(scene, origin, direction, t_max)
    return dfs_sweep._closest_out(scene, origin, direction, t, prim, attr)


def binned_any_ref(scene, origin, direction, t_min, t_max, active=None):
    """Plain torch version of binned_any."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    return _any(scene, origin, direction, t_min, t_max)[0]


def _check(scene, origin, direction, *scalars):
    ftb._check_rays(origin, direction, *scalars)
    ftb._check_scene(scene, origin.device)
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"binned: unsupported device {origin.device}")
    bounds = scene.bvh_bin_bounds
    if (bounds.dtype != torch.float32 or bounds.shape[0] != 6
            or bounds.shape[1] < scene.bvh_bins or scene.bvh_bin_slots <= 0):
        raise ValueError(f"binned: bin table {tuple(bounds.shape)} {bounds.dtype} does not "
                         f"hold {scene.bvh_bins} bins of {scene.bvh_bin_slots} slots")


def bin_rows(scene):
    """The bins' boxes as the kernels read them: scene.bvh_bin_rows, (n_bins,
    8) float32 rows [lo xyz, 0, hi xyz, 0] (bvh/tables.py:build_bin_rows),
    built once with the scene.  Raises ValueError unless they are
    contiguous float32 on a 16-byte boundary (_build.check_aligned), one row
    a bin, or unless a bin is a whole number of leaf clusters."""
    from .. import _build

    rows = scene.bvh_bin_rows
    _build.check_aligned("bin_rows", **{"scene.bvh_bin_rows": rows})
    if tuple(rows.shape) != (scene.bvh_bins, 8):
        raise ValueError(f"bin_rows: want ({scene.bvh_bins}, 8), got {tuple(rows.shape)}")
    if scene.bvh_bin_slots % scene.bvh_leaf_size:
        raise ValueError(f"binned: a bin of {scene.bvh_bin_slots} slots is no whole number "
                         f"of {scene.bvh_leaf_size}-slot clusters")
    return rows


def _launch_args(scene):
    """(the tensors the kernels read, held until the launch returns; their
    arguments: walk tables, bin rows, n_bins, clusters a bin)."""
    pairs, woop_rows, ip = ftb.walk_tables(scene)
    rows = bin_rows(scene)
    keep = (pairs, woop_rows, ip, rows)
    return keep, (pairs.data_ptr(), woop_rows.data_ptr(), ip.data_ptr(), rows.data_ptr(),
                  scene.bvh_bins, scene.bvh_bin_slots // scene.bvh_leaf_size)


def binned_closest(scene, origin, direction, active=None, t_max=None, attr=None):
    """K7a: closest hit with t in (0, t_max) over the bins each ray votes
    for.  Returns (t (R,) float32, 1e30 on a miss; prim (R,) int32, -1 on a
    miss; u, v (R,) float32, 0 on a miss; attrs (R, A), the rows of `attr`
    (default ftb.attr_table(scene)), 0 on a miss)."""
    t_max = ftb._tmax(origin, t_max, active)
    _check(scene, origin, direction, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return binned_closest_ref(scene, origin, direction, t_max=t_max, attr=attr)
    from .. import _build

    lib = _build.load()
    _keep, args = _launch_args(scene)
    r = origin.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_binned_closest(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), r,
                                    *args, t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                                    v.data_ptr(), stream)
    _build.check(rc, "binned_closest")
    profiling.count("binned_closest.launch")
    attr = ftb.attr_table(scene) if attr is None else attr
    return t, prim, u, v, ftb._gather_attrs(attr, prim)


def binned_any(scene, origin, direction, t_min, t_max, active=None):
    """K7b: True where a triangle of a bin the ray votes for lies strictly
    inside (t_min, t_max); t_min / t_max are scalars or (R,) tensors."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    _check(scene, origin, direction, t_min, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return binned_any_ref(scene, origin, direction, t_min, t_max)
    from .. import _build

    lib = _build.load()
    _keep, args = _launch_args(scene)
    r = origin.shape[0]
    occ = torch.empty((r,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_binned_any(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                                t_max.data_ptr(), r, *args, occ.data_ptr(), stream)
    _build.check(rc, "binned_any")
    profiling.count("binned_any.launch")
    return occ


def binned_closest_diff(scene, origin, direction, active=None, attr=None):
    """binned_closest with exact (t, u, v) gradients w.r.t. (origin,
    direction); attrs carry none (the scene's tables are detached)."""
    t_max = ftb._tmax(origin, None, active)
    attr = (ftb.attr_table(scene) if attr is None else attr).detach()
    return ftb.ClosestDiff.apply(binned_closest, origin, direction, t_max, scene, attr)


def binned_tests(scene, origin, direction, t_min, t_max, any_hit: bool, block: int = BLOCK):
    """((R,) int64 box tests, (R,) int64 Woop tests, (R,) int64 bins its
    block visits, the result): the tests of the block sweep of the closest
    hit (any_hit False, t_min unused) or the any hit, the TPU kernel's
    schedule (and K7a / K7b's before their walk), at `block` rays a block.
    Closest: a ray with t_max > 0 slab-tests every bin and Woop-tests every
    slot of the bins it voted for.  Any: a ray with t_max > t_min
    slab-tests the bins up to the one that holds its first occluder and
    Woop-tests its voted bins' slots up to that occluder.  Other rays test
    nothing.  A block visits each bin that one of its rays voted for while
    not yet occluded.  The result is (t, prim) or the occlusion flags, for
    holding the count to the kernel.  One of the two counts of K7a / K7b's
    bounds (binned_walk_tests is the other); nothing renders with it."""
    r = origin.shape[0]
    dev = origin.device
    n_bins = scene.bvh_bins
    valid = _valid(scene, dev)
    bins = torch.arange(n_bins, device=dev)[None, :]
    if any_hit:
        occ, occ_bin, first, votes = _any(scene, origin, direction, t_min, t_max)
        woops = torch.where(votes & (bins < occ_bin[:, None]), valid, 0).sum(1) + first
        boxes = torch.where(t_max > t_min, torch.clamp(occ_bin + 1, max=n_bins), 0)
        votes = votes & (bins <= occ_bin[:, None])  # an occluded ray votes no more
        out = occ
    else:
        t, prim, votes = _closest(scene, origin, direction, t_max)
        woops = torch.where(votes, valid, 0).sum(1)
        boxes = torch.where(t_max > 0, n_bins, 0)
        out = t, prim
    pad = -r % block
    blocks = torch.cat([votes, votes.new_zeros((pad, n_bins))]).reshape(-1, block, n_bins)
    visits = blocks.any(1).sum(1).repeat_interleave(block)[:r]
    return boxes.to(torch.int64), woops, visits, out


class WalkTests(NamedTuple):
    """binned_walk_tests' count: per ray (R,) int32 box tests (two a pair
    row visited), bin votes (slab tests of bin rows, one a run of leaves of
    one bin) and Woop tests; `result` the walk's prim (-1 on a miss) or
    occlusion (0 / 1), for holding the count to the kernel; `clusters` (C,)
    bool, the clusters whose slots some ray tested."""
    boxes: torch.Tensor
    votes: torch.Tensor
    woops: torch.Tensor
    result: torch.Tensor
    clusters: torch.Tensor


def binned_walk_tests(scene, origin, direction, t_min, t_max, any_hit: bool) -> WalkTests:
    """The tests K7a (any_hit False: the closest hit on (0, t_max), t_min
    unused) or K7b makes for each ray: the kernels' own walk with counters
    (csrc/binned.cu: gst_binned_count).  One of the two counts of their
    bounds (binned_tests is the other); it renders nothing.  CUDA tensors
    only: the plain versions walk no tree."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, None)
    _check(scene, origin, direction, t_min, t_max)
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"binned_walk_tests: the walk runs on a CUDA device, not {dev}")
    from .. import _build

    lib = _build.load()
    _keep, args = _launch_args(scene)
    r = origin.shape[0]
    boxes, votes, woops, result = (torch.empty((r,), dtype=torch.int32, device=dev)
                                   for _ in range(4))
    tested = torch.zeros((scene.bvh_clusters,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_binned_count(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                                  t_max.data_ptr(), r, *args, int(any_hit), boxes.data_ptr(),
                                  votes.data_ptr(), woops.data_ptr(), result.data_ptr(),
                                  tested.data_ptr(), stream)
    _build.check(rc, "binned_walk_tests")
    return WalkTests(boxes, votes, woops, result, tested.bool())
