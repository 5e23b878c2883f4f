"""K7c / K7d / K7e: the cluster sweep (csrc/cluster.cu), the BVH kernels of
the wavefront with cfg.bvh_kernel "cluster".

The counterpart of gpuspectral_tpu/bvh/cluster_sweep.py.  The BVH's leaf
clusters, in their Morton (DFS) order, are grouped into S <= 1024
supernodes of K clusters each (`supernode_tables`), so a supernode is a
contiguous run of `stride` = K * leaf_size triangle slots with one box.
Rays go in blocks of BLOCK = 256 consecutive rays:

  K7c `cluster_votes`: one vote per (ray block, supernode), 1 iff some ray
      of the block passes the slab test against the supernode's box on its
      (t_min, t_max) segment (cluster_sweep.py:55-92);
  K7d `cluster_closest`: each ray Woop-tests the slots of every supernode
      its block voted for, in slot order, and keeps the closest hit
      (t, prim, u, v) and its fused attribute row (cluster_sweep.py:132-198);
  K7e `cluster_any`: the same sweep for occlusion in (t_min, t_max)
      (cluster_sweep.py:201-230).

On the card K7d / K7e sweep a warp of 32 rays at a time and skip, for each
ray, the voted supernodes and leaf clusters whose box its own widened slab
test (`slab_entered`) does not enter: no slot inside holds a hit the ray
would take, so the result is the same (csrc/cluster.cu, header).  K7c
tests a warp's live rays as one bundle (`bundle_culls`) before their own
slab tests, which the bundle's interval arithmetic never wrongly culls, so
its votes are the plain ones (`bundle_vote_tests` models its schedule).

The result is not always the exact closest hit: a hit in a supernode that
no ray of the block voted for (a slab test that rounds the other way at a
box's edge) is lost, as on the TPU.  The plain versions (`*_ref`) are the
chunked Woop scans of ops/woop.py that bvh/ftb.py's plain versions run,
gated to the slots of the supernodes each ray's block voted for, so they
give exactly what the kernels give, ties included (the lowest slot wins
among exactly tied t).

`active`, `t_min` and `t_max` mean what they mean in bvh/ftb.py: closest
hits take t in (0, t_max) and inactive rays miss; any hits take t in
(t_min, t_max) and inactive rays are never occluded.  Inactive rays carry
t_max = -1e30 and so never vote.  For CUDA tensors the wrappers launch the
kernels or raise, and count their launches in utils.profiling; for CPU tensors
they run the plain versions.  `cluster_closest` and `cluster_any` launch
K7c first unless given the votes.  Every wrapper takes the scene's
supernode tables (`scene_supernodes`) as `supernodes=`: the wavefront
builds them once per render, not at each call.  `vote_tests` counts the
tests of a block's rays against a supernode up to the first that passes,
`bundle_vote_tests` the bundle and slab tests K7c makes, `sweep_tests`
those of the block sweep (every slot of the voted supernodes) and
`gated_tests` those K7d / K7e make, for their bounds.
K7d / K7e read the scene's (T, 12) Woop rows with 128-bit loads: the
wrappers raise ValueError unless `scene.tri_woop` is contiguous float32 on
a 16-byte boundary (_build.check_aligned).

Not carried over from the TPU: the fallback to the XLA traversal above
MAX_VMEM_SLOTS (gpuspectral_tpu/integrator/path_tracer.py:213-221) and the
fused_attr_rows threshold (dfs_sweep.py:368-375), which size the TPU's VMEM.
The port computes the function, not that memory plan: K7d always returns
the attribute rows, at any scene size (K3 does the same).

`cluster_closest_diff` is the differentiable closest hit
(dfs_sweep.closest_diff with kernel "cluster"): K7c + K7d forward, the
backward of ops/cuda_isect.woop_vjp (ftb.ClosestDiff); attrs are detached.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import math3d as m3
from ..ops import woop
from ..utils import profiling
from . import ftb

_BIG = 1e30
BLOCK = 256  # rays per vote block (cluster_sweep.py:BLOCK)
LANE = 128
MAX_SUPERNODES = 1024
SWEEP = 128  # a supernode's slots are a whole number of SWEEP-slot runs
# rays per chunk of the plain vote (a (rays x S) intermediate per step)
_VOTE_RAYS = 16 * BLOCK


def supernode_tables(node_min, node_max, n_clusters: int, padded_tris: int, leaf_size: int):
    """(blo (3, Sp), bhi (3, Sp), woop-pad count, S, K): the leaf clusters
    (DFS-contiguous) grouped into S <= MAX_SUPERNODES supernodes of K
    clusters, their boxes reduced (cluster_sweep.py:238-280).  K * leaf_size
    is a multiple of SWEEP.  Sp pads S to a multiple of LANE.

    Padding supernodes never vote.  Inverted bounds (+inf lo, -inf hi) would
    not do that: the slab test's per-axis min / max turns them into windows
    that pass for every ray.  A supernode of padding clusters only gets a
    distant point box with distinct per-axis coordinates instead, whose
    t_near exceeds its t_far for every ray that does not pass exactly
    through the point.  The woop-pad count is the number of slots the last
    supernode reaches past the table (slots the kernels never read)."""
    assert SWEEP % leaf_size == 0, (SWEEP, leaf_size)
    first_leaf = n_clusters - 1
    cl_min = node_min[first_leaf:first_leaf + n_clusters]
    cl_max = node_max[first_leaf:first_leaf + n_clusters]
    align = max(1, SWEEP // leaf_size)
    k = -(-n_clusters // MAX_SUPERNODES)
    k = -(-k // align) * align
    s = -(-n_clusters // k)
    dev = node_min.device

    def pad(x, n, fill):
        return torch.cat([x, torch.full((n, 3), fill, dtype=x.dtype, device=dev)]) if n else x

    pad_cl = s * k - n_clusters
    sn_min = pad(cl_min, pad_cl, float("inf")).reshape(s, k, 3).amin(1)
    sn_max = pad(cl_max, pad_cl, float("-inf")).reshape(s, k, 3).amax(1)
    sp = -(-s // LANE) * LANE
    sn_min = pad(sn_min, sp - s, float("inf"))
    sn_max = pad(sn_max, sp - s, float("-inf"))
    # (2e8, 3e8, 4e8), made on the device: no copy from the host
    far = torch.arange(2, 5, dtype=torch.float32, device=dev) * 1e8
    invalid = ~torch.isfinite(sn_min[:, 0:1]) | (sn_min[:, 0:1] > sn_max[:, 0:1])
    sn_min = torch.where(invalid, far, sn_min)
    sn_max = torch.where(invalid, far, sn_max)
    return (sn_min.t().contiguous(), sn_max.t().contiguous(),
            max(0, s * k * leaf_size - padded_tris), s, k)


class Supernodes(NamedTuple):
    """A scene's supernodes as the wrappers take them: boxes (3, Sp), their
    count S and the slots of one (stride = K * leaf_size)."""
    blo: torch.Tensor
    bhi: torch.Tensor
    s: int
    stride: int


def scene_supernodes(scene) -> Supernodes:
    """The scene's supernode tables.  Build them once per render and pass
    them to the wrappers (`supernodes=`); a wrapper given none builds them
    itself (about 15 torch ops over the leaf clusters)."""
    blo, bhi, _, s, k = supernode_tables(scene.bvh_node_min, scene.bvh_node_max,
                                         scene.bvh_clusters, scene.padded_tris,
                                         scene.bvh_leaf_size)
    return Supernodes(blo, bhi, s, k * scene.bvh_leaf_size)


def _sn(scene, supernodes):
    return scene_supernodes(scene) if supernodes is None else supernodes


def _slab_blocks(sn: Supernodes, origin, direction, t_min, t_max):
    """Yields (first block, (blocks, BLOCK, S) bool): the slab test of each
    ray of those blocks against each supernode box, _VOTE_RAYS rays at a
    time.  The last block's missing rays never pass."""
    r = origin.shape[0]
    lo, hi = sn.blo[:, :sn.s], sn.bhi[:, :sn.s]
    for r0 in range(0, r, _VOTE_RAYS):
        r1 = min(r, r0 + _VOTE_RAYS)
        o = origin[r0:r1, :, None]
        di = inv_dir_nan(direction[r0:r1])[:, :, None]
        t0 = (lo[None] - o) * di  # (rays, 3, S)
        t1 = (hi[None] - o) * di
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                               torch.maximum(near[:, 2], t_min[r0:r1, None]))
        t_far = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                              torch.minimum(far[:, 2], t_max[r0:r1, None]))
        hit = t_far >= t_near
        pad = -(r1 - r0) % BLOCK
        hit = torch.cat([hit, hit.new_zeros((pad, sn.s))]) if pad else hit
        yield r0 // BLOCK, hit.reshape(-1, BLOCK, sn.s)


def cluster_votes_ref(scene, origin, direction, t_min, t_max, supernodes=None):
    """Plain torch version of cluster_votes: the slab test of every ray
    against every supernode box, any-reduced over each block of BLOCK rays."""
    sn = _sn(scene, supernodes)
    votes = torch.zeros((-(-origin.shape[0] // BLOCK), sn.s), dtype=torch.int32,
                        device=origin.device)
    for b0, hit in _slab_blocks(sn, origin, direction, t_min, t_max):
        votes[b0:b0 + hit.shape[0]] = hit.any(1).to(torch.int32)
    return votes


def _check(scene, origin, direction, *scalars):
    ftb._check_rays(origin, direction, *scalars)
    ftb._check_scene(scene, origin.device)
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cluster_sweep: unsupported device {origin.device}")


def _check_votes(votes, r, s, dev):
    want = (-(-r // BLOCK), s)
    if (votes.device != dev or votes.dtype != torch.int32 or tuple(votes.shape) != want
            or not votes.is_contiguous()):
        raise ValueError(f"votes: want contiguous int32 {want} on {dev}, got {votes.dtype} "
                         f"{tuple(votes.shape)} on {votes.device}")


def cluster_votes(scene, origin, direction, t_min, t_max, active=None, supernodes=None):
    """K7c: (ceil(R / BLOCK), S) int32 votes, 1 where some ray of the block
    passes the slab test against the supernode's box on (t_min, t_max).
    `supernodes`: scene_supernodes(scene), built here when not given."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    _check(scene, origin, direction, t_min, t_max)
    sn = _sn(scene, supernodes)
    if origin.device.type == "cpu":
        return cluster_votes_ref(scene, origin, direction, t_min, t_max, supernodes=sn)
    from .. import _build

    lib = _build.load()
    r = origin.shape[0]
    votes = torch.empty((-(-r // BLOCK), sn.s), dtype=torch.int32, device=origin.device)
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_cluster_votes(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                                   t_max.data_ptr(), r, sn.blo.data_ptr(), sn.bhi.data_ptr(),
                                   sn.blo.shape[1], sn.s, votes.data_ptr(), stream)
    _build.check(rc, "cluster_votes")
    profiling.count("cluster_votes.launch")
    return votes


def _gate(sn: Supernodes, votes, r: int):
    """woop.closest_scan's gate: slot base + j lies in a supernode that ray
    i's block voted for.  Slots past the last supernode are never swept."""
    rows = torch.arange(r, device=votes.device)[:, None] // BLOCK

    def gate(base: int, n: int):
        s = torch.arange(base, base + n, device=votes.device) // sn.stride
        ok = s < votes.shape[1]
        return (votes[rows, torch.clamp(s, max=votes.shape[1] - 1)[None, :]] > 0) & ok

    return gate


def _sweep_tables(scene, sn: Supernodes, votes):
    """K7d / K7e's tables (csrc/cluster.cu:Sweep) as the arguments of
    gst_cluster_closest / gst_cluster_any that follow the rays, and the
    tensors behind them, which the caller holds until the launch returns:
    the votes, the supernode boxes, the leaf clusters' boxes (cluster_boxes)
    and the (T, 12) Woop rows."""
    cmin, cmax = (x.contiguous() for x in cluster_boxes(scene)[:2])
    woop_rows = scene.tri_woop
    held = (votes, sn.blo, sn.bhi, cmin, cmax, woop_rows)
    return [votes.data_ptr(), sn.blo.data_ptr(), sn.bhi.data_ptr(), sn.blo.shape[1], sn.s,
            sn.stride, cmin.data_ptr(), cmax.data_ptr(), cmin.shape[0], scene.bvh_leaf_size,
            woop_rows.data_ptr(), woop_rows.shape[0]], held


def cluster_closest_ref(scene, origin, direction, active=None, t_max=None, attr=None,
                        votes=None, supernodes=None):
    """Plain torch version of cluster_closest (votes: cluster_votes_ref's
    unless given)."""
    sn = _sn(scene, supernodes)
    t_max = ftb._tmax(origin, t_max, active)
    zeros = torch.zeros_like(t_max)
    if votes is None:
        votes = cluster_votes_ref(scene, origin, direction, zeros, t_max, supernodes=sn)
    t, prim, u, v = woop.closest_scan(origin, direction, scene.tri_woop, zeros, t_max,
                                      ftb._chunk(scene, origin.shape[0]),
                                      _gate(sn, votes, origin.shape[0]))
    attr = ftb.attr_table(scene) if attr is None else attr
    return t, prim, u, v, ftb._gather_attrs(attr, prim)


def cluster_any_ref(scene, origin, direction, t_min, t_max, active=None, votes=None,
                    supernodes=None):
    """Plain torch version of cluster_any."""
    sn = _sn(scene, supernodes)
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    if votes is None:
        votes = cluster_votes_ref(scene, origin, direction, t_min, t_max, supernodes=sn)
    return woop.any_scan(origin, direction, scene.tri_woop, t_min, t_max,
                         ftb._chunk(scene, origin.shape[0]), _gate(sn, votes, origin.shape[0]))


def cluster_closest(scene, origin, direction, active=None, t_max=None, attr=None, votes=None,
                    supernodes=None):
    """K7c + K7d: closest hit with t in (0, t_max) over the voted
    supernodes.  Returns (t (R,) float32, 1e30 on a miss; prim (R,) int32,
    -1 on a miss; u, v (R,) float32, 0 on a miss; attrs (R, A), the rows of
    `attr` (default ftb.attr_table(scene)), 0 on a miss).  `votes`: K7c's
    output for these rays on (0, t_max), computed here when not given."""
    t_max = ftb._tmax(origin, t_max, active)
    zeros = torch.zeros_like(t_max)
    _check(scene, origin, direction, t_max)
    sn = _sn(scene, supernodes)
    attr = ftb.attr_table(scene) if attr is None else attr
    if votes is None:
        votes = cluster_votes(scene, origin, direction, zeros, t_max, supernodes=sn)
    r = origin.shape[0]
    dev = origin.device
    _check_votes(votes, r, sn.s, dev)
    from .. import _build

    _build.check_aligned("cluster_closest", **{"scene.tri_woop": scene.tri_woop})
    if dev.type == "cpu":
        return cluster_closest_ref(scene, origin, direction, t_max=t_max, attr=attr, votes=votes,
                                   supernodes=sn)
    a = attr.shape[1]
    if attr.device != dev or attr.dtype != torch.float32 or attr.shape[0] != scene.padded_tris:
        raise ValueError(f"attr: want float32 ({scene.padded_tris}, A) on {dev}")
    lib = _build.load()
    attr = attr.contiguous()
    tables, held = _sweep_tables(scene, sn, votes)  # noqa: F841 (held until the launch returns)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    attrs = torch.empty((r, a), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_cluster_closest(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), r,
                                     *tables, attr.data_ptr(), a, t.data_ptr(), prim.data_ptr(),
                                     u.data_ptr(), v.data_ptr(), attrs.data_ptr(), stream)
    _build.check(rc, "cluster_closest")
    profiling.count("cluster_closest.launch")
    return t, prim, u, v, attrs


def cluster_any(scene, origin, direction, t_min, t_max, active=None, votes=None,
                supernodes=None):
    """K7c + K7e: True where a triangle of a voted supernode lies strictly
    inside (t_min, t_max); t_min / t_max are scalars or (R,) tensors.
    `votes`: K7c's output for these rays and segments, computed here when
    not given."""
    t_min, t_max = ftb._segment(origin, t_min, t_max, active)
    _check(scene, origin, direction, t_min, t_max)
    sn = _sn(scene, supernodes)
    if votes is None:
        votes = cluster_votes(scene, origin, direction, t_min, t_max, supernodes=sn)
    r = origin.shape[0]
    dev = origin.device
    _check_votes(votes, r, sn.s, dev)
    from .. import _build

    _build.check_aligned("cluster_any", **{"scene.tri_woop": scene.tri_woop})
    if dev.type == "cpu":
        return cluster_any_ref(scene, origin, direction, t_min, t_max, votes=votes, supernodes=sn)
    lib = _build.load()
    tables, held = _sweep_tables(scene, sn, votes)  # noqa: F841 (held until the launch returns)
    occ = torch.empty((r,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_cluster_any(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                                 t_max.data_ptr(), r, *tables, occ.data_ptr(), stream)
    _build.check(rc, "cluster_any")
    profiling.count("cluster_any.launch")
    return occ


def cluster_closest_diff(scene, origin, direction, active=None, attr=None, supernodes=None):
    """cluster_closest with exact (t, u, v) gradients w.r.t. (origin,
    direction); attrs carry none (the scene's tables are detached)."""
    t_max = ftb._tmax(origin, None, active)
    attr = (ftb.attr_table(scene) if attr is None else attr).detach()
    closest = functools.partial(cluster_closest, supernodes=_sn(scene, supernodes))
    return ftb.ClosestDiff.apply(closest, origin, direction, t_max, scene, attr)


def vote_tests(scene, origin, direction, t_min, t_max, supernodes=None):
    """(ceil(R / BLOCK), S) int64: for each (ray block, supernode) the slab
    tests of the block's rays in order up to and including the first that
    passes, or all BLOCK of them (padding rays too) when none does: the work
    of a thread a supernode testing the block's rays until one passes (the
    bound's other count beside bundle_vote_tests).  Nothing renders with
    it."""
    sn = _sn(scene, supernodes)
    tests = torch.zeros((-(-origin.shape[0] // BLOCK), sn.s), dtype=torch.int64,
                        device=origin.device)
    for b0, hit in _slab_blocks(sn, origin, direction, t_min, t_max):
        first = hit.to(torch.int32).argmax(1) + 1
        tests[b0:b0 + hit.shape[0]] = torch.where(hit.any(1), first, BLOCK)
    return tests


WARP = 32  # rays a warp of K7c; BLOCK // WARP warps a block
DIRECT = 8  # csrc/cluster.cu:kDirect: a warp of at most DIRECT live rays makes no bundle test
# warps of bundle_culls at a time (a (warps, 8, S) intermediate per axis)
_BUNDLE_WARPS = 256


class Bundles(NamedTuple):
    """csrc/cluster_votes.cuh:Bundle of each warp of 32 rays: per axis the
    least and greatest origin and inverse direction ((W, 3) each) of its
    live rays, their least t_min and greatest t_max ((W,) each); +inf /
    -inf where a warp has no live ray."""
    omin: torch.Tensor
    omax: torch.Tensor
    imin: torch.Tensor
    imax: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def inv_dir_nan(direction):
    """csrc/common.cuh:inv_dir_nan of each component, the plain votes' inverse
    direction: 1 / d with |d| clamped to 1e-12, a NaN kept."""
    # a tensor numerator: `1.0 / t` is a reciprocal then a multiply in torch
    return m3.safe_div(torch.ones_like(direction), direction)


def live_rays(origin, inv, t_min, t_max):
    """(R,) bool, csrc/cluster_votes.cuh:live_ray: no NaN in the ray's origin,
    inverse direction or segment, and t_max >= t_min.  The slab test fails
    for every other ray."""
    return ((t_max >= t_min) & ~torch.isnan(origin).any(1) & ~torch.isnan(inv).any(1))


def warp_bundles(origin, inv, t_min, t_max, live) -> Bundles:
    """The Bundles of the rays' warps of 32 (the last one padded with rays
    that are not live)."""
    pad = -origin.shape[0] % WARP

    def warps(x, fill):
        x = torch.where(live.reshape(-1, *[1] * (x.dim() - 1)), x, fill)
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)]) if pad else x
        return x.reshape(-1, WARP, *x.shape[1:])

    inf = float("inf")
    return Bundles(warps(origin, inf).amin(1), warps(origin, -inf).amax(1),
                   warps(inv, inf).amin(1), warps(inv, -inf).amax(1),
                   warps(t_min, inf).amin(1), warps(t_max, -inf).amax(1))


def bundle_culls(lo_box, hi_box, b: Bundles):
    """(W, S) bool, csrc/cluster_votes.cuh:bundle_culls op for op: whether
    no live ray of warp w can pass the slab test of box s ((3, S) corners):
    per axis the least and greatest of the eight rounded products (c - o) *
    inv over the box's planes c, the bundle's extreme origins o and inverse
    directions inv, a NaN kept."""
    near, far = [], []
    for a in range(3):
        o = torch.stack([b.omax[:, a], b.omin[:, a]])[:, :, None]  # (2, W, 1)
        d = torch.cat([lo_box[a][None, None] - o, hi_box[a][None, None] - o])  # (4, W, S)
        p = torch.cat([d * b.imin[None, :, a, None], d * b.imax[None, :, a, None]])
        near.append(p[0])
        far.append(p[0])
        for q in p[1:]:  # torch.minimum / maximum keep a NaN
            near[-1] = torch.minimum(near[-1], q)
            far[-1] = torch.maximum(far[-1], q)
    t_near = torch.maximum(torch.maximum(near[0], near[1]),
                           torch.maximum(near[2], b.lo[:, None]))
    t_far = torch.minimum(torch.minimum(far[0], far[1]), torch.minimum(far[2], b.hi[:, None]))
    return t_far < t_near


class BundleTests(NamedTuple):
    """bundle_vote_tests' counts: per (block, supernode) the bundle tests and
    the exact slab tests K7c makes and the votes they give; per block the
    warps it skips."""
    bundle: torch.Tensor
    exact: torch.Tensor
    votes: torch.Tensor
    skipped: torch.Tensor


def bundle_vote_tests(scene, origin, direction, t_min, t_max, supernodes=None) -> BundleTests:
    """BundleTests ((ceil(R / BLOCK), S) int64 bundle tests, int64 exact
    slab tests, int32 votes; (ceil(R / BLOCK),) int64 warps skipped): K7c's
    schedule (csrc/cluster.cu, header) in torch.  A warp of 32 rays with no
    live ray (live_rays; padding rays past the last are not) makes no test.
    A warp of k live rays takes the supernodes 32 at a time (a step); where
    k > DIRECT and its inverse directions do not take both signs on every
    axis it makes one bundle test (bundle_culls) a supernode and keeps those
    not culled, else it keeps them all.  Of a step's kept supernodes,
    if they are at most k, each is tested exactly against each live ray,
    else each live ray against every supernode of the step: k exact slab
    tests a supernode either way, for the kept ones or for all of the step.
    The votes are the OR over the block's warps of a supernode kept and
    passed by one of the warp's rays: cluster_votes_ref's wherever the cull
    is sound.  It measures the kernel's work; nothing renders with it."""
    sn = _sn(scene, supernodes)
    r = origin.shape[0]
    inv = inv_dir_nan(direction)
    live = live_rays(origin, inv, t_min, t_max)
    b = warp_bundles(origin, inv, t_min, t_max, live)
    n_warps, n_blocks = b.lo.shape[0], -(-r // BLOCK)
    per_block = BLOCK // WARP
    lo, hi = sn.blo[:, :sn.s], sn.bhi[:, :sn.s]
    kept = torch.cat([~bundle_culls(lo, hi, Bundles(*(x[w:w + _BUNDLE_WARPS] for x in b)))
                      for w in range(0, n_warps, _BUNDLE_WARPS)])
    pad_w = n_blocks * per_block - n_warps
    lanes = torch.cat([live, live.new_zeros(n_blocks * BLOCK - r)]).reshape(
        n_blocks, per_block, WARP).sum(2)  # live rays a warp
    kept = torch.cat([kept, kept.new_zeros((pad_w, sn.s))]).reshape(n_blocks, per_block, sn.s)
    useful = ~((b.imin < 0) & (b.imax > 0)).all(1)  # cluster_votes.cuh:bundle_useful
    useful = torch.cat([useful, useful.new_zeros(pad_w)]).reshape(n_blocks, per_block)
    culls = (lanes > DIRECT) & useful
    kept = (kept | ~culls[:, :, None]) & (lanes > 0)[:, :, None]
    # a step's kept supernodes, on each of its supernodes
    step = torch.arange(sn.s, device=origin.device) // WARP
    n_steps = int(step[-1]) + 1
    per_step = torch.zeros((n_blocks, per_block, n_steps), dtype=torch.int64,
                           device=origin.device).index_add_(2, step, kept.to(torch.int64))
    by_ray = (per_step <= lanes[:, :, None])[:, :, step]  # the kept ones against each ray
    tested = torch.where(by_ray, kept, (lanes > 0)[:, :, None])
    votes = torch.zeros((n_blocks, sn.s), dtype=torch.int32, device=origin.device)
    for b0, hit in _slab_blocks(sn, origin, direction, t_min, t_max):
        nb = hit.shape[0]
        passed = hit.reshape(nb, per_block, WARP, sn.s).any(2)
        votes[b0:b0 + nb] = (passed & kept[b0:b0 + nb]).any(1).to(torch.int32)
    return BundleTests((culls.sum(1, keepdim=True)).expand(-1, sn.s).to(torch.int64),
                       (tested * lanes[:, :, None]).sum(1).to(torch.int64), votes,
                       (lanes == 0).sum(1).to(torch.int64))


def sweep_tests(scene, origin, direction, t_min, t_max, votes, any_hit: bool,
                supernodes=None):
    """((R,) int64 Woop tests, (R,) bool occluded): the tests K7d (any_hit
    False) or K7e (True) makes for each ray over `votes`.  A ray with an
    empty segment (t_max <= t_min: inactive, or past its block's end) needs
    none; otherwise every slot of each supernode its block voted for, in slot
    order, and with any_hit only up to and including its first occluder,
    where K7e stops testing it.  `occluded` is that sweep's any hit (all
    False without any_hit).  It measures the kernels' work; nothing renders
    with it."""
    sn = _sn(scene, supernodes)
    r = origin.shape[0]
    dev = origin.device
    n_slots = scene.tri_woop_t.shape[1]
    ends = torch.clamp(torch.arange(1, sn.s + 1, device=dev) * sn.stride, max=n_slots)
    slots = ends - torch.clamp(torch.arange(sn.s, device=dev) * sn.stride, max=n_slots)
    block = torch.arange(r, device=dev) // BLOCK
    live = t_max > t_min
    occluded = torch.zeros((r,), dtype=torch.bool, device=dev)
    if not any_hit:
        per_block = ((votes > 0).to(torch.int64) * slots[None]).sum(1)
        return torch.where(live, per_block[block], 0), occluded
    tests = torch.zeros((r,), dtype=torch.int64, device=dev)
    for s in range(sn.s):
        base, end = s * sn.stride, min((s + 1) * sn.stride, n_slots)
        rows = torch.nonzero((votes[block, s] > 0) & live & ~occluded)[:, 0]
        if end <= base or rows.numel() == 0:
            continue
        hit = woop._chunk_t(origin[rows], direction[rows], scene.tri_woop[base:end],
                            t_min[rows], t_max[rows]) < _BIG
        found = hit.any(1)
        tests[rows] += torch.where(found, hit.to(torch.int32).argmax(1) + 1, end - base)
        occluded[rows[found]] = True
    return tests, occluded


SLAB_MARGIN = 1.0 / 16384.0  # csrc/bvh.cuh:kSlabMargin


def inv_dir(direction):
    """csrc/bvh.cuh:inv_dir1 of each component: 1 / d with |d| clamped to
    1e-12 (fmaxf: a NaN component gives 1e12), the division in float32."""
    mag = torch.fmax(direction.abs(), torch.tensor(1e-12, dtype=direction.dtype,
                                                   device=direction.device))
    return torch.ones_like(direction) / torch.where(direction < 0, -mag, mag)


def slab_entered(lo_box, hi_box, origin, inv, lo, hi):
    """csrc/bvh.cuh:slab_entered, op for op: whether the segment [lo, hi]
    enters the box, the slab interval widened by SLAB_MARGIN.  Boxes and
    rays broadcast ((..., 3) corners against (..., 3) rays, (...) ends);
    fmin / fmax ignore a NaN operand, as fminf / fmaxf do."""
    t0 = (lo_box - origin) * inv
    t1 = (hi_box - origin) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tn = torch.fmax(torch.fmax(near[..., 0], near[..., 1]), torch.fmax(near[..., 2], lo))
    tf = torch.fmin(torch.fmin(far[..., 0], far[..., 1]), torch.fmin(far[..., 2], hi))
    return tn - SLAB_MARGIN * tn.abs() <= tf + SLAB_MARGIN * tf.abs()


def cluster_boxes(scene):
    """(C, 3) lo and hi corners of the leaf clusters (the node tables' rows
    from C - 1 on) and (C,) bool: the cluster is empty (its box inverted;
    K7d / K7e never enter it)."""
    c = scene.bvh_clusters
    lo, hi = scene.bvh_node_min[c - 1:], scene.bvh_node_max[c - 1:]
    return lo, hi, lo[:, 0] > hi[:, 0]


class GatedTests(NamedTuple):
    """gated_tests' counts: per ray, slab tests, Woop tests and the any
    hit; per warp of 32 rays, the supernodes it sweeps (those some lane
    enters while still searching); per slot, whether some ray Woop-tests
    it (the Woop rows the sweep reads)."""
    slab: torch.Tensor
    woop: torch.Tensor
    occluded: torch.Tensor
    warp_supernodes: torch.Tensor
    slots: torch.Tensor


def gated_tests(scene, origin, direction, t_min, t_max, votes, any_hit: bool,
                supernodes=None) -> GatedTests:
    """GatedTests ((R,) int64 slab tests, (R,) int64 Woop tests, (R,) bool
    occluded, (ceil(R / 32),) int64 supernodes a warp sweeps, (T,) bool
    slots some ray Woop-tests): the tests the two-gate sweep of K7d
    (any_hit False, on (0, t_max): pass t_min 0) or K7e (True) makes for
    each ray over `votes`.  A ray with an
    empty segment (t_max <= t_min) makes none.  Otherwise, in supernode
    order, one widened slab test (slab_entered) for each supernode its block
    voted for, on (t_min, best) for the closest hit, best the closest t so
    far, and on (t_min, t_max) for the any hit; where the ray enters the
    supernode, one for each of its non-empty leaf clusters and, in each
    cluster it enters, one Woop test a slot.  With any_hit the ray stops at
    its first occluder, and `occluded` is that sweep's any hit (all False
    without any_hit).  Where the ray skips a box, no slot inside holds a
    hit it would take (csrc/cluster.cu, header), so `best` is computed over
    the entered clusters only, a supernode at a time.  It measures the
    kernels' work; nothing renders with it."""
    sn = _sn(scene, supernodes)
    r = origin.shape[0]
    dev = origin.device
    n_slots, leaf = scene.tri_woop.shape[0], scene.bvh_leaf_size
    k = sn.stride // leaf
    c_lo, c_hi, c_empty = cluster_boxes(scene)
    n_clusters = c_lo.shape[0]
    inv = inv_dir(direction)
    block = torch.arange(r, device=dev) // BLOCK
    best = t_max.clone()
    todo = t_max > t_min
    slab = torch.zeros((r,), dtype=torch.int64, device=dev)
    tests = torch.zeros((r,), dtype=torch.int64, device=dev)
    occluded = torch.zeros((r,), dtype=torch.bool, device=dev)
    swept = torch.zeros((-(-r // 32),), dtype=torch.int64, device=dev)
    read = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    for s in range(sn.s):
        rows = torch.nonzero((votes[block, s] > 0) & todo)[:, 0]
        c0, c1 = s * k, min((s + 1) * k, n_clusters)
        if rows.numel() == 0:
            continue
        slab[rows] += 1
        o, d, iv, lo = origin[rows], direction[rows], inv[rows], t_min[rows]
        hi = best[rows] if not any_hit else t_max[rows]
        enter = slab_entered(sn.blo[:, s], sn.bhi[:, s], o, iv, lo, hi)
        rows, o, d, iv, lo, hi = (x[enter] for x in (rows, o, d, iv, lo, hi))
        swept[torch.unique(rows // 32)] += 1
        if rows.numel() == 0 or c1 <= c0:
            continue
        # the supernode's slots as (clusters, leaf), misses at _BIG
        base = c0 * leaf
        w = scene.tri_woop[base:min(c1 * leaf, n_slots)]
        t = woop._chunk_t(o, d, w, lo, t_max[rows])
        t = torch.cat([t, t.new_full((t.shape[0], (c1 - c0) * leaf - t.shape[1]), _BIG)], 1)
        t = t.reshape(-1, c1 - c0, leaf)
        n_in = torch.clamp(n_slots - torch.arange(c0, c1, device=dev) * leaf, 0, leaf)
        full = ~c_empty[c0:c1]
        pos = torch.arange((c1 - c0) * leaf, device=dev)
        in_table = pos < n_slots - base
        if any_hit:
            # the clusters' own tests up to and including the first occluder's
            cin = full & slab_entered(c_lo[c0:c1], c_hi[c0:c1], o[:, None], iv[:, None],
                                      lo[:, None], hi[:, None])
            hit = (t < _BIG) & cin[:, :, None]
            flat = hit.reshape(hit.shape[0], -1)
            found = flat.any(1)
            first = torch.where(found, flat.to(torch.int32).argmax(1), flat.shape[1] - 1)
            fc = first // leaf  # the cluster of the first occluder (or the last)
            upto = torch.arange(c1 - c0, device=dev)[None] <= fc[:, None]
            slab[rows] += (full[None] & upto).sum(1)
            before = (cin & (torch.arange(c1 - c0, device=dev)[None] < fc[:, None]))
            woops = (before * n_in[None]).sum(1)
            tail = torch.where(found, first % leaf + 1, n_in[fc] * cin.gather(1, fc[:, None])[:, 0])
            tests[rows] += woops + tail
            tested = cin.repeat_interleave(leaf, 1) & (pos[None] <= first[:, None]) & in_table
            read[base:base + int(in_table.sum())] |= tested.any(0)[in_table]
            occluded[rows[found]] = True
            todo[rows[found]] = False
        else:
            # best before cluster j: the closest t of the entered clusters
            # before it (a skipped one holds nothing closer)
            cm = t.amin(2)
            b = hi.clone()
            cin = torch.zeros_like(cm, dtype=torch.bool)
            for j in range(c1 - c0):
                cin[:, j] = full[j] & slab_entered(c_lo[c0 + j], c_hi[c0 + j], o, iv, lo, b)
                b = torch.where(cin[:, j], torch.minimum(b, cm[:, j]), b)
            slab[rows] += int(full.sum())
            tests[rows] += (cin * n_in[None]).sum(1)
            read[base:base + int(in_table.sum())] |= cin.any(0).repeat_interleave(leaf)[in_table]
            best[rows] = b
    return GatedTests(slab, tests, occluded, swept, read)
