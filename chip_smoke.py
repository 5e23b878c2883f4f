"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from gpuspectral_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's two
main paths at full size through utils.bench.run_benchmark ->
integrator.render_image_stats_auto:
  * the Cornell box at 512x512, 64 spp, depth 50 -> the megakernel (K1),
    then the wavefront dispatch (a config K1 does not cover) on the
    brute-force kernels (K2);
  * the sphere field (scene/zoo.py, 147,460 triangles, a textured floor and
    a 32x64 sky) at 512x512, 64 spp, depth 50 -> the fused-BVH megakernel
    (K4), then the wavefront dispatch on the BVH kernels (K3);
  * the sphere field at 512x512, 1 spp, depth 50 on the wavefront with
    bvh_kernel "cluster" -> the cluster sweep (K7c votes, K7d / K7e sweeps),
    with bvh_kernel "dfs" -> the block-gated depth-first walk (K7f / K7g),
    with bvh_kernel "binned" -> the per-ray-vote binned sweep (K7a /
    K7b), and with intersector "mt" -> the packet traversal (K7h);
and the training path through utils.bench.run_grad_benchmark and
diff.invert:
  * a gradient step on Cornell at 512x512, 64 spp, depth 5 (and one at
    1024x1024, 256 spp) -> the fused forward-gradient kernel K5;
  * a gradient step on the sphere field without its sky at 512x512, 64
    spp, depth 5 -> the fused-BVH forward-gradient kernel K6;
  * the differentiable wavefront on K2a / K3a / K7d / K7f / K7a / K7h, and
    10 Adam steps of invert;
the progressive path through engine.Engine (render_step: the wavefront on
K2 at 1 spp a frame) and the CLI's view; and the distribution through
parallel.dist on a one-rank NCCL group (K1, K4, K5, K6 per rank; the
sharded wavefront on K2 / K2a) and parallel.dryrun.

Phases:
  k2    closest_cuda / any_cuda vs closest_ref / any_ref: random rays against
        the Cornell and zoo tables, cut at the scene's tri_rows (36 and 90 of
        128 slots), and a 2048-triangle random-soup table, whole and cut off
        its chunks; each clean, with NaN and inactive lanes mixed in
        (odd_lanes), with every other warp dead, with one live lane a warp
        and with ~5% of the lanes live, scattered (warp_lanes): prim equal
        except exact-t ties, t within 1e-5 relative, occ equal; K2's
        registers and spills (isect_ptxas: neither kernel may spill)
  k1    Cornell and zoo at 64x64: render_image_stats_auto (K1) vs the torch
        wavefront path_tracer.render_image_stats (on K2), gates of
        tests/test_mega.py: emission-only equal on >= 99.9% of pixels;
        full (depth 4, NEE, 2 spp) <= 2% of pixels off by > 1e-3, mean
        within 2e-3, ray counts within 1%
  main  the headline run_benchmark, with K1's launch count from that run
        alone; K1 vs its plain version on 16 pixel rows of the headline
        frame at its config and timestamp (<= 2% of pixels off by > 1e-3,
        <= 1% off by > 1e-4, mean within 1e-4, rays within 1%; the headline
        image equals K1 on those rows exactly, and K1 on a grid of 3 CTAs
        equals K1 on the default grid there); K1 timed over the whole frame
        (the main path's launch), its bound the 16 rows' operations per ray
        times the frame's rays; K1 / K5's registers and spills (brute_ptxas:
        neither may spill); the wavefront dispatch at 512x512, 1 spp, power
        light pick, with K2's launch counts from that run alone; K2 vs
        closest_ref / any_ref on 1M rays, timed on them, on 65,536 of them
        (the wavefront's launch size) and on those with ~5% of the lanes
        live
  k3    ftb_closest / ftb_any vs ftb_closest_ref / ftb_any_ref on 65,536
        random rays over the sphere field, Cornell, the zoo, a
        2048-triangle soup, a slot-mode build, a morton build of a soup and
        a soup of exact-t twins, each clean and with NaN and inactive lanes
        mixed in: t, prim, u, v, attrs and occ equal, ties included (every
        hit on the twins a tie won by the lower slot); K3 timed on 1M and
        65,536 random rays beside K2 on the same rays and the plain version
        on 65,536, and on the 262,144 primary rays of the 512x512 frame;
        the tests per ray of K3's own walk (ftb.walk_tests) logged beside
        the counting walk's; the walk's kernels' registers, spills and
        stack logged (walk_ptxas: K4 and K6 must not spill)
  env   K1 and K4 on Cornell under a constant emitter and a 32x64 sky, at
        64x64, vs the wavefront: every pixel within 2e-5 (the gate of
        tests/test_envmap.py:246-335), rays within 1%
  k4    K4 vs the wavefront on K3 (textures by the same per-corner blend)
        at 64x64 on Cornell, the zoo, a small sphere field, a slot-mode
        Cornell, and a morton-built soup and a soup of twins under a quad
        light: emission only equal on >= 99.9% of pixels; full (depth 4, NEE, 2 spp) and
        power light pick with exact MIS under the tests/test_mega.py gates,
        the latter with <= 0.8% of pixels off by > 1e-4
  bvh_main       the sphere-field run_benchmark, with K4's launch count
        from that run alone (K1, K2, K3 never); K4 vs its plain version on
        8 pixel rows of the last frame at its timestamp (the gates of
        main; full spp when the plain leg takes under 60 s, else fewer
        spp at the same timestamp); those rows of the image equal K4's;
        K4 timed over the whole frame (the main path's launch), its bound
        the 8 rows' tally of tests per ray times the frame's rays
  bvh_wavefront  the same scene with intersector "pallas" at 512x512,
        1 spp: K3 launched and K4 / K1 not, image mean within 5% of K4's
  k7    cluster_votes / cluster_closest / cluster_any, dfs_closest /
        dfs_any and binned_closest / binned_any vs their plain versions on
        the scenes of k3 (65,536 random rays each; K7c's votes, K7f /
        K7g and K7a / K7b also with NaN and inactive lanes mixed in, K7c's
        also on a batch where ~5% of the lanes are live, scattered, as in
        the wavefront's late bounces): votes, t, prim, u, v, attrs and occ
        equal, ties included; K7a-g timed on the sphere field on 65,536
        random rays and on the 262,144 primary rays of the 512x512 frame,
        beside K3a / K3b, K7c also on the sparse batch; the plain versions
        once on the random rays; K7c's bundle and exact tests and skipped
        warps (its schedule's count's votes held equal to K7c's), K7d /
        K7e's supernodes swept a warp, the tests per ray of the block
        sweeps, of the two-gate sweep, of K7f / K7g's two-gate walk and of
        K7a / K7b's walk (the counting walks' results held equal to the
        kernels'), and K7a-g's registers and spills logged (no spill in
        K7c or K7f / K7g)
  cluster_main  the sphere field at 512x512, 1 spp, d50 through
        run_benchmark with intersector "pallas" and bvh_kernel "cluster":
        K7c launched once for each K7d and K7e launch, nothing else; its
        last frame against the wavefront on K3 at the same config and
        timestamp under the tests/test_mega.py gates
  dfs_main  the same with bvh_kernel "dfs": K7f and K7g launched, nothing
        else; its last frame against the same K3 frame
  binned_main  the same with bvh_kernel "binned": K7a and K7b launched,
        nothing else; its last frame against the same K3 frame
  k7 (K7h)  traverse_closest / traverse_any vs their plain versions
        (intersect_closest_bvh_ref / intersect_any_bvh_ref) on the scenes of
        k3 at packets of 32 and 1024, the soup also at 1, 96 and 2048, with
        NaN and inactive lanes mixed in (the sphere field: its 65,536 clean
        random rays at 1024, 2,048 of them with odd lanes at 32): t, prim,
        u, v and occ equal, ties included; K7h timed on the sphere field's
        random and primary rays beside K3a / K3b and PR 8's walk (the
        counting kernel, gst_traverse_count), the plain closest hit once on
        the random rays; the tests the function needs per ray held to
        NEEDED_TESTS; K7h's registers and spills and its CTAs (clusters)
        per launch logged
  traverse_main  the sphere field at 512x512, 1 spp, d50 through
        run_benchmark with intersector "mt" (the CLI's packets of 1024):
        K7h launched for closest and shadow rays, nothing else; its last
        frame against the same K3 frame
  k5    K5 vs its plain version (the wavefront with the gradient hook) at
        64x64 on Cornell and the diffuse zoo (depth 3 and 5, 2 and 4 spp):
        radiance under the tests/test_mega.py gates, rays within 1%, K5's
        image equal to K1's, the partials contracted with a fixed numpy
        cotangent within 2e-3 of the plain version's, the kd, emitter-hit
        and NEE-emission planes each against their own largest value, over
        the lanes whose path did not diverge (at most 2% may)
  grad_main  run_grad_benchmark on Cornell 512x512, 64 spp, d5, 3 steps:
        K5 launched 4 times and nothing else; K5 vs its plain version on 16
        pixel rows at the last step's timestamp (the gates of main and the
        gradient gate of k5); K5 timed over the step's frame (its one
        launch a step), its bound as K1's, and K1 over the same frame (the
        hook's cost); one step at 1024x1024, 256 spp, d5
  k6    K6 vs its plain version at 64x64 on Cornell in slot mode, the
        mixed-BSDF and textured scenes of tests/test_mega_grad.py and a
        small sphere field without sky, under the gates of k5
  grad_bvh  run_grad_benchmark on builtin:sphere_field_noenv 512x512, 64
        spp, d5, 2 steps: K6 launched 3 times, K4 / K3 never; K6 vs its
        plain version on 8 rows (the spp rule of bvh_main); K6 timed over
        the step's frame (its one launch a step) and its share of the step,
        its bound as K4's
  grad_wavefront  the differentiable wavefront at 32x32, 4 spp, d3 on the
        card (K2a through closest_diff on Cornell, K3a through
        ftb_closest_diff on a small sphere field) against the same on the
        CPU: albedo and emission gradients within 2e-3
  cluster_grad  the same through cluster_closest_diff (K7c + K7d) on the
        small sphere field without its sky
  dfs_grad  the same through dfs_closest_diff (K7f)
  binned_grad  the same through binned_closest_diff (K7a)
  traverse_grad  the same with intersector "mt" through
        traverse_closest_diff (K7h) against autograd through the plain
        traversal on the CPU
  invert  10 Adam steps of the self-target demo on Cornell 128x128, 8
        spp, d5 through K5, on the target's sample set (common random
        numbers): K5 launched 10 times, the last loss below the first
  engine  Engine on Cornell 512x512, d50, 8 progressive frames: K2a / K2b
        launched every frame and no other kernel; the frames/s; the image
        equal to render_image at 8 spp, timestamp 0 (rtol 1e-4, atol
        1e-5); a checkpoint after 4 frames restored into a fresh Engine and
        run 4 more: equal to the uninterrupted run; the CLI's view at 64x64
        (4 frames: K2, no K1; preview and output written); one 64x64 frame
        under utils.profiling.trace, its chrome trace holding "Frame" and a
        K2 kernel
  dist  a one-rank NCCL group (parallel.launch.initialize from torchrun's
        variables), mesh (1, 1): render_image_sharded_fast on the Cornell
        headline (one K1 launch) and on the sphere field at the same shape
        (one K4 launch) equal to render_mega / render_mega_bvh, rays equal;
        grad_step_sharded_fast on the grad config (one K5 launch) and on
        builtin:sphere_field_noenv (one K6 launch) against value_and_grad
        through render_mega_diff / render_mega_bvh_diff (loss rtol 1e-5,
        gradients rtol 1e-4, atol 1e-7); render_image_sharded and
        grad_step_sharded at 128x128, 4 spp, d5 (K2 / K2a) against
        render_image and autograd of the unsharded MSE (within 1e-5);
        dryrun_multichip(1); each timed beside its unsharded call; the group
        destroyed at the end

Bounds (bound_ms in the kernels line, its terms in ops_ms and bytes_ms):
the larger of the operations over 67 TFLOP/s (float32, no tensor cores)
and the bytes over 3.35 TB/s, for the work of the timed call.  Operations: WOOP_FLOPS per Woop test,
SLAB_FLOPS per box test and, in the fused kernels, SHADE_FLOPS per shaded
vertex (a closest ray that hits), with the tests counted by a WalkTally:
a brute-force closest ray tests every triangle, a brute-force shadow ray
the triangles up to its first occluder, a BVH ray the fewer operations of
two walks, each run with counters on the ray: the preorder walk with skip
pointers (ftb.ftb_walk_tests, csrc/bvh.cuh's counting walk, the
reference) and the child-pair walk that K3, K4 and K6 take
(ftb.walk_tests).  Both walks' tests per ray are logged.  K2 and K3 are
tallied on the timed call's own rays.  K7c's are, pair by pair (a block of
256 rays, a supernode), the fewer operations of two schedules of the same
votes: the block's rays tested in turn up to the first that passes
(cluster_sweep.vote_tests, SLAB_FLOPS each) and the one K7c makes
(cluster_sweep.bundle_vote_tests: BUNDLE_FLOPS for each warp with a live
ray, and SLAB_FLOPS for each live ray of a warp whose bundle the supernode
survives); that count's votes are held equal to K7c's.  K7d / K7e's are, ray
by ray, the fewer operations of two sweeps of the same function: the block
sweep (cluster_sweep.sweep_tests: each ray with a non-empty segment
Woop-tests every slot of the supernodes its block voted for, K7e only up
to the ray's first occluder) and the two-gate sweep that the kernels make
(cluster_sweep.gated_tests: a slab test per voted supernode and, in a
supernode the ray enters, per non-empty leaf cluster, then the Woop tests
of the slots of the clusters it enters; K7e up to its first occluder).
Both counts' occlusion is held equal to K7e's.  K7f / K7g's are, ray by
ray, the fewer operations of two schedules of the same walk: the block
sweep (dfs_sweep.dfs_tests: a slab test per ray for each node its block
visits, and at an entered leaf K7f's Woop tests of every slot for a ray
with a segment, K7g's up to the ray's first occluder) and the two-gate
walk that the kernels make (dfs_sweep.gated_tests: the same node tests,
then in an entered leaf a slab test per non-empty leaf cluster for a ray
still searching and the Woop tests of the clusters its own widened test
enters, K7g up to its first occluder); both counts' results are held
equal to K7f's t and prim and K7g's occlusion.  K7a / K7b's are, ray by ray, the
fewer operations of two schedules of the same function: the block sweep
(binned.binned_tests: a slab test per ray for each bin, K7b up to the bin
of the ray's first occluder, and the Woop tests of the slots of the bins
the ray voted for, K7b up to its first occluder) and the walk that the
kernels make (binned.binned_walk_tests, csrc/binned.cu:gst_binned_count:
two box tests a pair row visited, a slab test a bin vote made, the Woop
tests of the clusters tested); both counts' results are held equal to
K7a's prim and K7b's occlusion.  K7h's are counted by the packet walk as
it was before its redesign, a vote per node popped
(kernels.traverse_tests, csrc/traverse.cu:gst_traverse_count), on
the tree with its empty subtrees' boxes made NaN (skip_empty: an empty
padding cluster's zero rows never hit, so the function needs none of their
tests, and the results are held equal to K7h's): SLAB_FLOPS per ray for
each node its packet pops (any hit: while the ray is not occluded) and, at
each leaf the packet enters, MT_FLOPS per Moller-Trumbore test of the
leaf's slots for each ray with a non-empty window (any hit: up to its first
hit).  That count is held to PR 8's (NEEDED_TESTS), whatever K7h's walk
does.  The tests PR 8's walk makes on the tree as built are reported
beside them.  The rays of a fused kernel stay
inside it, so its timed rows are traced again by the torch wavefront on K2
or K3 (same config and timestamp: the same paths, rays within 1%) under a
tally, and its operations are that tally's per ray times the kernel's ray
count.  Bytes: each input read once (rays, pixel ids, scene tables, votes),
each output written once (radiance, rays, partial planes, votes, hits);
of K7d / K7e's tables, only the Woop rows of the slots the two-gate sweep
tests (GatedTests.slots) and K7d's attribute rows of the triangles hit;
of K7a / K7b's, the pair rows, the bin rows and the Woop rows of the
clusters their walk tests (WalkTests.clusters).
The timed calls are given the scene tables the wavefront builds once per
render (K7c-e's supernode tables, the closest hits' attribute rows).  Times of
the intersection kernels (K2, K3, K7a-h) are device_ms: the calls queued
behind a sleeping kernel, so that a wrapper's host time (~0.1 ms a call,
more than several of those kernels take) is not counted as the kernel's;
the rest, and K2 on the sphere field's table (seconds a call), are CUDA
events around repeated calls (cuda_ms).
No single PyTorch call computes ray-triangle intersection, a path-traced
pixel, a supernode vote, a gated sweep, a gated walk, a binned
vote-filtered walk or a BVH traversal, so library_ms is null for every
kernel.
K7h's row stands for both wrappers: launches is the sum of both counts
(launches_closest, launches_any), ms / bound_ms are the closest hit's and
ms_any / bound_ms_any the any hit's; ms_pr8 / ms_any_pr8 time PR 8's walk
(csrc/traverse.cu:gst_traverse_count, the counting kernel with its
counters, on the tree as built) on the same rays, so the row keeps the
time K7h had before its redesign.  The rows of the four megakernels time
the main path's launch (the whole frame; ms_rows the 16 rows of K1 / K5 or
the 8 rows of K4 / K6 that plain_ms times), their bounds the timed rows'
operations per ray times the frame's rays.

Every failed check raises.  Output: the card's name and power limit, one
line of JSON with the per-kernel results, and as the last line
{"ok": true, "device": {...}}.  Exits nonzero with no result when there is
no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "scenes", "cornell", "scene.xml")
HEADLINE = dict(size=512, spp=64, depth=50)
# K1 vs its plain version on SUB_ROWS pixel rows (of 128 lanes) of the headline
# frame.  On those rows, dropping Russian roulette's 1/q in the plain version
# puts 8.8% of pixels off by > 1e-4 (1.6% by > 1e-3, the mean off by 2.5e-5),
# so the tests/test_mega.py gates alone would pass it; SUB_FINE_GATE fails it.
SUB_ROWS = 16
SUB_MEAN_GATE = 1e-4
SUB_FINE_GATE = 0.01  # share of pixels off by > 1e-4
K2_RAYS = dict(parity=65536, timing=1 << 20)
K3_RAYS = dict(parity=65536, timing=1 << 20)
SPHERE_FIELD = "builtin:sphere_field"
K4_ROWS = 8  # pixel rows of the sphere-field frame K4 is held to its plain version on
PLAIN_BUDGET_S = 60.0  # longest plain-version leg of bvh_main before spp is cut
GRAD = dict(size=512, spp=64, depth=5, steps=3)  # bench.py's grad row
GRAD_1024 = dict(size=1024, spp=256, depth=5, steps=1)  # bench.py's grad_1024 row
SPHERE_FIELD_NOENV = "builtin:sphere_field_noenv"
GRAD_TOL = 2e-3  # gradients vs the plain version (tests/test_mega_grad.py's tolerance)
DEVICE = "cuda"
# the card's published peaks (H100 SXM, float32 outside the tensor cores)
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations, a fused multiply-add counted as two, comparisons not at all
WOOP_FLOPS = 32  # one Woop ray-triangle test (csrc/common.cuh:woop_test)
MT_FLOPS = 46  # one Moller-Trumbore test (csrc/traverse.cu:mt_test)
# one slab box test (csrc/common.cuh:slab_nan, csrc/traverse.cu:slab_hit,
# csrc/bvh.cuh:slab_entered): 6 subtractions, 6 products; bvh.cuh's widening
# by kSlabMargin keeps its culls conservative and is not work the function needs
SLAB_FLOPS = 12
# device_ms: the card's sleep ahead of the timed calls, per call (~0.5 ms at
# the H100's 1.98 GHz, several times a wrapper's host time)
SLEEP_CYCLES_PER_CALL = 1_000_000
# one bundle test of K7c (csrc/cluster_votes.cuh:bundle_culls): per axis 4
# subtractions and 8 products
BUNDLE_FLOPS = 36
# one shaded vertex (BSDF sample and eval, light sample, MIS, throughput):
# an estimate, not a count; it is under 15% of any fused kernel's operations
SHADE_FLOPS = 200


_START = time.perf_counter()


def log(*a):
    """Print a line now.  A phase's first line ("phase ...") also gives the
    script's elapsed seconds, so a phase's time is the gap to the next."""
    if a and str(a[0]).startswith("phase "):
        a = (f"[{time.perf_counter() - _START:.1f} s]",) + a
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warmup)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Mean milliseconds per call of the device work fn queues, without the
    host's time to queue it: after a warmup the calls are queued behind a
    kernel that holds the stream (torch.cuda._sleep), so the card runs them
    back to back between the events.  When the queue ran dry before the
    last call was queued (the host was slow: its cores are shared), the
    timing is thrown away and taken again behind a sleep four times as
    long; raises after `tries` such timings."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(tries):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps * 4 ** i)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the stream still sleeping: every call queued in time
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
    raise AssertionError(f"device_ms: the card reached the timed calls before they were queued, "
                         f"{tries} times")


def random_rays(n, lo, hi, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 0.5, size=n)).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.5, 1e30, rng.uniform(0.5, 8.0, size=n)).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (o, d.astype(np.float32), t_min, t_max)]


def soup_woop_t(n_tris, seed, dev):
    from gpuspectral_tpu_torch.ops.woop import woop_transform

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, size=(n_tris, 1, 3))
    tris = (centers + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32)
    return torch.as_tensor(woop_transform(tris).T.copy(), device=dev)


def warp_lanes(rays):
    """The lane mixes K2 is held on: the clean rays, odd_lanes, every other
    warp of 32 lanes dead, one live lane a warp, and sparse_lanes."""
    o, d, lo, hi = rays
    lane = torch.arange(o.shape[0], device=o.device)
    dead = torch.full_like(hi, -1e30)
    return dict(clean=rays, odd=odd_lanes(rays),
                dead_warps=(o, d, lo, torch.where((lane // 32) % 2 == 1, dead, hi)),
                one_a_warp=(o, d, lo, torch.where(lane % 32 == 13, hi, dead)),
                sparse=sparse_lanes(rays))


def check_k2(name, woop_t, rays, n_rows=None, ref_rows=None):
    """K2 on the first n_rows slots against the plain versions on the first
    ref_rows (None: every slot)."""
    from gpuspectral_tpu_torch.ops import cuda_isect as ci

    t, prim = ci.closest_cuda(*rays[:2], woop_t, *rays[2:], n_rows)
    t_ref, prim_ref = ci.closest_ref(*rays[:2], woop_t, *rays[2:], ref_rows)
    occ = ci.any_cuda(*rays[:2], woop_t, *rays[2:], n_rows)
    occ_ref = ci.any_ref(*rays[:2], woop_t, *rays[2:], ref_rows)
    torch.cuda.synchronize()
    diff = prim != prim_ref
    tie = diff & (t == t_ref)
    n_bad_prim = int((diff & ~tie).sum())
    hit = prim_ref >= 0
    rel = ((t - t_ref).abs() / t_ref.abs().clamp(min=1e-30))[hit]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    max_abs = float((t - t_ref).abs()[hit].max()) if hit.any() else 0.0
    n_occ = int((occ != occ_ref).sum())
    log(f"  K2 {name}: rays={rays[0].shape[0]} slots={woop_t.shape[1]} rows={n_rows} "
        f"live={int((rays[3] > rays[2]).sum())} hits={int(hit.sum())} "
        f"occluded={int(occ_ref.sum())} prim_mismatch={n_bad_prim} exact_t_ties={int(tie.sum())} "
        f"t_max_rel={max_rel:.3g} occ_mismatch={n_occ}")
    if n_bad_prim or max_rel > 1e-5 or n_occ or bool((t[~hit] != 1e30).any()):
        raise AssertionError(f"K2 disagrees with its plain version on {name}")
    return max_abs, float((occ.int() - occ_ref.int()).abs().max())


def phase_k2(dev, scenes):
    log("phase K2: closest_cuda / any_cuda vs closest_ref / any_ref")
    isect_ptxas()
    # (name, table, rows K2 tests, rows the plain versions test, rays): the
    # scenes cut at their tri_rows against their whole tables, the soup
    # whole and cut off its chunks (non-zero rows after the cut)
    cases = [(name, scene.tri_woop_t, scene.tri_rows, None,
              random_rays(K2_RAYS["parity"], -1.2, 2.2, 10 + i, dev))
             for i, (name, scene) in enumerate(scenes.items())]
    soup, rays = soup_woop_t(2048, 7, dev), random_rays(K2_RAYS["parity"], -2.5, 2.5, 3, dev)
    cases += [("soup2048", soup, None, None, rays), ("soup2048 cut", soup, 1001, 1001, rays)]
    errs = []
    for name, w, n_rows, ref_rows, rays in cases:
        for tag, lanes in warp_lanes(rays).items():
            errs.append(check_k2(f"{name} ({tag})", w, lanes, n_rows, ref_rows))
    return [max(e) for e in zip(*errs)]


def compare_images(tag, got, ref, rays_got, rays_ref, emission_only, mean_gate=2e-3,
                   fine_gate=1.0):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise AssertionError(f"{tag}: non-finite pixels")
    d = np.abs(got - ref).max(-1)
    rays_rel = abs(rays_got - rays_ref) / max(rays_ref, 1.0)
    if emission_only:
        frac = float(np.mean(d > 0))
        log(f"  {tag} emission-only: exact={frac == 0.0} pixels_differing={frac:.5f} "
            f"rays {rays_got:.0f} vs {rays_ref:.0f}")
        ok = frac <= 0.001 and rays_rel < 0.01
    else:
        frac = float(np.mean(d > 1e-3))
        fine = float(np.mean(d > 1e-4))
        dmean = abs(float(got.mean()) - float(ref.mean()))
        log(f"  {tag} full: pixels_off_1e-3={frac:.5f} ({int(np.sum(d > 1e-3))} of {d.size}) "
            f"pixels_off_1e-4={fine:.5f} "
            f"mean {got.mean():.6f} vs {ref.mean():.6f} (|d|={dmean:.2e}) "
            f"rays {rays_got:.0f} vs {rays_ref:.0f} (rel {rays_rel:.2e})")
        ok = frac <= 0.02 and fine <= fine_gate and dmean < mean_gate and rays_rel < 0.01
    if not ok:
        raise AssertionError(f"{tag}: K1 vs wavefront outside the gates")
    return float(d.max())


def _wrappers():
    from gpuspectral_tpu_torch.bvh import binned, cluster_sweep, dfs_sweep, ftb, kernels
    from gpuspectral_tpu_torch.integrator import mega, mega_bvh, mega_grad
    from gpuspectral_tpu_torch.ops import cuda_isect

    return dict(k1=mega.render_mega_rows, k2a=cuda_isect.closest_cuda,
                k2b=cuda_isect.any_cuda, k3a=ftb.ftb_closest, k3b=ftb.ftb_any,
                k4=mega_bvh.render_mega_bvh_rows, k5=mega_grad.render_mega_fwdgrad_rows,
                k6=mega_grad.render_mega_bvh_fwdgrad_rows, k7c=cluster_sweep.cluster_votes,
                k7d=cluster_sweep.cluster_closest, k7e=cluster_sweep.cluster_any,
                k7f=dfs_sweep.dfs_closest, k7g=dfs_sweep.dfs_any,
                k7a=binned.binned_closest, k7b=binned.binned_any,
                k7h=kernels.traverse_closest, k7h_any=kernels.traverse_any)


NONE = dict(k1=0, k2a=0, k2b=0, k3a=0, k3b=0, k4=0, k5=0, k6=0, k7c=0, k7d=0, k7e=0, k7f=0,
            k7g=0, k7a=0, k7b=0, k7h=0, k7h_any=0)


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def bound(flops, n_bytes):
    """The least time the card could take, and both of its terms: the keys
    bound_ms, bound_by, ops_ms and bytes_ms of the kernels line."""
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops_ms=t_ops, bytes_ms=t_bytes)


class WalkTally:
    """While on (a `with` block), counts the work of every K2 / K3 call: the
    active closest and shadow rays, the closest rays that hit (shaded
    vertices), Woop tests and box tests.  A brute-force closest ray tests
    each of the scene's n_tris triangles, a brute-force shadow ray those up
    to its first occluder (csrc/brute.cuh scans in index order and stops
    there), a BVH ray what the fewer of two walks did.  A lane with
    t_max <= t_min casts no ray in the fused kernels and counts nothing.
    Launches made while it is on are left out of counts() (_TALLIED)."""

    def __init__(self, n_tris):
        self.n_tris = n_tris
        self.closest = self.shadow = self.hits = 0
        # the operations of the tests the function needs: a brute-force ray's
        # own, a BVH ray's the fewer of its two walks'
        self.ops = 0
        # the tests a brute-force ray or the preorder walk (ftb.ftb_walk_tests)
        # makes, and those K3's own walk (ftb.walk_tests) makes, logged side
        # by side
        self.woop = self.box = 0
        self.walk_woop = self.walk_box = 0

    def rays(self):
        return self.closest + self.shadow

    def flops(self, shade):
        return self.ops + (self.hits * SHADE_FLOPS if shade else 0)

    def _brute(self, tests):
        self.woop += tests
        self.ops += tests * WOOP_FLOPS

    def _brute_any(self, o, d, woop_t, lo, hi):
        from gpuspectral_tpu_torch.ops import woop

        hit = woop._chunk_t(o, d, woop_t[:, :self.n_tris].t(), lo, hi) < 1e30
        first = torch.where(hit.any(1), hit.int().argmax(1) + 1, self.n_tris)
        return int(first.sum())

    def __enter__(self):
        from gpuspectral_tpu_torch.bvh import ftb
        from gpuspectral_tpu_torch.ops import cuda_isect as ci

        real = dict(closest_cuda=ci.closest_cuda, any_cuda=ci.any_cuda,
                    ftb_closest=ftb.ftb_closest, ftb_any=ftb.ftb_any)

        def closest_cuda(origin, direction, woop_t, t_min, t_max, n_rows=None):
            t, prim = real["closest_cuda"](origin, direction, woop_t, t_min, t_max, n_rows)
            n = int((t_max > t_min).sum())
            self.closest += n
            self._brute(n * self.n_tris)
            self.hits += int((prim >= 0).sum())
            return t, prim

        def any_cuda(origin, direction, woop_t, t_min, t_max, n_rows=None):
            occ = real["any_cuda"](origin, direction, woop_t, t_min, t_max, n_rows)
            act = t_max > t_min
            self.shadow += int(act.sum())
            self._brute(self._brute_any(origin[act], direction[act], woop_t, t_min[act],
                                        t_max[act]))
            return occ

        def walk(scene, origin, direction, lo, hi, any_hit):
            act = hi > lo
            rays = (scene, origin[act], direction[act], lo[act], hi[act], any_hit)
            pre, own = ftb.ftb_walk_tests(*rays), ftb.walk_tests(*rays)
            self.box += int(pre[0].sum())
            self.woop += int(pre[1].sum())
            self.walk_box += int(own[0].sum())
            self.walk_woop += int(own[1].sum())
            ops = [b.long() * SLAB_FLOPS + w.long() * WOOP_FLOPS for b, w in (pre, own)]
            self.ops += int(torch.minimum(*ops).sum())
            return int(act.sum())

        def ftb_closest(scene, origin, direction, active=None, t_max=None, attr=None):
            out = real["ftb_closest"](scene, origin, direction, active=active, t_max=t_max,
                                      attr=attr)
            hi = ftb._tmax(origin, t_max, active)
            self.closest += walk(scene, origin, direction, torch.zeros_like(hi), hi, False)
            self.hits += int((out[1] >= 0).sum())
            return out

        def ftb_any(scene, origin, direction, t_min, t_max, active=None):
            occ = real["ftb_any"](scene, origin, direction, t_min, t_max, active=active)
            r = origin.shape[0]

            def full(x):
                return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32,
                                                          device=origin.device), (r,))

            self.shadow += walk(scene, origin, direction, full(t_min).contiguous(),
                                ftb._tmax(origin, full(t_max), active), True)
            return occ

        counting = dict(closest_cuda=closest_cuda, any_cuda=any_cuda, ftb_closest=ftb_closest,
                        ftb_any=ftb_any)
        self._saved = [(ci if k.endswith("cuda") else ftb, k, fn) for k, fn in real.items()]
        self._real, self._launches = real, _launches(real)
        for mod, k, _ in self._saved:
            setattr(mod, k, counting[k])
        return self

    def __exit__(self, *exc):
        for mod, k, fn in self._saved:
            setattr(mod, k, fn)
        # the tally's own launches are set aside: the main path's counts stay
        for name, n in _launches(self._real).items():
            _TALLIED[name] = _TALLIED.get(name, 0) + n - self._launches[name]


def tally_rows(scene, cfg, pix, ts):
    """The WalkTally of a fused kernel's rows: the torch wavefront over the
    same rows, config and timestamp on K2 (brute force) or K3 (BVH)."""
    from gpuspectral_tpu_torch.integrator import path_tracer

    wcfg = cfg.replace(intersector="pallas", light_block=0, sort_rays=False, shadow_sort=False)
    with WalkTally(scene.num_tris) as tally:
        path_tracer.trace_wavefront(scene, wcfg, pix.reshape(-1), ts,
                                    tex_mode="corners" if cfg.use_bvh else "nearest")
    torch.cuda.synchronize()
    n = max(tally.rays(), 1)
    log(f"  tally of {pix.shape[0]} rows: {tally.closest} closest and {tally.shadow} shadow rays, "
        f"{tally.woop / n:.2f} Woop and {tally.box / n:.2f} box tests per ray, {tally.hits} "
        f"shaded vertices; K3's own walk {tally.walk_woop / n:.2f} Woop and "
        f"{tally.walk_box / n:.2f} box tests per ray; the tests' operations per ray "
        f"{tally.ops / n:.1f}")
    return tally


def fused_bound(tally, rays, n_bytes):
    """bound() of a fused kernel that traced `rays` rays over the tallied
    rows: the tally's operations per ray times the kernel's rays."""
    return bound(tally.flops(shade=True) * rays / max(tally.rays(), 1), n_bytes)


def bvh_tables(scene):
    """The tables K3, K4 and K6 read: pair and Woop rows."""
    from gpuspectral_tpu_torch.bvh import ftb

    return ftb.walk_tables(scene)[:2]


def mega_tables(scene, bvh):
    from gpuspectral_tpu_torch.integrator import mega, mega_bvh

    _, attr, light, camv = mega._pack_tables(scene)
    if bvh:
        return (*bvh_tables(scene), mega_bvh.pack_attr(scene, "uniform"), light, camv)
    return mega.woop_rows(scene), attr, light, camv


_TALLIED: dict = {}  # launches a WalkTally made, by counter name: left out of counts()


def _launches(wrappers: dict) -> dict:
    """{counter name: launches in utils.profiling} of wrapper functions."""
    from gpuspectral_tpu_torch.utils import profiling

    names = (f"{fn.__name__}.launch" for fn in wrappers.values())
    return {name: profiling.calls(name) for name in names}


def reset_counts():
    from gpuspectral_tpu_torch.utils import profiling

    profiling.reset()
    _TALLIED.clear()


def counts():
    return {k: n - _TALLIED.get(name, 0)
            for k, (name, n) in zip(_wrappers(), _launches(_wrappers()).items())}


def phase_k1(scenes):
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase K1: megakernel vs the torch wavefront on the card")
    for name, scene in scenes.items():
        for kw, emission_only in ((dict(max_depth=0, nee=False, spp=1), True),
                                  (dict(max_depth=4, nee=True, spp=2), False)):
            cfg = RenderConfig(width=64, height=64, ray_batch=4096, **kw)
            reset_counts()
            got, rays_got = render_image_stats_auto(scene, cfg, 0)
            c1 = counts()
            ref, rays_ref = render_image_stats(scene, cfg, 0)
            c2 = counts()
            torch.cuda.synchronize()
            if c1["k1"] < 1 or c2["k2a"] <= c1["k2a"] or (kw["nee"] and c2["k2b"] <= c1["k2b"]):
                raise AssertionError(f"{name}: launch counters did not advance: {c1} {c2}")
            compare_images(f"{name}", got, ref, rays_got, rays_ref, emission_only)


def phase_main(dev):
    from gpuspectral_tpu_torch.integrator import mega, render_image_stats_auto
    from gpuspectral_tpu_torch.ops import cuda_isect as ci
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig
    from gpuspectral_tpu_torch.utils.bench import run_benchmark

    hs, spp, depth = HEADLINE["size"], HEADLINE["spp"], HEADLINE["depth"]
    log(f"phase main: Cornell {hs}x{hs}, {spp} spp, depth {depth} through run_benchmark (K1)")
    args = argparse.Namespace(
        scene=CORNELL, size=f"{hs}x{hs}", spp=spp, depth=depth, no_nee=False, jitter=False,
        ray_batch=65536, bvh=None, bvh_kernel="ftb", light_block=None, packet_size=1024,
        intersector="auto", light_sampling="uniform", mis="reference", device=str(dev),
        warmup=1, iters=3,
    )
    reset_counts()
    result, img = run_benchmark(args, return_image=True)
    head_launches = counts()
    log("  headline: " + json.dumps(result))
    log(f"  launches in the headline run_benchmark: {head_launches}")
    frames = max(1, args.warmup) + args.iters
    if head_launches != dict(NONE, k1=frames):
        raise AssertionError(f"headline run: want K1 launched {frames} times and no other kernel")
    a = img.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all() or a.mean() <= 0.0:
        raise AssertionError(f"headline image bad: shape {a.shape}, mean {a.mean()}")

    # K1 vs its plain version (the torch wavefront) on SUB_ROWS pixel rows of
    # the headline frame, at its config and timestamp: Russian roulette,
    # late-sample regeneration and the full width all run here.  The same
    # rows of the headline image must equal K1's output exactly.
    scene, _ = load_mitsuba_scene(CORNELL, device=dev)
    cfg = RenderConfig(width=hs, height=hs, spp=spp, max_depth=depth)
    ts = 100 + args.iters - 1
    n_rows = hs * hs // mega.LANES
    sub = torch.linspace(0, n_rows - 1, min(SUB_ROWS, n_rows), device=dev).round().to(torch.int32)
    pix = (sub[:, None] * mega.LANES
           + torch.arange(mega.LANES, dtype=torch.int32, device=dev)).contiguous()
    out_k1 = mega.render_mega_rows(scene, cfg, pix, ts)
    k1_ms = cuda_ms(lambda: mega.render_mega_rows(scene, cfg, pix, ts))
    t0 = time.perf_counter()
    out_ref = mega.render_mega_rows_ref(scene, cfg, pix, ts)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    got = torch.stack(out_k1[:3], -1).reshape(-1, 3) / spp
    ref = torch.stack(out_ref[:3], -1).reshape(-1, 3) / spp
    if not torch.equal(img.reshape(-1, 3)[pix.reshape(-1).long()], got):
        raise AssertionError("headline image rows differ from K1 on the same rows")
    # the lanes' schedule changes no sum: 3 resident CTAs, each thread taking
    # its next lane from the counter many times over, give the default's
    small = mega._launch(scene, cfg, pix, ts, max_ctas=3)
    if not all(torch.equal(a, b) for a, b in zip(small, out_k1)):
        raise AssertionError("K1 on a grid of 3 CTAs differs from K1 on the default grid")
    rays_k1 = float(out_k1[3].double().sum())
    rays_ref = float(out_ref[3].double().sum())
    k1_err = compare_images(f"K1 vs plain, {pix.shape[0]} rows of the headline frame (ts {ts})",
                            got, ref, rays_k1, rays_ref, emission_only=False,
                            mean_gate=SUB_MEAN_GATE, fine_gate=SUB_FINE_GATE)
    log(f"  K1 {k1_ms:.3f} ms vs plain {ref_ms:.3f} ms on those rows "
        f"({rays_k1 / k1_ms / 1e3:.2f} vs {rays_ref / ref_ms / 1e3:.2f} Mrays/s)")
    # the main path's launch: K1 over the whole headline frame, and its share
    # of the frame's wall time
    _, frame_rays = mega.render_mega(scene, cfg, ts)
    k1_head_ms = cuda_ms(lambda: mega.render_mega(scene, cfg, ts))
    frame_ms = result["seconds_per_frame"] * 1e3
    log(f"  K1 over the headline frame: {k1_head_ms:.3f} ms of a {frame_ms:.3f} ms frame "
        f"(share {k1_head_ms / frame_ms:.3f}), {frame_rays:.0f} rays")

    # the wavefront dispatch of render_image_stats_auto on K2: power light
    # sampling, which K1 does not cover, at the headline size and 1 spp
    cfg_w = cfg.replace(spp=1, ray_batch=65536, light_sampling="power")
    reset_counts()
    t0 = time.perf_counter()
    img_w, rays_w = render_image_stats_auto(scene, cfg_w, 0)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    wave_launches = counts()
    log(f"  wavefront dispatch {hs}x{hs}@1spp d{depth}, power light pick: {wave_s:.3f} s, "
        f"rays {rays_w:.0f}, {rays_w / wave_s / 1e6:.3f} Mrays/s; launches {wave_launches}")
    if wave_launches["k1"] != 0 or wave_launches["k2a"] < 1 or wave_launches["k2b"] < 1:
        raise AssertionError("wavefront dispatch: want K2 launched and K1 not")
    a = img_w.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all():
        raise AssertionError(f"wavefront image bad: shape {a.shape}")
    # two estimators of one image: K1 at 64 spp, the power-sampled wavefront at 1
    m_k1, m_w = float(img.mean()), float(a.mean())
    log(f"  image means: K1@{spp}spp {m_k1:.5f}, wavefront@1spp {m_w:.5f}")
    if abs(m_k1 - m_w) > 0.05 * m_k1:
        raise AssertionError("K1 and wavefront images disagree in mean by > 5%")

    # K2 vs closest_ref / any_ref on 1M rays against the Cornell table, the
    # rows cut at tri_rows as the wavefront calls it; timed on them, on the
    # wavefront's launch size of 65,536 rays (ray_batch) and on those with
    # ~5% of the lanes live (its late bounces)
    rays = random_rays(K2_RAYS["timing"], -1.2, 2.2, 99, dev)
    woop_t, n_rows = scene.tri_woop_t, scene.tri_rows
    k2_err = check_k2(f"cornell {rays[0].shape[0]} rays", woop_t, rays, n_rows)
    sub = [x[:K2_RAYS["parity"]] for x in rays]
    k2_sets = dict(ms=rays, ms_65536_rays=sub, ms_sparse=sparse_lanes(sub))
    k2_ms = {key: {tag: device_ms(lambda: fn(*x[:2], woop_t, *x[2:], n_rows))
                   for tag, x in k2_sets.items()}
             for key, fn in (("k2a", ci.closest_cuda), ("k2b", ci.any_cuda))}
    k2a_ref = cuda_ms(lambda: ci.closest_ref(*rays[:2], woop_t, *rays[2:]))
    k2b_ref = cuda_ms(lambda: ci.any_ref(*rays[:2], woop_t, *rays[2:]))
    log(f"  K2 closest {k2_ms['k2a']} ms vs closest_ref {k2a_ref:.3f} ms; "
        f"any {k2_ms['k2b']} ms vs any_ref {k2b_ref:.3f} ms "
        f"({rays[0].shape[0]} rays, {sub[0].shape[0]} of them, those ~5% live; {n_rows} of "
        f"{woop_t.shape[1]} rows, {scene.num_tris} tris)")
    head = f"headline run_benchmark ({hs}x{hs}, {spp} spp, d{depth})"
    wave = f"wavefront dispatch ({hs}x{hs}, 1 spp, d{depth}, power light pick)"
    tally = tally_rows(scene, cfg, pix, ts)
    tables = nbytes(*mega_tables(scene, False))
    k1_bound = fused_bound(tally, frame_rays, hs * hs * (4 + 16) + tables)
    rows_bound = fused_bound(tally, rays_k1, pix.numel() * (4 + 16) + tables)
    log(f"  K1 frame bound {k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']}): "
        f"K1 at {k1_bound['bound_ms'] / k1_head_ms:.5f} of it")
    k2_bounds = brute_bounds(scene, k2_sets)
    ptxas = isect_ptxas()
    sparse = k2_sets["ms_sparse"]

    def k2_row(key):
        return dict(launches=wave_launches[key], launched_by=wave,
                    max_abs_err=k2_err[0 if key == "k2a" else 1], **k2_ms[key],
                    plain_ms=k2a_ref if key == "k2a" else k2b_ref, **k2_bounds[key, "ms"],
                    bound_ms_65536_rays=k2_bounds[key, "ms_65536_rays"]["bound_ms"],
                    bound_ms_sparse=k2_bounds[key, "ms_sparse"]["bound_ms"],
                    live_rays_sparse=int((sparse[3] > sparse[2]).sum()),
                    rows_tested=n_rows, slots=woop_t.shape[1], timer="device_ms",
                    ptxas=ptxas["closest_kernel" if key == "k2a" else "any_kernel"])
    return dict(
        k1=dict(launches=head_launches["k1"], launched_by=head, max_abs_err=k1_err,
                ms=k1_head_ms,
                timed_call=f"one launch over the {hs}x{hs} frame at {spp} spp, d{depth}",
                frame_rays=frame_rays, plain_ms=ref_ms,
                plain_call=f"{pix.shape[0]} pixel rows at {spp} spp", ms_rows=k1_ms,
                bound_ms_rows=rows_bound["bound_ms"], **k1_bound,
                share_of_frame=k1_head_ms / frame_ms, mrays_per_s=result["mrays_per_s"],
                ptxas=brute_ptxas()),
        k2a=k2_row("k2a"), k2b=k2_row("k2b"),
    )


def brute_bounds(scene, sets):
    """{(k2a or k2b, set): bound()} of K2 on each set of rays, cut at the
    scene's tri_rows: the tests a WalkTally counts (a brute-force ray tests
    the scene's triangles, a shadow ray up to its first occluder), the rays
    read and the hits or flags written.  Raises unless the tally saw every
    live ray."""
    from gpuspectral_tpu_torch.ops import cuda_isect as ci

    out = {}
    for key, name, out_bytes in (("k2a", "closest_cuda", 8), ("k2b", "any_cuda", 1)):
        for tag, x in sets.items():
            with WalkTally(scene.num_tris) as tally:
                getattr(ci, name)(*x[:2], scene.tri_woop_t, *x[2:], scene.tri_rows)
            r, live = x[0].shape[0], int((x[3] > x[2]).sum())
            if tally.rays() != live:
                raise AssertionError(f"K2 {key} {tag}: the tally saw {tally.rays()} of {live} "
                                     "live rays")
            out[key, tag] = bound(tally.flops(shade=False),
                                  r * (32 + out_bytes) + 12 * 4 * scene.num_tris)
            log(f"  K2 {key} {tag}: {live} live of {r} rays, Woop tests per ray "
                f"{tally.woop / r:.2f}, bound {out[key, tag]['bound_ms']:.5f} ms "
                f"({out[key, tag]['bound_by']})")
    return out


def field_rays(n, scene, seed, dev):
    """Random rays with origins in the scene's bounding box."""
    lo = float(scene.bvh_node_min[0].min()) - 0.5
    hi = float(scene.bvh_node_max[0].max()) + 0.5
    return random_rays(n, lo, hi, seed, dev)


def check_k3(name, scene, rays):
    from gpuspectral_tpu_torch.bvh import ftb

    o, d, lo, hi = rays
    t, prim, u, v, attrs = ftb.ftb_closest(scene, o, d, t_max=hi)
    occ = ftb.ftb_any(scene, o, d, lo, hi)
    t_r, prim_r, u_r, v_r, attrs_r = ftb.ftb_closest_ref(scene, o, d, t_max=hi)
    occ_r = ftb.ftb_any_ref(scene, o, d, lo, hi)
    torch.cuda.synchronize()
    bad = {k: int((a != b).sum()) for k, a, b in (
        ("t", t, t_r), ("prim", prim, prim_r), ("u", u, u_r), ("v", v, v_r),
        ("attrs", attrs, attrs_r), ("occ", occ, occ_r))}
    hit = prim_r >= 0
    ties = tied_hits(scene, prim_r) if "ties" in name else 0
    log(f"  K3 {name}: rays={o.shape[0]} slots={scene.tri_woop_t.shape[1]} "
        f"pair rows={scene.bvh_pairs.shape[0]} hits={int(hit.sum())} "
        f"exact_t_ties={ties} occluded={int(occ_r.sum())} mismatches={bad}")
    if any(bad.values()):
        raise AssertionError(f"K3 disagrees with its plain version on {name}")
    if "ties" in name and ties != int(hit.sum()):
        raise AssertionError(f"{name}: a hit of the plain version is no tie won by the lower slot")
    return float((t - t_r).abs()[hit].max()) if hit.any() else 0.0


def tied_hits(scene, prim):
    """Hits on a triangle that has a twin (the same corners in another
    slot) and is the lower slot of the two: on a soup_scene(ties=True),
    every hit, each an exact-t tie won by the lowest slot."""
    pos = scene.tri_pos.reshape(scene.padded_tris, 9)
    _, ids, counts = torch.unique(pos, dim=0, return_inverse=True, return_counts=True)
    slots = torch.arange(ids.shape[0], device=ids.device)
    first = torch.full_like(counts, ids.shape[0]).scatter_reduce(0, ids, slots, "amin")
    p = prim[prim >= 0].long()
    return int(((counts[ids[p]] == 2) & (first[ids[p]] == p)).sum())


def soup_scene(n_tris, seed, dev, order="sah", ties=False, light=False):
    """A random soup of n_tris triangles, its tree built in `order` ("sah"
    or bvh/build.py's "morton").  ties: every triangle twice, the copies in
    reverse order (a ray that hits one hits its copy at the same t: an exact
    tie, which the lowest slot wins).  light: an emitting quad above the
    soup and a camera in front of it (a scene K4 renders)."""
    from gpuspectral_tpu_torch.bsdf.table import diffuse
    from gpuspectral_tpu_torch.scene.data import SceneBuilder
    from gpuspectral_tpu_torch.scene.obj import make_rectangle

    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-2.0, 2.0, size=(n_tris, 1, 3))
            + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32)
    if ties:
        tris = np.concatenate([tris, tris[::-1]])
    b = SceneBuilder()
    b.add_object(tris, tris, None, np.eye(4, dtype=np.float32), b.add_bsdf(diffuse((0.5,) * 3)))
    if light:
        pos, nrm, uv = make_rectangle()
        b.add_object(pos, nrm, uv, np.array([[2, 0, 0, 0], [0, 0, -2, 3], [0, 2, 0, 0],
                                             [0, 0, 0, 1]], np.float32),
                     b.add_bsdf(diffuse((0.0,) * 3)), emission=(8.0, 8.0, 8.0))
        b.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 0.5], [0, 0, -1, 6], [0, 0, 0, 1]],
                              np.float32), np.deg2rad(60))
    return b.build(dev, order=order)


def bvh_cases(dev, scenes, field):
    """The BVH kernels' parity scenes: the sphere field, Cornell, the zoo, a
    2048-triangle soup and a slot-mode build of Cornell."""
    from gpuspectral_tpu_torch.bvh.tables import sah
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene

    old = sah.SLOT_DENSE_THRESHOLD
    sah.SLOT_DENSE_THRESHOLD = 8
    try:
        slot = load_mitsuba_scene(CORNELL, device=dev)[0]
    finally:
        sah.SLOT_DENSE_THRESHOLD = old
    return dict(sphere_field=field, **scenes, soup2048=soup_scene(2048, 7, dev), slot_mode=slot)


def walk_cases(dev, cases):
    """K3's parity scenes (bvh_cases) and two more builds: a morton build of
    a soup and a soup of exact-t twins."""
    return dict(cases, soup_morton=soup_scene(2048, 8, dev, order="morton"),
                soup_ties=soup_scene(1024, 9, dev, ties=True))


def phase_k3(dev, cases, field):
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.ops import cuda_isect as ci

    log("phase K3: ftb_closest / ftb_any vs ftb_closest_ref / ftb_any_ref")
    err = 0.0
    for i, (name, scene) in enumerate(walk_cases(dev, cases).items()):
        rays = field_rays(K3_RAYS["parity"], scene, 20 + i, dev)
        err = max(err, check_k3(name, scene, rays),
                  check_k3(name + " (NaN and inactive lanes)", scene, odd_lanes(rays)))

    # timing on the sphere field: K3 at 1M and 65,536 rays (device_ms), K2
    # over the same table, cut at its tri_rows, and rays (cuda_ms: seconds a
    # call), the plain version at 65,536; K3a given the attribute rows built
    # once, as the wavefront gives them
    times = {}
    attr = ftb.attr_table(field)
    for n in (K3_RAYS["timing"], K3_RAYS["parity"]):
        o, d, lo, hi = field_rays(n, field, 99, dev)
        w, zero = field.tri_woop_t, torch.zeros_like(lo)
        times[n] = dict(
            k3a=device_ms(lambda: ftb.ftb_closest(field, o, d, t_max=hi, attr=attr)),
            k3b=device_ms(lambda: ftb.ftb_any(field, o, d, lo, hi)),
            k2a=cuda_ms(lambda: ci.closest_cuda(o, d, w, zero, hi, field.tri_rows), reps=1),
            k2b=cuda_ms(lambda: ci.any_cuda(o, d, w, lo, hi, field.tri_rows), reps=1))
        if n == K3_RAYS["parity"]:
            times[n]["k3a_plain"] = cuda_ms(lambda: ftb.ftb_closest_ref(field, o, d, t_max=hi),
                                            reps=1)
            times[n]["k3b_plain"] = cuda_ms(lambda: ftb.ftb_any_ref(field, o, d, lo, hi), reps=1)
            with WalkTally(field.num_tris) as k3a_tally:
                ftb.ftb_closest(field, o, d, t_max=hi)
            with WalkTally(field.num_tris) as k3b_tally:
                ftb.ftb_any(field, o, d, lo, hi)
        log(f"  sphere field, {n} rays: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times[n].items()))
    n = K3_RAYS["parity"]
    for tag, t in (("closest", k3a_tally), ("any", k3b_tally)):
        log(f"  K3 {tag} on {n} random rays: the counting walk {t.box / n:.2f} box and "
            f"{t.woop / n:.2f} Woop tests per ray, K3's own walk {t.walk_box / n:.2f} and "
            f"{t.walk_woop / n:.2f}; operations per ray {t.ops / n:.1f}")
    o, d, lo, hi = primary_rays(field, HEADLINE["size"], dev)
    times["primary"] = dict(k3a=device_ms(lambda: ftb.ftb_closest(field, o, d, t_max=hi,
                                                                  attr=attr)),
                            k3b=device_ms(lambda: ftb.ftb_any(field, o, d, lo, hi)))
    log(f"  sphere field, {o.shape[0]} primary rays: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times["primary"].items()))
    tb = nbytes(*bvh_tables(field))
    times["bounds"] = dict(k3a=bound(k3a_tally.flops(shade=False), n * (28 + 16) + tb),
                           k3b=bound(k3b_tally.flops(shade=False), n * (32 + 1) + tb))
    return err, times


def wavefront_rows(scene, cfg, pix, ts):
    """The torch wavefront on K3 over K4's pixel rows, shading textures by
    K4's per-corner blend (no light-pick sharing or ray sorting)."""
    from gpuspectral_tpu_torch.integrator import path_tracer

    wcfg = cfg.replace(intersector="pallas", light_block=0, sort_rays=False)
    st = path_tracer.trace_wavefront(scene, wcfg, pix.reshape(-1), ts, tex_mode="corners")
    return st["radiance"] / cfg.spp, float(st["rays_traced"].double().sum())


def phase_env(dev):
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import _sky
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase env: K1 and K4 with an environment emitter vs the wavefront")
    err = dict(k1=0.0, k4=0.0)
    for env_name, image in (("constant", np.full((1, 1, 3), 0.8, np.float32)),
                            ("sky32x64", _sky(32, 64))):
        b = load_mitsuba_scene(CORNELL, build=False)
        b.set_envmap(image)
        scene = b.build(dev)
        for key, use_bvh in (("k1", False), ("k4", True)):
            cfg = RenderConfig(width=64, height=64, spp=2, max_depth=3, ray_batch=4096,
                               use_bvh=use_bvh)
            reset_counts()
            got, rays_got = render_image_stats_auto(scene, cfg, 0)
            c = counts()
            ref, rays_ref = render_image_stats(scene, cfg, 0)
            torch.cuda.synchronize()
            if c[key] != 1:
                raise AssertionError(f"env {env_name}: {key} not launched: {c}")
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            dpx = np.abs(g - r).max(-1)
            rays_rel = abs(rays_got - rays_ref) / max(rays_ref, 1.0)
            log(f"  {key.upper()} cornell+{env_name}: pixels_off_2e-5={float(np.mean(dpx > 2e-5)):.5f} "
                f"max {dpx.max():.3g} mean {g.mean():.6f} vs {r.mean():.6f} "
                f"rays {rays_got:.0f} vs {rays_ref:.0f}")
            if not (np.isfinite(g).all() and np.allclose(g, r, atol=2e-5) and rays_rel < 0.01):
                raise AssertionError(f"env {env_name}: {key} vs wavefront outside the gates")
            err[key] = max(err[key], float(dpx.max()))
    return err


def phase_k4(dev, scenes):
    from gpuspectral_tpu_torch.integrator import mega_bvh
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase K4: fused-BVH megakernel vs the wavefront on K3")
    cases = dict(scenes, sphere_field_small=build_sphere_field(dev, n_side=2, segs=16, rings=8),
                 cornell_slot=slot_mode(lambda: load_mitsuba_scene(CORNELL, device=dev)[0]),
                 soup_morton=soup_scene(1024, 5, dev, order="morton", light=True),
                 soup_ties=soup_scene(1024, 5, dev, ties=True, light=True))
    pix = torch.arange(64 * 64, dtype=torch.int32, device=dev).reshape(-1, 128)
    err = 0.0
    for name, scene in cases.items():
        for tag, kw in (("emission-only", dict(max_depth=0, nee=False, spp=1)),
                        ("full", dict(max_depth=4, spp=2)),
                        ("power+exact", dict(max_depth=4, spp=2, light_sampling="power",
                                             mis_mode="exact"))):
            cfg = RenderConfig(width=64, height=64, use_bvh=True, **kw)
            reset_counts()
            out = mega_bvh.render_mega_bvh_rows(scene, cfg, pix, 0)
            ref, rays_ref = wavefront_rows(scene, cfg, pix, 0)
            c = counts()
            torch.cuda.synchronize()
            if c["k4"] != 1 or c["k3a"] < 1:
                raise AssertionError(f"{name} {tag}: launch counts {c}")
            got = torch.stack(out[:3], -1).reshape(-1, 3) / cfg.spp
            rays_got = float(out[3].double().sum())
            if tag == "power+exact":
                d = (got - ref).abs().amax(-1)
                frac = float((d > 1e-4).double().mean())
                log(f"  {name} power+exact: pixels_off_1e-4={frac:.5f}")
                if frac > 0.008:
                    raise AssertionError(f"{name} power+exact: K4 vs wavefront outside the gates")
            err = max(err, compare_images(f"{name} {tag}", got.reshape(64, 64, 3),
                                          ref.reshape(64, 64, 3), rays_got, rays_ref,
                                          emission_only=tag == "emission-only"))
    return err


def plain_leg(plain, scene, cfg, pix, ts):
    """A plain version on a few pixel rows of a BVH frame: timed at 4 spp,
    run at cfg.spp when that fits PLAIN_BUDGET_S, else at the most spp (a
    power of two) that does.  Returns (its result, the spp, its ms)."""
    t0 = time.perf_counter()
    ref = plain(scene, cfg.replace(spp=4), pix, ts)
    torch.cuda.synchronize()
    dt4 = time.perf_counter() - t0
    spp_cmp = 4
    while spp_cmp < cfg.spp and dt4 * (2 * spp_cmp) / 4 < PLAIN_BUDGET_S:
        spp_cmp *= 2
    log(f"  plain version at 4 spp on {pix.shape[0]} rows: {dt4:.2f} s; comparing at "
        f"{spp_cmp} spp")
    if spp_cmp == 4:
        return ref, 4, dt4 * 1e3
    t0 = time.perf_counter()
    ref = plain(scene, cfg.replace(spp=spp_cmp), pix, ts)
    torch.cuda.synchronize()
    return ref, spp_cmp, (time.perf_counter() - t0) * 1e3


def phase_bvh_main(dev):
    from gpuspectral_tpu_torch.cli.main import _build
    from gpuspectral_tpu_torch.integrator import mega_bvh
    from gpuspectral_tpu_torch.utils.bench import run_benchmark

    hs, spp, depth = HEADLINE["size"], HEADLINE["spp"], HEADLINE["depth"]
    log(f"phase bvh_main: sphere field {hs}x{hs}, {spp} spp, depth {depth} through "
        "run_benchmark (K4)")
    args = argparse.Namespace(
        scene=SPHERE_FIELD, size=f"{hs}x{hs}", spp=spp, depth=depth, no_nee=False, jitter=False,
        ray_batch=65536, bvh=None, bvh_kernel="ftb", light_block=None, packet_size=1024,
        intersector="auto", light_sampling="uniform", mis="reference", device=str(dev),
        warmup=1, iters=3,
    )
    reset_counts()
    result, img = run_benchmark(args, return_image=True)
    launches = counts()
    log("  headline: " + json.dumps(result))
    log(f"  launches in the sphere-field run_benchmark: {launches}")
    frames = max(1, args.warmup) + args.iters
    if launches != dict(NONE, k4=frames):
        raise AssertionError(f"sphere-field run: want K4 launched {frames} times and no other")
    a = img.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all() or a.mean() <= 0.0:
        raise AssertionError(f"sphere-field image bad: shape {a.shape}, mean {a.mean()}")

    scene, cfg = _build(args)
    log(f"  scene: {scene.num_tris} triangles, {scene.padded_tris} slots, "
        f"{scene.bvh_dfs_bounds.shape[1]} preorder nodes, {scene.bvh_bins} bins of "
        f"{scene.bvh_bin_slots}, textured={scene.has_textures}, "
        f"envmap {tuple(scene.envmap.shape[:2])}")
    ts = 100 + args.iters - 1
    n_rows = hs * hs // mega_bvh.LANES
    sub = torch.linspace(0, n_rows - 1, K4_ROWS, device=dev).round().to(torch.int32)
    pix = (sub[:, None] * mega_bvh.LANES
           + torch.arange(mega_bvh.LANES, dtype=torch.int32, device=dev)).contiguous()
    full = mega_bvh.render_mega_bvh_rows(scene, cfg, pix, ts)
    got_full = torch.stack(full[:3], -1).reshape(-1, 3) / spp
    if not torch.equal(img.reshape(-1, 3)[pix.reshape(-1).long()], got_full):
        raise AssertionError("sphere-field image rows differ from K4 on the same rows")

    ref, spp_cmp, ref_ms = plain_leg(mega_bvh.render_mega_bvh_rows_ref, scene, cfg, pix, ts)
    cfg_cmp = cfg.replace(spp=spp_cmp)
    out = mega_bvh.render_mega_bvh_rows(scene, cfg_cmp, pix, ts)
    k4_ms = cuda_ms(lambda: mega_bvh.render_mega_bvh_rows(scene, cfg_cmp, pix, ts), reps=2)
    got = torch.stack(out[:3], -1).reshape(-1, 3) / spp_cmp
    refi = torch.stack(ref[:3], -1).reshape(-1, 3) / spp_cmp
    rays_k4, rays_ref = float(out[3].double().sum()), float(ref[3].double().sum())
    k4_err = compare_images(
        f"K4 vs plain, {K4_ROWS} rows of the sphere-field frame (ts {ts}, {spp_cmp} spp)",
        got, refi, rays_k4, rays_ref, emission_only=False, mean_gate=SUB_MEAN_GATE,
        fine_gate=SUB_FINE_GATE)
    log(f"  K4 {k4_ms:.3f} ms vs plain {ref_ms:.3f} ms on those rows at {spp_cmp} spp "
        f"({rays_k4 / k4_ms / 1e3:.3f} vs {rays_ref / ref_ms / 1e3:.3f} Mrays/s)")
    # the main path's shape: one K4 launch over the whole frame
    _, frame_rays = mega_bvh.render_mega_bvh(scene, cfg, ts)
    k4_head_ms = cuda_ms(lambda: mega_bvh.render_mega_bvh(scene, cfg, ts), reps=2)
    frame_ms = result["seconds_per_frame"] * 1e3
    log(f"  K4 over the sphere-field frame: {k4_head_ms:.3f} ms of a {frame_ms:.3f} ms frame "
        f"(share {k4_head_ms / frame_ms:.3f}), {frame_rays:.0f} rays")
    head = f"sphere-field run_benchmark ({hs}x{hs}, {spp} spp, d{depth})"
    tally = tally_rows(scene, cfg_cmp, pix, ts)
    tables = nbytes(*mega_tables(scene, True))
    k4_bound = fused_bound(tally, frame_rays, hs * hs * (4 + 16) + tables)
    rows_bound = fused_bound(tally, rays_k4, pix.numel() * (4 + 16) + tables)
    log(f"  K4 frame bound {k4_bound['bound_ms']:.4f} ms ({k4_bound['bound_by']}): "
        f"K4 at {k4_bound['bound_ms'] / k4_head_ms:.5f} of it")
    return dict(launches=launches["k4"], launched_by=head, max_abs_err=k4_err, ms=k4_head_ms,
                timed_call=f"one launch over the {hs}x{hs} frame at {spp} spp, d{depth}",
                frame_rays=frame_rays, plain_ms=ref_ms,
                plain_call=f"{K4_ROWS} pixel rows at {spp_cmp} spp", ms_rows=k4_ms,
                bound_ms_rows=rows_bound["bound_ms"], **k4_bound,
                spp_compared=spp_cmp, share_of_frame=k4_head_ms / frame_ms,
                mrays_per_s=result["mrays_per_s"]), scene, cfg, float(img.mean())


def phase_bvh_wavefront(scene, cfg, k4_mean):
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto

    hs = cfg.width
    log(f"phase bvh_wavefront: sphere field {hs}x{hs}, 1 spp, d{cfg.max_depth}, "
        "intersector pallas (wavefront on K3)")
    cfg_w = cfg.replace(spp=1, intersector="pallas")
    reset_counts()
    t0 = time.perf_counter()
    img, rays = render_image_stats_auto(scene, cfg_w, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = counts()
    log(f"  {dt:.3f} s, rays {rays:.0f}, {rays / dt / 1e6:.3f} Mrays/s; launches {c}")
    if c["k3a"] < 1 or c["k3b"] < 1 or c["k4"] != 0 or c["k1"] != 0:
        raise AssertionError("sphere-field wavefront: want K3 launched and K4 / K1 not")
    a = img.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all():
        raise AssertionError(f"wavefront image bad: shape {a.shape}")
    log(f"  image means: K4@{cfg.spp}spp {k4_mean:.5f}, wavefront@1spp {a.mean():.5f}")
    if abs(k4_mean - float(a.mean())) > 0.05 * k4_mean:
        raise AssertionError("K4 and wavefront images disagree in mean by > 5%")
    return c, f"sphere-field wavefront dispatch ({hs}x{hs}, 1 spp, d{cfg.max_depth})"


def timed_once(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events
    (the plain versions, too slow to repeat)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def votes_bound(scene, rays, votes, sn):
    """bound() of K7c for one call over `rays` (o, d and the segment [lo, hi]
    it votes on) that gave `votes`, and its counts.  Its operations are, pair
    by pair (block, supernode), the fewer of two counts of the same votes:
    the block's rays up to the first that passes (cluster_sweep.vote_tests)
    and K7c's schedule (cluster_sweep.bundle_vote_tests: a bundle test a warp
    with a live ray, a slab test a live ray of a warp whose bundle the
    supernode survives), whose votes must equal `votes`.  Bytes: the rays,
    the boxes and the votes."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs

    o, d, lo, hi = rays
    vt = cs.vote_tests(scene, o, d, lo, hi, supernodes=sn)
    bt = cs.bundle_vote_tests(scene, o, d, lo, hi, supernodes=sn)
    if not torch.equal(bt.votes, votes):
        raise AssertionError(f"bundle_vote_tests' votes disagree with K7c's on "
                             f"{int((bt.votes != votes).sum())} pairs")
    ops = torch.minimum(vt * SLAB_FLOPS, bt.bundle * BUNDLE_FLOPS + bt.exact * SLAB_FLOPS)
    n = o.shape[0]
    return dict(bound(float(ops.double().sum()),
                      n * 32 + nbytes(sn.blo[:, :sn.s], sn.bhi[:, :sn.s], votes)),
                box_per_ray=float(vt.double().sum()) / n,
                bundle_per_block=float(bt.bundle.double().sum(1).mean()),
                exact_per_ray=float(bt.exact.double().sum()) / n,
                skipped_warps_per_block=float(bt.skipped.double().mean()),
                live_rays=int(cs.live_rays(o, cs.inv_dir_nan(d), lo, hi).sum()))


def cluster_bounds(scene, rays, votes, votes_any, occ, prim):
    """bound() of K7c (votes_bound, on the closest rays' segments), K7d and
    K7e for one call each over `rays` with these votes (`occ` K7e's, `prim`
    K7d's).  K7d / K7e's
    operations are, ray by ray, the fewer of two counts of the same function:
    the block sweep's (cluster_sweep.sweep_tests: every voted slot for a ray
    with a non-empty segment, K7e up to the ray's first occluder) and the
    two-gate sweep's that the kernels make (cluster_sweep.gated_tests: a slab
    test per voted supernode and, in one the ray enters, per non-empty leaf
    cluster, a Woop test per slot of an entered cluster; K7e up to the first
    occluder).  Both counts' occlusion must equal K7e's `occ`.  Their bytes
    count the Woop rows of the slots the two-gate sweep tests (no row of an
    empty cluster) and, for K7d, the attribute rows of the triangles hit.
    Also the votes per block, the supernodes a warp sweeps and both counts'
    tests per ray."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
    from gpuspectral_tpu_torch.bvh import ftb

    o, d, lo, hi = rays
    zero = torch.zeros_like(hi)
    sn = cs.scene_supernodes(scene)
    k7c = votes_bound(scene, (o, d, zero, hi), votes, sn)
    sums, ops, rows = {}, {}, {}
    for key, seg_lo, v, any_hit in (("closest", zero, votes, False),
                                    ("any", lo, votes_any, True)):
        sweep, occ_sweep = cs.sweep_tests(scene, o, d, seg_lo, hi, v, any_hit, supernodes=sn)
        g = cs.gated_tests(scene, o, d, seg_lo, hi, v, any_hit, supernodes=sn)
        if any_hit:
            for what, got in (("sweep_tests", occ_sweep), ("gated_tests", g.occluded)):
                if not torch.equal(got, occ):
                    raise AssertionError(f"{what}' occlusion disagrees with K7e on "
                                         f"{int((got != occ).sum())} rays")
        rows[key] = int(g.slots.sum()) * 4 * scene.tri_woop.shape[1]
        ops[key] = float(torch.minimum(sweep * WOOP_FLOPS,
                                       g.slab * SLAB_FLOPS + g.woop * WOOP_FLOPS).double().sum())
        sums[key] = dict(sweep=float(sweep.double().sum()), slab=float(g.slab.double().sum()),
                         woop=float(g.woop.double().sum()),
                         warp=float(g.warp_supernodes.double().mean()))
    n = o.shape[0]
    vb = nbytes(votes)
    a = ftb.attr_table(scene).shape[1]
    hit_rows = int(torch.unique(prim[prim >= 0]).numel())
    return dict(
        k7c=k7c,
        k7d=bound(ops["closest"], n * (28 + 16 + 4 * a) + vb + rows["closest"]
                  + 4 * a * hit_rows),
        k7e=bound(ops["any"], n * (32 + 1) + vb + rows["any"]),
        votes_per_block=dict(closest=float(votes.double().sum(1).mean()),
                             any=float(votes_any.double().sum(1).mean())),
        supernodes_per_warp={k: v["warp"] for k, v in sums.items()},
        box_per_ray=k7c["box_per_ray"], woop_per_ray={k: v["sweep"] / n for k, v in sums.items()},
        gated_per_ray={k: dict(slab=v["slab"] / n, woop=v["woop"] / n) for k, v in sums.items()})


def cluster_ptxas():
    """ptxas's registers and spills of K7c-e (csrc/cluster.cu), by kernel."""
    from gpuspectral_tpu_torch import _build

    out = {tag: line for kern, line in _build.build_info()["ptxas"].items()
           for tag in ("cluster_votes_kernel", "cluster_closest_kernel", "cluster_any_kernel")
           if f"{len(tag)}{tag}" in kern}
    log("  ptxas of the cluster kernels: " + json.dumps(out))
    if len(out) != 3:
        raise AssertionError(f"ptxas lines of K7c-e missing: {out}")
    return out


def binned_ptxas():
    """ptxas's registers, spills and stack of K7a / K7b (csrc/binned.cu),
    by key."""
    from gpuspectral_tpu_torch import _build

    out = {key: line for kern, line in _build.build_info()["ptxas"].items()
           for key, tag in (("k7a", "binned_closest_kernel"), ("k7b", "binned_any_kernel"))
           if f"{len(tag)}{tag}" in kern}
    log("  ptxas of the binned kernels: " + json.dumps(out))
    if len(out) != 2:
        raise AssertionError(f"ptxas lines of K7a / K7b missing: {out}")
    return out


def dfs_ptxas():
    """ptxas's registers and spills of K7f / K7g (csrc/dfs.cu), by key;
    raises if one spills."""
    from gpuspectral_tpu_torch import _build

    out = {key: line for kern, line in _build.build_info()["ptxas"].items()
           for key, tag in (("k7f", "dfs_closest_kernel"), ("k7g", "dfs_any_kernel"))
           if f"{len(tag)}{tag}" in kern}
    log("  ptxas of the dfs kernels: " + json.dumps(out))
    if len(out) != 2:
        raise AssertionError(f"ptxas lines of K7f / K7g missing: {out}")
    spills = {k: v for k, v in out.items() if " 0 bytes spill stores, 0 bytes spill loads" not in v}
    if spills:
        raise AssertionError(f"K7f / K7g spill: {spills}")
    return out


def check_k7(name, scene, rays):
    """K7c / K7d / K7e against their plain versions on `rays`: votes equal
    (also on odd_lanes(rays), where a NaN lane votes for nothing, and on
    sparse_lanes(rays), ~5% of the lanes live), t, prim,
    u, v, attrs and occ equal.  Returns (the max abs errors, the
    kernels' votes for the closest and the any-hit segments, the plain
    versions' ms)."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs

    o, d, lo, hi = rays
    zero = torch.zeros_like(hi)
    sn = cs.scene_supernodes(scene)
    votes = cs.cluster_votes(scene, o, d, zero, hi, supernodes=sn)
    votes_any = cs.cluster_votes(scene, o, d, lo, hi, supernodes=sn)
    got = cs.cluster_closest(scene, o, d, t_max=hi, votes=votes, supernodes=sn)
    occ = cs.cluster_any(scene, o, d, lo, hi, votes=votes_any, supernodes=sn)
    vr, c_ms = timed_once(lambda: cs.cluster_votes_ref(scene, o, d, zero, hi, supernodes=sn))
    vr_any = cs.cluster_votes_ref(scene, o, d, lo, hi, supernodes=sn)
    # F17: lanes with a NaN origin or direction component vote for nothing
    def votes_bad(rs):
        return sum(int((cs.cluster_votes(scene, *rs[:2], seg, rs[3], supernodes=sn)
                        != cs.cluster_votes_ref(scene, *rs[:2], seg, rs[3], supernodes=sn)).sum())
                   for seg in (zero, rs[2]))

    odd_bad = votes_bad(odd_lanes(rays))
    sparse_bad = votes_bad(sparse_lanes(rays))
    ref, d_ms = timed_once(lambda: cs.cluster_closest_ref(scene, o, d, t_max=hi, votes=vr,
                                                          supernodes=sn))
    occ_r, e_ms = timed_once(lambda: cs.cluster_any_ref(scene, o, d, lo, hi, votes=vr_any,
                                                        supernodes=sn))
    bad = {k: int((a != b).sum()) for k, a, b in (
        ("votes", votes, vr), ("votes_any", votes_any, vr_any), ("t", got[0], ref[0]),
        ("prim", got[1], ref[1]), ("u", got[2], ref[2]), ("v", got[3], ref[3]),
        ("attrs", got[4], ref[4]), ("occ", occ, occ_r))}
    bad["votes_odd_lanes"] = odd_bad
    bad["votes_sparse_lanes"] = sparse_bad
    hit = ref[1] >= 0
    log(f"  K7 {name}: rays={o.shape[0]} supernodes={votes.shape[1]} "
        f"votes per block {float(votes.double().sum(1).mean()):.1f} (any "
        f"{float(votes_any.double().sum(1).mean()):.1f}) hits={int(hit.sum())} "
        f"occluded={int(occ_r.sum())} mismatches={bad}")
    if any(bad.values()):
        raise AssertionError(f"K7 disagrees with its plain version on {name}")
    err = dict(k7c=float(max((votes - vr).abs().max(), (votes_any - vr_any).abs().max())),
               k7d=float((got[0] - ref[0]).abs()[hit].max()) if hit.any() else 0.0,
               k7e=float((occ.int() - occ_r.int()).abs().max()))
    return err, votes, votes_any, dict(k7c=c_ms, k7d=d_ms, k7e=e_ms)


def check_sweep(name, scene, rays, keys, fns, tables):
    """A closest-hit and any-hit kernel pair (`keys`, e.g. ("k7f", "k7g");
    `fns` = (closest, any hit, their plain versions)) against the plain
    versions on `rays`: t, prim, u, v, attrs and occ equal.  `tables` names
    the scene's tables in the log.  Returns (the max abs errors, the plain
    versions' ms)."""
    closest, any_hit, closest_ref, any_ref = fns
    o, d, lo, hi = rays
    got = closest(scene, o, d, t_max=hi)
    occ = any_hit(scene, o, d, lo, hi)
    ref, c_ms = timed_once(lambda: closest_ref(scene, o, d, t_max=hi))
    occ_r, a_ms = timed_once(lambda: any_ref(scene, o, d, lo, hi))
    bad = {k: int((a != b).sum()) for k, a, b in (
        ("t", got[0], ref[0]), ("prim", got[1], ref[1]), ("u", got[2], ref[2]),
        ("v", got[3], ref[3]), ("attrs", got[4], ref[4]), ("occ", occ, occ_r))}
    hit = ref[1] >= 0
    label = f"{keys[0].upper()} / {keys[1].upper()}"
    log(f"  {label} {name}: rays={o.shape[0]} {tables} hits={int(hit.sum())} "
        f"occluded={int(occ_r.sum())} mismatches={bad}")
    if any(bad.values()):
        raise AssertionError(f"{label} disagree with their plain versions on {name}")
    err = {keys[0]: float((got[0] - ref[0]).abs()[hit].max()) if hit.any() else 0.0,
           keys[1]: float((occ.int() - occ_r.int()).abs().max())}
    return err, {keys[0]: c_ms, keys[1]: a_ms}


def dfs_bounds(scene, rays, occ, closest):
    """bound() of K7f (on (0, t_max)) and K7g for one call each over `rays`
    (`occ` K7g's occlusion, `closest` K7f's (t, prim)).  A ray's operations
    are the fewer of two counts of the same walk: the block sweep's
    (dfs_sweep.dfs_tests: a slab test per node its block visits, at an
    entered leaf K7f's Woop tests of every slot for a ray with a segment,
    K7g's up to the ray's first occluder) and the two-gate walk's that the
    kernels make (dfs_sweep.gated_tests: the same node tests, a slab test
    per non-empty cluster of an entered leaf for a ray still searching, the
    Woop tests of the clusters its own widened test enters), a box test at
    SLAB_FLOPS.  Both counts' results must equal the kernels'.  Bytes: the
    rays in and out, the node rows some warp reads, the leaf clusters'
    boxes, the Woop rows of the slots some ray tests and K7f's attribute
    rows of the triangles hit.  Also the block sweep's bound alone (`block`:
    every slot of every leaf entered, the whole tables read) and both
    counts' tests per ray."""
    from gpuspectral_tpu_torch.bvh import dfs_sweep as ds
    from gpuspectral_tpu_torch.bvh import ftb

    o, d, lo, hi = rays
    n = o.shape[0]
    a = ftb.attr_table(scene).shape[1]
    zero = torch.zeros_like(hi)
    tables = nbytes(scene.bvh_dfs_bounds, scene.bvh_dfs_meta, scene.tri_woop_t)
    node_bytes = 4 * (scene.bvh_dfs_bounds.shape[0] + scene.bvh_dfs_meta.shape[0])
    leaf_boxes = 4 * 6 * scene.bvh_clusters
    ray_bytes = dict(closest=n * (28 + 16 + 4 * a), any=n * (32 + 1))
    hit_rows = int(torch.unique(closest[1][closest[1] >= 0]).numel())
    out, block, per_ray = {}, {}, {}
    for key, seg_lo, any_hit in (("k7f", zero, False), ("k7g", lo, True)):
        box, woop, res = ds.dfs_tests(scene, o, d, seg_lo, hi, any_hit)
        g = ds.gated_tests(scene, o, d, seg_lo, hi, any_hit)
        for what, got in (("dfs_tests", res), ("gated_tests", g.result)):
            same = (torch.equal(got, occ) if any_hit else
                    torch.equal(got[0], closest[0]) and torch.equal(got[1].int(), closest[1]))
            if not same:
                raise AssertionError(f"{what}' result disagrees with {key.upper()}'s")
        sweep_ops = box * SLAB_FLOPS + woop * WOOP_FLOPS
        gated_ops = (g.nodes + g.clusters) * SLAB_FLOPS + g.woop * WOOP_FLOPS
        ops = float(torch.minimum(sweep_ops, gated_ops).double().sum())
        rows = (int(g.node_rows.sum()) * node_bytes + leaf_boxes
                + int(g.slots.sum()) * 4 * scene.tri_woop.shape[1])
        kind = "any" if any_hit else "closest"
        attr_rows = 0 if any_hit else 4 * a * hit_rows
        out[key] = bound(ops, ray_bytes[kind] + rows + attr_rows)
        block[key] = bound(float(sweep_ops.double().sum()),
                           ray_bytes[kind] + tables + (0 if any_hit else 4 * a * scene.padded_tris))
        per_ray[kind] = dict(box=float(box.double().mean()), woop=float(woop.double().mean()),
                             gated_nodes=float(g.nodes.double().mean()),
                             gated_clusters=float(g.clusters.double().mean()),
                             gated_woop=float(g.woop.double().mean()))
    return dict(out, block=block,
                box_per_ray={k: v["box"] for k, v in per_ray.items()},
                woop_per_ray={k: v["woop"] for k, v in per_ray.items()},
                gated_per_ray={k: dict(node=v["gated_nodes"], cluster=v["gated_clusters"],
                                       woop=v["gated_woop"]) for k, v in per_ray.items()})


def binned_bounds(scene, rays, occ, prim):
    """bound() of K7a (on (0, t_max)) and K7b for one call each over `rays`.
    A ray's operations are the fewer of two counts of the same function:
    the block sweep's (binned.binned_tests: a slab test per bin, K7b up to
    the bin of the ray's first occluder, and the Woop tests of the slots of
    the ray's voted bins, K7b up to that occluder) and the walk's that the
    kernels make (binned.binned_walk_tests: two box tests a pair row, a
    slab test a bin vote made, the Woop tests of the clusters tested), a
    box test or vote at SLAB_FLOPS.  Both counts' results must equal the
    kernels' (`prim` K7a's, `occ` K7b's).  Bytes: the rays in and out, the
    pair rows, the bin rows and the Woop rows of the clusters the walk
    tests.  Also both counts' tests per ray and the bins a block of the
    block sweep visits per ray."""
    from gpuspectral_tpu_torch.bvh import binned as bn

    o, d, lo, hi = rays
    n = o.shape[0]
    leaf, n_slots = scene.bvh_leaf_size, scene.tri_woop.shape[0]
    ops, rows, sweep, walk, visits = {}, {}, {}, {}, {}
    for key, seg_lo, any_hit in (("closest", torch.zeros_like(hi), False), ("any", lo, True)):
        box, woop, visit, res = bn.binned_tests(scene, o, d, seg_lo, hi, any_hit)
        w = bn.binned_walk_tests(scene, o, d, seg_lo, hi, any_hit)
        want = occ if any_hit else prim
        for what, got in (("binned_tests", res if any_hit else res[1]),
                          ("binned_walk_tests", w.result)):
            if not torch.equal(got.to(want.dtype), want):
                raise AssertionError(f"{what}' result disagrees with the kernel's on "
                                     f"{int((got.to(want.dtype) != want).sum())} rays ({key})")
        ops[key] = float(torch.minimum(box * SLAB_FLOPS + woop * WOOP_FLOPS,
                                       (w.boxes + w.votes).long() * SLAB_FLOPS
                                       + w.woops.long() * WOOP_FLOPS).double().sum())
        c = torch.nonzero(w.clusters)[:, 0]
        rows[key] = int((torch.clamp(n_slots - c * leaf, 0, leaf)).sum()) * 4 * 12
        sweep[key] = dict(box=float(box.double().mean()), woop=float(woop.double().mean()))
        walk[key] = dict(box=float(w.boxes.double().mean()), vote=float(w.votes.double().mean()),
                         woop=float(w.woops.double().mean()))
        visits[key] = float(visit.double().mean())
    tables = nbytes(scene.bvh_pairs, bn.bin_rows(scene))
    return dict(
        k7a=bound(ops["closest"], n * (28 + 16) + tables + rows["closest"]),
        k7b=bound(ops["any"], n * (32 + 1) + tables + rows["any"]),
        box_per_ray={k: v["box"] for k, v in sweep.items()},
        woop_per_ray={k: v["woop"] for k, v in sweep.items()},
        visits_per_ray=visits, walk_per_ray=walk)


def primary_rays(scene, size, dev):
    """The camera rays of a size x size frame at timestamp 0, pixel order."""
    from gpuspectral_tpu_torch.integrator import path_tracer
    from gpuspectral_tpu_torch.ops import rng
    from gpuspectral_tpu_torch.utils import RenderConfig

    pix = torch.arange(size * size, dtype=torch.int64, device=dev)
    cfg = RenderConfig(width=size, height=size)
    o, d = path_tracer._camera_rays(scene, cfg, rng.as_u32(pix),
                                    rng.pixel_seed(rng.as_u32(pix), 0))
    n = pix.shape[0]
    return [o.contiguous(), d.contiguous(), torch.full((n,), 0.01, device=dev),
            torch.full((n,), 1e30, device=dev)]


def phase_k7(dev, cases, field):
    """K7c-e, K7f / K7g and K7a / K7b against their plain versions on the
    five BVH scenes, then timed on the sphere field beside K3: 65,536 random
    rays and the 262,144 primary rays of the 512x512 frame, each call given
    the supernode tables and attribute rows built once, as the wavefront
    gives them."""
    from gpuspectral_tpu_torch.bvh import binned as bn
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
    from gpuspectral_tpu_torch.bvh import dfs_sweep as ds
    from gpuspectral_tpu_torch.bvh import ftb

    log("phase k7: cluster_votes / cluster_closest / cluster_any, dfs_closest / dfs_any and "
        "binned_closest / binned_any vs their plain versions")
    err = dict(k7c=0.0, k7d=0.0, k7e=0.0, k7f=0.0, k7g=0.0, k7a=0.0, k7b=0.0)
    for i, (name, scene) in enumerate(cases.items()):
        rays = field_rays(K3_RAYS["parity"], scene, 20 + i, dev)
        e, votes, votes_any, plain = check_k7(name, scene, rays)
        fns_fg = (ds.dfs_closest, ds.dfs_any, ds.dfs_closest_ref, ds.dfs_any_ref)
        tables_fg = f"nodes={scene.bvh_dfs_bounds.shape[1]}"
        e_fg, plain_fg = check_sweep(name, scene, rays, ("k7f", "k7g"), fns_fg, tables_fg)
        e_fg_odd, _ = check_sweep(name + " (NaN and inactive lanes)", scene, odd_lanes(rays),
                                  ("k7f", "k7g"), fns_fg, tables_fg)
        e_fg = {k: max(e_fg[k], e_fg_odd[k]) for k in e_fg}
        fns_ab = (bn.binned_closest, bn.binned_any, bn.binned_closest_ref, bn.binned_any_ref)
        tables_ab = f"bins={scene.bvh_bins}x{scene.bvh_bin_slots}"
        e_ab, plain_ab = check_sweep(name, scene, rays, ("k7a", "k7b"), fns_ab, tables_ab)
        e_odd, _ = check_sweep(name + " (NaN and inactive lanes)", scene, odd_lanes(rays),
                               ("k7a", "k7b"), fns_ab, tables_ab)
        e.update(e_fg, **{k: max(e_ab[k], e_odd[k]) for k in e_ab})
        err = {k: max(err[k], e[k]) for k in err}
        if name == "sphere_field":
            field_votes, field_votes_any = votes, votes_any
            plain_ms = dict(plain, **plain_fg, **plain_ab)
    out = {}
    # built once, as the wavefront builds them, so that the times are the kernels'
    sn, attr = cs.scene_supernodes(field), ftb.attr_table(field)
    log(f"  ftb.attr_table of the sphere field, outside the timed calls: "
        f"{cuda_ms(lambda: ftb.attr_table(field), reps=5):.3f} ms")
    for tag, rays, votes, votes_any in (
            ("random", field_rays(K3_RAYS["parity"], field, 20, dev), field_votes, field_votes_any),
            ("primary", primary_rays(field, HEADLINE["size"], dev), None, None)):
        o, d, lo, hi = rays
        zero = torch.zeros_like(hi)
        if votes is None:
            votes = cs.cluster_votes(field, o, d, zero, hi, supernodes=sn)
            votes_any = cs.cluster_votes(field, o, d, lo, hi, supernodes=sn)
        occ = cs.cluster_any(field, o, d, lo, hi, votes=votes_any, supernodes=sn)
        prim = cs.cluster_closest(field, o, d, t_max=hi, votes=votes, supernodes=sn)[1]
        times = dict(
            k7c=device_ms(lambda: cs.cluster_votes(field, o, d, zero, hi, supernodes=sn)),
            k7d=device_ms(lambda: cs.cluster_closest(field, o, d, t_max=hi, attr=attr,
                                                     votes=votes, supernodes=sn)),
            k7e=device_ms(lambda: cs.cluster_any(field, o, d, lo, hi, votes=votes_any,
                                                 supernodes=sn)),
            k7f=device_ms(lambda: ds.dfs_closest(field, o, d, t_max=hi, attr=attr)),
            k7g=device_ms(lambda: ds.dfs_any(field, o, d, lo, hi)),
            k7a=device_ms(lambda: bn.binned_closest(field, o, d, t_max=hi, attr=attr)),
            k7b=device_ms(lambda: bn.binned_any(field, o, d, lo, hi)),
            k3a=device_ms(lambda: ftb.ftb_closest(field, o, d, t_max=hi, attr=attr)),
            k3b=device_ms(lambda: ftb.ftb_any(field, o, d, lo, hi)))
        b = cluster_bounds(field, rays, votes, votes_any, occ, prim)
        b_fg = dfs_bounds(field, rays, ds.dfs_any(field, o, d, lo, hi),
                          ds.dfs_closest(field, o, d, t_max=hi, attr=attr)[:2])
        b_ab = binned_bounds(field, rays, bn.binned_any(field, o, d, lo, hi),
                             bn.binned_closest(field, o, d, t_max=hi, attr=attr)[1])
        log(f"  sphere field, {o.shape[0]} {tag} rays: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
            + f"; votes per block {b['votes_per_block']}, supernodes a warp sweeps "
            + f"{b['supernodes_per_warp']}, box tests per ray {b['box_per_ray']:.2f}, Woop "
            + f"tests per ray of the block sweep {b['woop_per_ray']}, the two-gate sweep's "
            + f"slab and Woop tests per ray {b['gated_per_ray']}; "
            + f"dfs box tests per ray {b_fg['box_per_ray']}, Woop tests per ray "
            + f"{b_fg['woop_per_ray']}, K7f / K7g's two-gate walk's node, cluster and Woop "
            + f"tests per ray {b_fg['gated_per_ray']}, the block sweep's bound "
            + ", ".join(f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
                        for k, v in b_fg["block"].items())
            + f"; binned block sweep's box tests per ray {b_ab['box_per_ray']}, Woop tests per ray {b_ab['woop_per_ray']}, bins a block "
            + f"visits per ray {b_ab['visits_per_ray']}, K7a / K7b's walk's box tests, votes "
            + f"and Woop tests per ray {b_ab['walk_per_ray']}; "
            + ", ".join(f"{k} bound {bb[k]['bound_ms']:.4f} ms ({bb[k]['bound_by']})"
                        for bb, ks in ((b, ("k7c", "k7d", "k7e")), (b_fg, ("k7f", "k7g")),
                                       (b_ab, ("k7a", "k7b")))
                        for k in ks))
        out[tag] = dict(times=times, bounds=dict(b, **{k: b_fg[k] for k in ("k7f", "k7g")},
                                                 **{k: b_ab[k] for k in ("k7a", "k7b")},
                                                 dfs=b_fg, binned=b_ab), rays=o.shape[0])
    # K7c on a batch of the random rays with ~5% of the lanes live, scattered
    o, d, lo, hi = sparse_lanes(field_rays(K3_RAYS["parity"], field, 20, dev))
    zero = torch.zeros_like(hi)
    votes = cs.cluster_votes(field, o, d, zero, hi, supernodes=sn)
    if not torch.equal(votes, cs.cluster_votes_ref(field, o, d, zero, hi, supernodes=sn)):
        raise AssertionError("K7c disagrees with its plain version on the sparse batch")
    sparse = dict(ms=device_ms(lambda: cs.cluster_votes(field, o, d, zero, hi, supernodes=sn)),
                  **votes_bound(field, (o, d, zero, hi), votes, sn))
    log(f"  sphere field, {o.shape[0]} random rays, {sparse['live_rays']} of them live: "
        f"k7c {sparse['ms']:.3f} ms, bound {sparse['bound_ms']:.4f} ms ({sparse['bound_by']})")
    for tag, b in (("random", out["random"]["bounds"]["k7c"]),
                   ("primary", out["primary"]["bounds"]["k7c"]), ("sparse", sparse)):
        log(f"  K7c on the {tag} rays: per block {b['bundle_per_block']:.1f} bundle tests "
            f"(a live warp's, a supernode each), {b['skipped_warps_per_block']:.2f} warps "
            f"skipped; {b['exact_per_ray']:.2f} exact slab tests per ray against "
            f"{b['box_per_ray']:.2f} of the block's rays tested in turn")
    ptxas = cluster_ptxas()
    if " 0 bytes spill stores, 0 bytes spill loads" not in ptxas["cluster_votes_kernel"]:
        raise AssertionError(f"K7c spills: {ptxas['cluster_votes_kernel']}")
    ptxas = dict(k7c=ptxas["cluster_votes_kernel"], k7d=ptxas["cluster_closest_kernel"],
                 k7e=ptxas["cluster_any_kernel"], **binned_ptxas(), **dfs_ptxas())
    rows = {}
    for key, k3 in (("k7c", None), ("k7d", "k3a"), ("k7e", "k3b"), ("k7f", "k3a"),
                    ("k7g", "k3b"), ("k7a", "k3a"), ("k7b", "k3b")):
        r, p = out["random"], out["primary"]
        rows[key] = dict(max_abs_err=err[key], ms=r["times"][key], plain_ms=plain_ms[key],
                         **r["bounds"][key], rays=r["rays"], ms_primary=p["times"][key],
                         bound_ms_primary=p["bounds"][key]["bound_ms"],
                         primary_rays=p["rays"])
        if key == "k7c":
            rows[key].update(ptxas=ptxas[key], ms_sparse=sparse["ms"],
                             bound_ms_sparse=sparse["bound_ms"],
                             live_rays_sparse=sparse["live_rays"],
                             **{f"{k}{t}": b[k] for t, b in (("", r["bounds"]["k7c"]),
                                                             ("_primary", p["bounds"]["k7c"]),
                                                             ("_sparse", sparse))
                                for k in ("box_per_ray", "bundle_per_block", "exact_per_ray",
                                          "skipped_warps_per_block")})
        if key in ("k7f", "k7g", "k7a", "k7b"):
            fam = "dfs" if key in ("k7f", "k7g") else "binned"
            rows[key].update(k3_ms=r["times"][k3], k3_ms_primary=p["times"][k3],
                             box_per_ray=r["bounds"][fam]["box_per_ray"],
                             box_per_ray_primary=p["bounds"][fam]["box_per_ray"],
                             woop_per_ray=r["bounds"][fam]["woop_per_ray"],
                             woop_per_ray_primary=p["bounds"][fam]["woop_per_ray"])
            if fam == "dfs":
                rows[key].update(ptxas=ptxas[key],
                                 gated_per_ray=r["bounds"][fam]["gated_per_ray"],
                                 gated_per_ray_primary=p["bounds"][fam]["gated_per_ray"],
                                 bound_ms_block=r["bounds"][fam]["block"][key]["bound_ms"],
                                 bound_ms_block_primary=p["bounds"][fam]["block"][key]["bound_ms"])
            if fam == "binned":
                rows[key].update(visits_per_ray=r["bounds"][fam]["visits_per_ray"],
                                 visits_per_ray_primary=p["bounds"][fam]["visits_per_ray"],
                                 walk_per_ray=r["bounds"][fam]["walk_per_ray"],
                                 walk_per_ray_primary=p["bounds"][fam]["walk_per_ray"],
                                 ptxas=ptxas[key])
        elif k3:
            rows[key].update(k3_ms=r["times"][k3], k3_ms_primary=p["times"][k3], ptxas=ptxas[key],
                             **{f"{k}{tag}": x["bounds"][k]
                                for tag, x in (("", r), ("_primary", p))
                                for k in ("votes_per_block", "supernodes_per_warp",
                                          "woop_per_ray", "gated_per_ray")})
    return rows


def odd_lanes(rays, seed=4):
    """The rays with NaN directions, NaN origins, zero direction components
    and inactive lanes (t_max = -1e30) mixed in."""
    o, d, lo, hi = (x.clone() for x in rays)
    k = torch.as_tensor(np.random.default_rng(seed).uniform(size=o.shape[0]), device=o.device)
    d[k < 0.02, 1] = float("nan")
    o[(k >= 0.02) & (k < 0.04), 0] = float("nan")
    d[(k >= 0.04) & (k < 0.06), 2] = 0.0
    hi[(k >= 0.06) & (k < 0.15)] = -1e30
    return o, d, lo, hi


def sparse_lanes(rays, share=0.05, seed=6):
    """The rays with all but about `share` of the lanes inactive (t_max =
    -1e30), the live ones scattered, as in the wavefront's late bounces."""
    o, d, lo, hi = (x.clone() for x in rays)
    k = torch.as_tensor(np.random.default_rng(seed).uniform(size=o.shape[0]), device=o.device)
    hi[k >= share] = -1e30
    return o, d, lo, hi


def traverse_tree(scene):
    """The tables of K7h's wrappers: the packed leaf rows, the node boxes,
    n_levels."""
    from gpuspectral_tpu_torch.bvh import kernels

    return (kernels.pack_tris(scene.tri_pos, scene.bvh_clusters, scene.bvh_leaf_size),
            scene.bvh_node_min.contiguous(), scene.bvh_node_max.contiguous(), scene.bvh_levels)



def check_traverse(name, scene, rays, packet, timed=False):
    """traverse_closest / traverse_any against their plain versions on
    `rays` in packets of `packet`: t, prim, u, v and occ equal, ties
    included; the closest hit on (0, t_max), the any hit on (t_min, t_max).
    Returns (the max abs errors, the plain closest hit's ms or None)."""
    from gpuspectral_tpu_torch.bvh import kernels
    from gpuspectral_tpu_torch.bvh import traverse

    o, d, lo, hi = rays
    zero = torch.zeros_like(hi)
    tree = traverse_tree(scene)
    got = kernels.traverse_closest(o, d, *tree, zero, hi, packet)
    occ = kernels.traverse_any(o, d, *tree, lo, hi, packet)
    ref, ms = timed_once(lambda: traverse.intersect_closest_bvh_ref(o, d, *tree, zero, hi, packet))
    occ_r = traverse.intersect_any_bvh_ref(o, d, *tree, lo, hi, packet)
    bad = {k: int((a != b).sum()) for k, a, b in (
        ("t", got[0], ref[0]), ("prim", got[1], ref[1]), ("u", got[2], ref[2]),
        ("v", got[3], ref[3]), ("occ", occ, occ_r))}
    hit = ref[1] >= 0
    log(f"  K7h {name}: rays={o.shape[0]} packet={packet} clusters={scene.bvh_clusters}x"
        f"{scene.bvh_leaf_size} hits={int(hit.sum())} occluded={int(occ_r.sum())} "
        f"mismatches={bad} (plain closest {ms / 1e3:.1f} s)")
    if any(bad.values()):
        raise AssertionError(f"K7h disagrees with its plain version on {name} at packet {packet}")
    return (float((got[0] - ref[0]).abs()[hit].max()) if hit.any() else 0.0,
            float((occ.int() - occ_r.int()).abs().max())), (ms if timed else None)


def traverse_bounds(scene, rays, k7h):
    """bound() of K7h's closest hit (on (0, t_max)) and any hit for one call
    each over `rays` at packets of 1024, from the tests the function needs
    (kernels.traverse_tests with skip_empty: PR 8's walk entering no empty
    subtree): a slab test per ray for each node its packet pops (any hit:
    while not occluded), and at each leaf the packet enters the leaf's
    Moller-Trumbore tests for each ray with a window (any hit: up to its
    first hit).  Both counts' results must equal K7h's `k7h` ((t, prim, u,
    v), occ).  Also the tests per ray, needed and made by PR 8's walk on
    the tree as built (K7h enters the needed leaves, so it makes the needed
    Moller-Trumbore tests; its slab tests are not counted)."""
    from gpuspectral_tpu_torch.bvh import kernels

    o, d, lo, hi = rays
    tree = traverse_tree(scene)
    per_ray, sums = {}, {}
    for skip in (True, False):
        box_c, mt_c, res_c = kernels.traverse_tests(o, d, *tree, torch.zeros_like(hi), hi,
                                                    False, skip_empty=skip)
        box_a, mt_a, res_a = kernels.traverse_tests(o, d, *tree, lo, hi, True, skip_empty=skip)
        if not (all(torch.equal(a, b) for a, b in zip(res_c, k7h[0]))
                and torch.equal(res_a, k7h[1])):
            raise AssertionError(f"K7h's tally (skip_empty={skip}) disagrees with K7h")
        sums[skip] = [float(x.double().sum()) for x in (box_c, mt_c, box_a, mt_a)]
        per_ray["needed" if skip else "pr8_walk"] = dict(
            slab=dict(closest=sums[skip][0] / o.shape[0], any=sums[skip][2] / o.shape[0]),
            mt=dict(closest=sums[skip][1] / o.shape[0], any=sums[skip][3] / o.shape[0]))
    n = o.shape[0]
    tables = nbytes(*tree[:3])
    need = sums[True]
    return dict(
        closest=bound(need[0] * SLAB_FLOPS + need[1] * MT_FLOPS, n * (32 + 16) + tables),
        any=bound(need[2] * SLAB_FLOPS + need[3] * MT_FLOPS, n * (32 + 1) + tables),
        tests_per_ray=per_ray)


TRAVERSE_PACKETS = (32, 1024)  # K7h's parity on every BVH scene; the soup also at 1, 96, 2048
TRAVERSE_FIELD_SMALL = 2048  # rays of the sphere field's parity at 32 (the plain walk is slow)
# The tests a ray needs on the sphere field at packets of 1024 (traverse_bounds'
# "needed", to the nearest whole test), as PR 8's runs counted them: the
# bound's yardstick, which no change to K7h may move.
NEEDED_TESTS = dict(random=dict(slab=dict(closest=1950, any=771), mt=dict(closest=4445, any=1754)),
                    primary=dict(slab=dict(closest=805, any=74), mt=dict(closest=3186, any=147)))


def traverse_ptxas():
    """ptxas's registers and spills of K7h (packet_kernel<rays a thread,
    CTAs a packet, any hit>) and of the counting walk, by kernel."""
    from gpuspectral_tpu_torch import _build

    out = {}
    for kern, line in _build.build_info()["ptxas"].items():
        for tag in ("packet_kernel", "count_kernel"):
            mangled = f"{len(tag)}{tag}I"  # csrc/traverse.cu's, not bvh.cu's bvh_count_kernel
            if mangled in kern:
                # the template arguments of the mangled name: ILi1ELi8ELb0EE -> 1,8,0
                args = kern.split(mangled, 1)[1].split("EE", 1)[0]
                out[tag + "<" + ",".join(x[-1] for x in args.split("E") if x) + ">"] = line
    return out


def walk_ptxas():
    """ptxas's registers, spills and stack of the kernels that take the walk
    of csrc/bvh.cuh (K3a / K3b and K4 / K6 with and without block-
    synchronous regeneration), by kernel; raises if K4 or K6 spills."""
    from gpuspectral_tpu_torch import _build

    out = {}
    for kern, line in _build.build_info()["ptxas"].items():
        for tag in ("mega_bvh_kernel", "mega_bvh_grad_kernel", "bvh_closest_kernel",
                    "bvh_any_kernel"):
            if f"{len(tag)}{tag}" in kern:
                sync = "<sync>" if "ILb1E" in kern else "<no sync>" if "ILb0E" in kern else ""
                out[tag + sync] = line
    log("  ptxas of the walk's kernels: " + json.dumps(out))
    spills = {k: v for k, v in out.items() if "mega" in k and "0 bytes spill stores" not in v}
    if len(out) != 6 or spills:
        raise AssertionError(f"K4 / K6 spill or are missing: {spills or out}")
    return out


def isect_ptxas():
    """ptxas's registers, spills and shared memory of K2a (closest_kernel)
    and K2b (any_kernel) of csrc/isect.cu; raises if either spills or is
    missing."""
    from gpuspectral_tpu_torch import _build

    out = {}
    for kern, line in _build.build_info()["ptxas"].items():
        for tag in ("closest_kernel", "any_kernel"):
            if "_isect_cu_" in kern and f"{len(tag)}{tag}E" in kern:
                out[tag] = line
    log("  ptxas of K2a / K2b: " + json.dumps(out))
    spills = {k: v for k, v in out.items() if "0 bytes spill stores" not in v}
    if len(out) != 2 or spills:
        raise AssertionError(f"K2a / K2b spill or are missing: {spills or out}")
    return out


def brute_ptxas():
    """ptxas's registers, spills and shared memory of K1 (mega_kernel) and
    K5 (mega_grad_kernel); raises if either spills or is missing."""
    from gpuspectral_tpu_torch import _build

    out = {}
    for kern, line in _build.build_info()["ptxas"].items():
        for tag in ("mega_kernel", "mega_grad_kernel"):
            if f"{len(tag)}{tag}" in kern:
                out[tag] = line
    log("  ptxas of K1 / K5: " + json.dumps(out))
    spills = {k: v for k, v in out.items() if "0 bytes spill stores" not in v}
    if len(out) != 2 or spills:
        raise AssertionError(f"K1 / K5 spill or are missing: {spills or out}")
    return out


def phase_k7h(dev, cases, field):
    """K7h against its plain versions on the five BVH scenes (NaN and
    inactive lanes mixed in, the sphere field at packets of 1024 on the
    clean random rays of the timing), then timed on the sphere field beside
    K3 on 65,536 random rays and the 262,144 primary rays of the 512x512
    frame, at the CLI's packets of 1024.  The plain version is timed once,
    on the random rays."""
    from gpuspectral_tpu_torch.bvh import ftb, kernels

    log("phase k7 (K7h): traverse_closest / traverse_any vs their plain versions")
    regs = traverse_ptxas()
    for kern, line in regs.items():
        log(f"  ptxas {kern}: {line}")
    shape = kernels.launch_shape(1024)
    log(f"  K7h at packets of 1024: {json.dumps(shape)}")
    err = (0.0, 0.0)
    plain_ms = None
    for i, (name, scene) in enumerate(cases.items()):
        rays = field_rays(K3_RAYS["parity"], scene, 20 + i, dev)
        packets = TRAVERSE_PACKETS + ((1, 96, 2048) if name == "soup2048" else ())
        for packet in packets:
            if name == "sphere_field" and packet == 1024:
                e, plain_ms = check_traverse(name, scene, rays, packet, timed=True)
            elif name == "sphere_field":
                small = [x[:TRAVERSE_FIELD_SMALL] for x in rays]
                e, _ = check_traverse(name + " (odd lanes)", scene, odd_lanes(small), packet)
            else:
                e, _ = check_traverse(name + " (odd lanes)", scene, odd_lanes(rays), packet)
            err = tuple(max(a, b) for a, b in zip(err, e))
    tree = traverse_tree(field)
    nodes = kernels.pack_nodes(*tree[1:3], tree[0])  # once, as the wavefront builds them
    attr = ftb.attr_table(field)  # for K3a, likewise
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for tag, rays in (("random", field_rays(K3_RAYS["parity"], field, 20, dev)),
                      ("primary", primary_rays(field, HEADLINE["size"], dev))):
        o, d, lo, hi = rays
        zero = torch.zeros_like(hi)
        times = dict(
            closest=device_ms(lambda: kernels.traverse_closest(o, d, *tree, zero, hi,
                                                               nodes=nodes)),
            any=device_ms(lambda: kernels.traverse_any(o, d, *tree, lo, hi, nodes=nodes)),
            closest_pr8=device_ms(lambda: kernels.traverse_tests(o, d, *tree, zero, hi, False),
                                  reps=3),
            any_pr8=device_ms(lambda: kernels.traverse_tests(o, d, *tree, lo, hi, True), reps=3),
            k3a=device_ms(lambda: ftb.ftb_closest(field, o, d, t_max=hi, attr=attr)),
            k3b=device_ms(lambda: ftb.ftb_any(field, o, d, lo, hi)))
        b = traverse_bounds(field, rays, (
            kernels.traverse_closest(o, d, *tree, zero, hi, nodes=nodes),
            kernels.traverse_any(o, d, *tree, lo, hi, nodes=nodes)))
        packets = -(-o.shape[0] // 1024)
        log(f"  sphere field, {o.shape[0]} {tag} rays: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
            + f"; tests per ray {json.dumps(b['tests_per_ray'])}; bound closest "
            + f"{b['closest']['bound_ms']:.4f} ms, any {b['any']['bound_ms']:.4f} ms; "
            + f"{packets} packets: {packets * shape['ctas_per_packet']} CTAs of "
            + f"{shape['threads_per_cta']} threads (clusters of {shape['ctas_per_packet']}) "
            + f"for {sms} SMs")
        need = b["tests_per_ray"]["needed"]
        for kind, want in NEEDED_TESTS[tag].items():
            for hit, n in want.items():
                if abs(need[kind][hit] - n) > 0.5:
                    raise AssertionError(f"K7h's needed {kind} tests per {tag} ray ({hit}) "
                                         f"{need[kind][hit]:.2f}, PR 8's count {n}")
        out[tag] = dict(times=times, bounds=b, rays=o.shape[0])
    r, p = out["random"], out["primary"]
    return dict(max_abs_err=err[0], occ_max_abs_err=err[1], ms=r["times"]["closest"],
                ms_pr8=r["times"]["closest_pr8"], plain_ms=plain_ms, **r["bounds"]["closest"],
                rays=r["rays"], ms_any=r["times"]["any"], ms_any_pr8=r["times"]["any_pr8"],
                bound_ms_any=r["bounds"]["any"]["bound_ms"],
                bound_by_any=r["bounds"]["any"]["bound_by"],
                ms_primary=p["times"]["closest"], ms_primary_pr8=p["times"]["closest_pr8"],
                bound_ms_primary=p["bounds"]["closest"]["bound_ms"],
                ms_any_primary=p["times"]["any"], ms_any_primary_pr8=p["times"]["any_pr8"],
                bound_ms_any_primary=p["bounds"]["any"]["bound_ms"], primary_rays=p["rays"],
                k3_ms=dict(closest=r["times"]["k3a"], any=r["times"]["k3b"]),
                k3_ms_primary=dict(closest=p["times"]["k3a"], any=p["times"]["k3b"]),
                tests_per_ray=r["bounds"]["tests_per_ray"],
                tests_per_ray_primary=p["bounds"]["tests_per_ray"], packet=1024,
                launch_shape=shape, ptxas=regs)


SWEEP_ITERS = 1  # timed frames of cluster_main, dfs_main and binned_main (after one warmup frame)


def phase_sweep_main(dev, kernel, keys, k3_ref=None, intersector="pallas"):
    """The sphere field through run_benchmark on the wavefront with
    bvh_kernel `kernel` (its kernels `keys`, nothing else launched), or with
    intersector "mt" (`kernel` "traverse": the packet traversal, K7h), its
    last frame held to the K3 wavefront's frame at the same config and
    timestamp.  Returns (the kernels' rows, the K3 frame and its rays and
    seconds, for the next kernel family's phase)."""
    from gpuspectral_tpu_torch.cli import main as cli
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu_torch.utils.bench import run_benchmark

    hs, depth = HEADLINE["size"], HEADLINE["depth"]
    select = (["--intersector", intersector] if intersector != "pallas"
              else ["--intersector", "pallas", "--bvh-kernel", kernel])
    log(f"phase {kernel}_main: sphere field {hs}x{hs}, 1 spp, depth {depth} through "
        f"run_benchmark ({' '.join(select)}: " + ", ".join(k.upper() for k in keys) + ")")
    # the command line's own arguments, as `cli.main benchmark` parses them
    args = cli.parser().parse_args([
        "benchmark", SPHERE_FIELD, "--size", f"{hs}x{hs}", "--spp", "1", "--depth", str(depth),
        *select, "--device", str(dev), "--warmup", "1", "--iters", str(SWEEP_ITERS)])
    reset_counts()
    result, img = run_benchmark(args, return_image=True)
    launches = counts()
    log(f"  {kernel}: " + json.dumps(result))
    log(f"  launches in the {kernel} run_benchmark: {launches}")
    others = {k: v for k, v in launches.items() if k not in keys}
    ok = all(launches[k] > 0 for k in keys) and others == {k: 0 for k in others}
    if kernel == "cluster":  # K7c votes once for each sweep
        ok = ok and launches["k7c"] == launches["k7d"] + launches["k7e"]
    if not ok:
        raise AssertionError(f"{kernel} run: want {keys} launched (K7c = K7d + K7e) and no other")
    ts = 100 + args.iters - 1
    if k3_ref is None:
        scene, cfg = cli._build(args)
        reset_counts()
        t0 = time.perf_counter()
        ref, rays_ref = render_image_stats(scene, cfg.replace(bvh_kernel="ftb",
                                                              intersector="pallas"), ts)
        torch.cuda.synchronize()
        k3_ref = (ref, rays_ref, time.perf_counter() - t0)
        c = counts()
        if c["k3a"] < 1 or any(v for k, v in c.items() if k.startswith("k7")):
            raise AssertionError(f"K3 wavefront reference: launch counts {c}")
    ref, rays_ref, k3_s = k3_ref
    err = compare_images(f"{kernel} frame vs the K3 wavefront (ts {ts})", img, ref,
                         result["rays_traced"], rays_ref, emission_only=False)
    log(f"  {kernel} frame {result['seconds_per_frame']:.3f} s, {result['mrays_per_s']:.4f} "
        f"Mrays/s; the K3 wavefront {k3_s:.3f} s, {rays_ref / k3_s / 1e6:.4f} Mrays/s")
    run = f"{kernel} run_benchmark ({hs}x{hs}, 1 spp, d{depth}, {' '.join(select)})"
    frame = dict(seconds_per_frame=result["seconds_per_frame"], mrays_per_s=result["mrays_per_s"],
                 rays_traced=result["rays_traced"], k3_wavefront_s=k3_s, frame_max_abs_err=err)
    return {k: dict(launches=launches[k], launched_by=run, **frame) for k in keys}, k3_ref


DIVERGED_RAD = 1e-5  # a lane's radiance moved by more: its path went another way
DIVERGED_GATE = 0.02  # share of lanes whose path may go another way (the 2% of the image gate)


def contracted(parts, keep, seed=5):
    """Partial planes (NP, rows, LANES) of the lanes in `keep` contracted
    with a fixed numpy cotangent of the lanes' radiance: (NP,) float64."""
    npl = parts.shape[0]
    lanes = parts[0].numel()
    ct = torch.as_tensor(np.random.default_rng(seed).uniform(-1, 1, (lanes, 3)).astype(np.float32),
                         device=parts.device) * keep.reshape(-1, 1)
    cidx = torch.arange(npl, device=parts.device) % 3
    return (parts.reshape(npl, -1) * ct.t()[cidx]).sum(1).double().cpu().numpy()


def check_fused(tag, got, ref, spp, scene, sub=False):
    """K5 / K6 against the plain version: radiance gates (those of main
    with sub), rays within 1%, and contracted gradients within GRAD_TOL,
    each family of planes (kd, emitter hit, NEE emission: grad_plane_keys)
    against its own largest value.  A lane whose path went another way on a
    rounding difference (a seam flip: its radiance differs by more than
    DIVERGED_RAD, where rounding alone moves it by ~1e-7) has other partials
    by right, and one such lane can move a contraction in which the other
    lanes' terms cancel by several percent; the gradients are compared over
    the other lanes, and at most DIVERGED_GATE of the lanes may diverge.
    (A lane's ray count is no sign: on the sphere field 3% of the lanes
    count other rays while every radiance agrees within 1e-4.)"""
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    img = torch.stack(got[:3], -1).reshape(-1, 3) / spp
    img_ref = torch.stack(ref[:3], -1).reshape(-1, 3) / spp
    rays, rays_ref = float(got[3].double().sum()), float(ref[3].double().sum())
    gates = dict(mean_gate=SUB_MEAN_GATE, fine_gate=SUB_FINE_GATE) if sub else {}
    err = compare_images(tag, img, img_ref, rays, rays_ref, emission_only=False, **gates)
    diverged = (img - img_ref).abs().amax(-1) > DIVERGED_RAD
    keep = (~diverged).to(torch.float32)
    cg, cr = contracted(got[4], keep), contracted(ref[4], keep)
    lg = mg._grad_lights(scene)
    kd_end = cg.shape[0] - 6 * lg
    rel = {}
    for fam, lo, hi in (("gkd", 0, kd_end), ("gte", kd_end, kd_end + 3 * lg),
                        ("gle", kd_end + 3 * lg, cg.shape[0])):
        if hi > lo:
            d, scale = np.abs(cg[lo:hi] - cr[lo:hi]).max(), np.abs(cr[lo:hi]).max()
            rel[fam] = float(d / scale) if scale > 0 else (0.0 if d == 0 else float("inf"))
    share = float(diverged.double().mean())
    log(f"  {tag}: {got[4].shape[0]} partial planes, {int(diverged.sum())} diverged lanes of "
        f"{diverged.numel()}; contracted gradient max rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    if not (bool(torch.isfinite(got[4]).all()) and np.abs(cr[:kd_end]).max() > 0
            and max(rel.values()) <= GRAD_TOL and share <= DIVERGED_GATE):
        raise AssertionError(f"{tag}: gradients outside {GRAD_TOL} of the plain version")
    return max(err, float(np.abs(cg - cr).max()))


def phase_grad_main(dev):
    from gpuspectral_tpu_torch.integrator import mega, mega_grad as mg
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig
    from gpuspectral_tpu_torch.utils.bench import run_grad_benchmark

    hs, spp, depth, steps = GRAD["size"], GRAD["spp"], GRAD["depth"], GRAD["steps"]
    log(f"phase grad_main: Cornell gradient step {hs}x{hs}, {spp} spp, depth {depth} through "
        "run_grad_benchmark (K5)")
    reset_counts()
    result, g, ts = run_grad_benchmark(CORNELL, size=hs, spp=spp, depth=depth, steps=steps,
                                       return_grad=True)
    launches = counts()
    log("  grad: " + json.dumps(result))
    log(f"  launches in the grad run_grad_benchmark: {launches}")
    if result["kernel"] != "mega" or launches != dict(NONE, k5=1 + steps):
        raise AssertionError(f"grad run: want K5 launched {1 + steps} times and nothing else")
    if not bool(torch.isfinite(g).all()) or float(g[:, 0:3].abs().max()) <= 0.0:
        raise AssertionError("grad run: gradient not finite or zero")

    scene, _ = load_mitsuba_scene(CORNELL, device=dev)
    cfg = RenderConfig(width=hs, height=hs, spp=spp, max_depth=depth)
    n_rows = hs * hs // mega.LANES
    sub = torch.linspace(0, n_rows - 1, min(SUB_ROWS, n_rows), device=dev).round().to(torch.int32)
    pix = (sub[:, None] * mega.LANES
           + torch.arange(mega.LANES, dtype=torch.int32, device=dev)).contiguous()
    got = mg.render_mega_fwdgrad_rows(scene, cfg, pix, ts)
    k5_ms = cuda_ms(lambda: mg.render_mega_fwdgrad_rows(scene, cfg, pix, ts))
    t0 = time.perf_counter()
    ref = mg.render_mega_fwdgrad_rows_ref(scene, cfg, pix, ts)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    err = check_fused(f"K5 vs plain, {pix.shape[0]} rows of the grad frame (ts {ts})", got, ref,
                      spp, scene, sub=True)
    rays = float(got[3].double().sum())
    log(f"  K5 {k5_ms:.3f} ms vs plain {ref_ms:.3f} ms on those rows")
    # the main path's launch: K5 over the step's whole frame, beside K1 over
    # the same frame (the hook's cost)
    frame = mg.pix_rows(cfg, dev)
    frame_out = mg.render_mega_fwdgrad_rows(scene, cfg, frame, ts)
    frame_rays = float(frame_out[3].reshape(-1)[:hs * hs].double().sum())
    k5_frame = cuda_ms(lambda: mg.render_mega_fwdgrad_rows(scene, cfg, frame, ts))
    k1_frame = cuda_ms(lambda: mega.render_mega_rows(scene, cfg, frame, ts))
    step_ms = result["seconds_per_step"] * 1e3
    log(f"  whole frame {hs}x{hs} @ {spp} spp, d{depth}: K5 {k5_frame:.3f} ms, K1 {k1_frame:.3f} ms "
        f"(ratio {k5_frame / k1_frame:.3f}); grad step {step_ms:.3f} ms (K5's share "
        f"{k5_frame / step_ms:.3f}), {frame_rays:.0f} rays")
    npl = got[4].shape[0]
    tally = tally_rows(scene, cfg, pix, ts)
    tables = nbytes(*mega_tables(scene, False))
    k5_bound = fused_bound(tally, frame_rays, frame.numel() * (4 + 16 + 4 * npl) + tables)
    rows_bound = fused_bound(tally, rays, pix.numel() * (4 + 16 + 4 * npl) + tables)
    log(f"  K5 frame bound {k5_bound['bound_ms']:.4f} ms ({k5_bound['bound_by']}): "
        f"K5 at {k5_bound['bound_ms'] / k5_frame:.5f} of it")

    big = GRAD_1024
    log(f"  config 5: one gradient step {big['size']}x{big['size']}, {big['spp']} spp, "
        f"d{big['depth']}")
    reset_counts()
    r1024 = run_grad_benchmark(CORNELL, size=big["size"], spp=big["spp"], depth=big["depth"],
                               steps=big["steps"])
    log("  grad_1024: " + json.dumps(r1024))
    if r1024["kernel"] != "mega" or counts() != dict(NONE, k5=1 + big["steps"]):
        raise AssertionError("grad_1024: want K5 only")
    head = f"grad run_grad_benchmark ({hs}x{hs}, {spp} spp, d{depth}, {steps} steps)"
    return dict(launches=launches["k5"], launched_by=head, max_abs_err=err, ms=k5_frame,
                timed_call=f"the step's launch over the {hs}x{hs} frame at {spp} spp, d{depth}",
                frame_rays=frame_rays, plain_ms=ref_ms,
                plain_call=f"{pix.shape[0]} pixel rows at {spp} spp", ms_rows=k5_ms,
                bound_ms_rows=rows_bound["bound_ms"], **k5_bound,
                share_of_step=k5_frame / step_ms, k1_frame_ms=k1_frame,
                grad_steps_per_s=result["grad_steps_per_s"],
                seconds_per_step=result["seconds_per_step"], peak_hbm_gb=result["peak_hbm_gb"],
                seconds_per_step_1024=r1024["seconds_per_step"])


def mixed_scene(dev):
    """tests/test_mega_grad.py:230's mixed-BSDF scene (slot-mode build)."""
    from gpuspectral_tpu_torch.bsdf import table as bt
    from gpuspectral_tpu_torch.scene.data import SceneBuilder
    from gpuspectral_tpu_torch.scene.obj import make_cube, make_rectangle

    b = SceneBuilder()
    rpos, rnrm, ruv = make_rectangle()
    cpos, cnrm, cuv = make_cube()
    kd = b.add_bsdf(bt.diffuse((0.6, 0.4, 0.3)))
    mirror = b.add_bsdf(bt.smooth_conductor(0.0))
    b.add_object(rpos, rnrm, ruv, np.array([[2, 0, 0, 0], [0, 0, 2, 0], [0, -1, 0, 0],
                                            [0, 0, 0, 1]], np.float32), kd, twofaced=True)
    b.add_object(cpos, cnrm, cuv, np.array([[0.5, 0, 0, -0.5], [0, 0.5, 0, -0.49],
                                            [0, 0, 0.5, 0], [0, 0, 0, 1]], np.float32), mirror)
    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    b.add_object(rpos, rnrm, ruv, np.array([[1, 0, 0, 0], [0, 0, -1, 2.5], [0, 1, 0, 0],
                                            [0, 0, 0, 1]], np.float32), light,
                 emission=(8.0, 8.0, 8.0))
    b.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 0.6], [0, 0, -1, 3], [0, 0, 0, 1]],
                          np.float32), np.deg2rad(60))
    return b.build(dev)


def textured_scene(dev):
    """tests/test_mega_grad.py:289's vertex-textured diffuse scene."""
    from gpuspectral_tpu_torch.bsdf import table as bt
    from gpuspectral_tpu_torch.scene.data import TEX_RES, SceneBuilder
    from gpuspectral_tpu_torch.scene.obj import make_rectangle

    b = SceneBuilder()
    pos, nrm, uv = make_rectangle()
    u = (np.arange(TEX_RES, dtype=np.float32) + 0.5) / TEX_RES
    mat = b.add_bsdf(bt.diffuse((0.7, 0.5, 0.4)),
                     texture=np.broadcast_to(u[None, :, None], (TEX_RES, TEX_RES, 3)).copy())
    b.add_object(pos, nrm, uv, np.array([[2, 0, 0, 0], [0, 0, 2, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
                                        np.float32), mat, twofaced=True)
    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    b.add_object(pos, nrm, uv, np.array([[1, 0, 0, 0], [0, 0, -1, 3], [0, 1, 0, 0], [0, 0, 0, 1]],
                                        np.float32), light, emission=(10.0, 10.0, 10.0))
    b.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 4], [0, 0, 0, 1]],
                          np.float32), np.deg2rad(60))
    return b.build(dev)


def slot_mode(build):
    from gpuspectral_tpu_torch.bvh import build as bvh_build

    old = bvh_build.SLOT_DENSE_THRESHOLD
    bvh_build.SLOT_DENSE_THRESHOLD = 8
    try:
        return build()
    finally:
        bvh_build.SLOT_DENSE_THRESHOLD = old


def phase_fused(dev, bvh, cases):
    """K5 (bvh False) or K6 against its plain version and against K1 / K4
    (the hook only reads: same image), at 64x64, depths 3 and 5."""
    from gpuspectral_tpu_torch.integrator import mega, mega_bvh, mega_grad as mg
    from gpuspectral_tpu_torch.utils import RenderConfig

    key, fwd_key = ("k6", "k4") if bvh else ("k5", "k1")
    kernel = mg.render_mega_bvh_fwdgrad_rows if bvh else mg.render_mega_fwdgrad_rows
    plain = mg.render_mega_bvh_fwdgrad_rows_ref if bvh else mg.render_mega_fwdgrad_rows_ref
    forward = mega_bvh.render_mega_bvh_rows if bvh else mega.render_mega_rows
    err = 0.0
    for name, scene in cases.items():
        for depth, spp in ((3, 2), (5, 4)):
            cfg = RenderConfig(width=64, height=64, spp=spp, max_depth=depth, use_bvh=bvh)
            pix = mg.pix_rows(cfg, dev)
            reset_counts()
            got = kernel(scene, cfg, pix, 0)
            fwd = forward(scene, cfg, pix, 0)
            ref = plain(scene, cfg, pix, 0)
            torch.cuda.synchronize()
            c = counts()
            if c[key] != 1 or c[fwd_key] != 1:
                raise AssertionError(f"{key} {name}: launch counts {c}")
            s_got = float(torch.stack(got[:3]).double().sum())
            s_fwd = float(torch.stack(fwd[:3]).double().sum())
            if abs(s_got - s_fwd) > 1e-5 * abs(s_fwd):
                raise AssertionError(f"{key} {name}: image sum {s_got}, {fwd_key}'s {s_fwd}")
            err = max(err, check_fused(f"{name} d{depth} {spp}spp", got, ref, spp, scene))
    return err


def phase_grad_bvh(dev):
    from gpuspectral_tpu_torch.integrator import mega_bvh, mega_grad as mg
    from gpuspectral_tpu_torch.utils import RenderConfig
    from gpuspectral_tpu_torch.utils.bench import load_scene, run_grad_benchmark

    hs, spp, depth, steps = GRAD["size"], GRAD["spp"], GRAD["depth"], 2
    log(f"phase grad_bvh: {SPHERE_FIELD_NOENV} gradient step {hs}x{hs}, {spp} spp, depth "
        f"{depth} through run_grad_benchmark (K6)")
    reset_counts()
    result, g, ts = run_grad_benchmark(SPHERE_FIELD_NOENV, size=hs, spp=spp, depth=depth,
                                       steps=steps, use_bvh=True, return_grad=True)
    launches = counts()
    log("  grad_bvh: " + json.dumps(result))
    log(f"  launches in the grad_bvh run_grad_benchmark: {launches}")
    if result["kernel"] != "mega_bvh" or launches != dict(NONE, k6=1 + steps):
        raise AssertionError(f"grad_bvh run: want K6 launched {1 + steps} times and nothing else")
    if not bool(torch.isfinite(g).all()) or float(g[:, 0:3].abs().max()) <= 0.0:
        raise AssertionError("grad_bvh run: gradient not finite or zero")

    scene = load_scene(SPHERE_FIELD_NOENV, dev)
    cfg = RenderConfig(width=hs, height=hs, spp=spp, max_depth=depth, use_bvh=True)
    n_rows = hs * hs // mega_bvh.LANES
    sub = torch.linspace(0, n_rows - 1, K4_ROWS, device=dev).round().to(torch.int32)
    pix = (sub[:, None] * mega_bvh.LANES
           + torch.arange(mega_bvh.LANES, dtype=torch.int32, device=dev)).contiguous()
    ref, spp_cmp, ref_ms = plain_leg(mg.render_mega_bvh_fwdgrad_rows_ref, scene, cfg, pix, ts)
    cfg_cmp = cfg.replace(spp=spp_cmp)
    got = mg.render_mega_bvh_fwdgrad_rows(scene, cfg_cmp, pix, ts)
    k6_ms = cuda_ms(lambda: mg.render_mega_bvh_fwdgrad_rows(scene, cfg_cmp, pix, ts), reps=2)
    err = check_fused(f"K6 vs plain, {K4_ROWS} rows of the grad_bvh frame (ts {ts}, {spp_cmp} spp)",
                      got, ref, spp_cmp, scene, sub=True)
    log(f"  K6 {k6_ms:.3f} ms vs plain {ref_ms:.3f} ms on those rows at {spp_cmp} spp")
    # the main path's shape: the one K6 launch of a step, over the whole frame
    pix_frame = mg.pix_rows(cfg, dev)
    frame = mg.render_mega_bvh_fwdgrad_rows(scene, cfg, pix_frame, ts)
    k6_step_ms = cuda_ms(lambda: mg.render_mega_bvh_fwdgrad_rows(scene, cfg, pix_frame, ts),
                         reps=2)
    step_ms = result["seconds_per_step"] * 1e3
    frame_rays = float(frame[3].reshape(-1)[:hs * hs].double().sum())
    log(f"  K6 over the step's frame: {k6_step_ms:.3f} ms of a {step_ms:.3f} ms step "
        f"(share {k6_step_ms / step_ms:.3f}), {frame_rays:.0f} rays")
    tally = tally_rows(scene, cfg_cmp, pix, ts)
    planes = 4 * frame[4].shape[0]
    tables = nbytes(*mega_tables(scene, True))
    k6_bound = fused_bound(tally, frame_rays, pix_frame.numel() * (4 + 16 + planes) + tables)
    rows_bound = fused_bound(tally, float(got[3].double().sum()),
                             pix.numel() * (4 + 16 + planes) + tables)
    log(f"  K6 frame bound {k6_bound['bound_ms']:.4f} ms ({k6_bound['bound_by']}): "
        f"K6 at {k6_bound['bound_ms'] / k6_step_ms:.5f} of it")
    head = f"grad_bvh run_grad_benchmark ({hs}x{hs}, {spp} spp, d{depth}, {steps} steps)"
    return dict(launches=launches["k6"], launched_by=head, max_abs_err=err, ms=k6_step_ms,
                timed_call=f"the step's launch over the {hs}x{hs} frame at {spp} spp, d{depth}",
                frame_rays=frame_rays, plain_ms=ref_ms,
                plain_call=f"{K4_ROWS} pixel rows at {spp_cmp} spp", ms_rows=k6_ms,
                bound_ms_rows=rows_bound["bound_ms"], **k6_bound,
                spp_compared=spp_cmp, share_of_step=k6_step_ms / step_ms,
                grad_steps_per_s=result["grad_steps_per_s"],
                seconds_per_step=result["seconds_per_step"], peak_hbm_gb=result["peak_hbm_gb"])


def wavefront_grads(scene, cfg, target):
    """Albedo and emission gradients of the MSE through the differentiable
    wavefront (diff/gradcheck.render_mean)."""
    from gpuspectral_tpu_torch.diff.gradcheck import render_mean
    from gpuspectral_tpu_torch.diff.invert import scatter_light_emission

    p = scene.bsdf_params.clone().requires_grad_(True)
    le = scene.light_emission.clone().requires_grad_(True)
    img = render_mean(scatter_light_emission(scene.replace(bsdf_params=p), le), cfg,
                      differentiable=True)
    loss = torch.mean((img - target.to(img.device)) ** 2)
    gp, gl = torch.autograd.grad(loss, (p, le))
    return gp[:, 0:3].cpu().numpy(), gl.cpu().numpy()


def grad_wavefront_cases(dev, cases):
    """The differentiable wavefront at 32x32, 4 spp, d3 on the card against
    the same on the CPU, for each (name, scene builder, kernel key, config
    keywords): the kernel launched, albedo and emission gradients within
    GRAD_TOL of the CPU's."""
    from gpuspectral_tpu_torch.utils import RenderConfig

    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=3, intersector="pallas")
    target = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, (32 * 32, 3)).astype(np.float32))
    err = 0.0
    for name, build, key, kw in cases:
        c = cfg.replace(**kw)
        reset_counts()
        t0 = time.perf_counter()
        got = wavefront_grads(build(dev), c, target)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts()
        ref = wavefront_grads(build("cpu"), c, target)
        if launches[key] < 1:
            raise AssertionError(f"grad_wavefront {name}: {key} not launched: {launches}")
        for tag, a, b in (("albedo", got[0], ref[0]), ("emission", got[1], ref[1])):
            scale = float(np.abs(b).max())
            rel = float(np.abs(a - b).max()) / max(scale, 1e-30)
            log(f"  {name} {tag}: scale {scale:.4g}, max rel {rel:.3e} ({dt:.2f} s on the card, "
                f"{key} launches {launches[key]})")
            if not (np.isfinite(a).all() and scale > 0 and rel <= GRAD_TOL):
                raise AssertionError(f"grad_wavefront {name} {tag}: outside {GRAD_TOL}")
            err = max(err, float(np.abs(a - b).max()))
    return err


def phase_grad_wavefront(dev):
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    log("phase grad_wavefront: the differentiable wavefront on K2a / K3a vs the same on the CPU")
    return grad_wavefront_cases(dev, (
        ("cornell", lambda d: load_mitsuba_scene(CORNELL, device=d)[0], "k2a", {}),
        ("sphere_field_small", lambda d: build_sphere_field(d, n_side=2, segs=16, rings=8),
         "k3a", dict(use_bvh=True))))


def phase_sweep_grad(dev, kernel, key, wrapper, select=None):
    """grad_wavefront_cases on the small sphere field without its sky, with
    bvh_kernel `kernel` or the config keywords `select` (the packet
    traversal: intersector "mt")."""
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    log(f"phase {kernel}_grad: the differentiable wavefront on {key.upper()} ({wrapper}) "
        "vs the same on the CPU")
    return grad_wavefront_cases(dev, (
        ("sphere_field_small_noenv",
         lambda d: build_sphere_field(d, n_side=2, segs=16, rings=8, sky_hw=None), key,
         dict(use_bvh=True, **(select or dict(bvh_kernel=kernel)))),))


def phase_invert(dev):
    from gpuspectral_tpu_torch.diff.invert import _render, gradient_path, invert, optimizable_mask
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase invert: 10 Adam steps of the self-target demo, Cornell 128x128, 8 spp, d5 (K5)")
    scene, _ = load_mitsuba_scene(CORNELL, device=dev)
    cfg = RenderConfig(width=128, height=128, spp=8, max_depth=5)
    mask = optimizable_mask(scene.bsdf_kind.cpu().numpy())
    if gradient_path(scene, cfg, mask, False) != "mega":
        raise AssertionError("invert: want the K5 gradient path")
    target = _render(scene, cfg, cfg.spp, 0).cpu().numpy()
    p0 = scene.bsdf_params.cpu().numpy().copy()
    p0[mask] = np.clip(p0[mask] + np.random.default_rng(0).uniform(-0.25, 0.25, mask.sum()),
                       0.02, 1.0)
    reset_counts()
    t0 = time.perf_counter()
    # common random numbers (the target's sample set): the loss has its exact
    # zero at the truth, so its fall is not hidden by path noise
    params, history = invert(scene, target, cfg, steps=10, init_params=p0, timestamp0=0,
                             resample=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = counts()
    err0 = float(np.abs(p0 - scene.bsdf_params.cpu().numpy())[mask].mean())
    err1 = float(np.abs(params.cpu().numpy() - scene.bsdf_params.cpu().numpy())[mask].mean())
    log(f"  losses {[round(x, 7) for x in history]}; {dt:.2f} s for 10 steps; "
        f"mean parameter error {err0:.4f} -> {err1:.4f}; launches {c}")
    if c != dict(NONE, k5=10) or not np.isfinite(history).all() or not history[9] < history[0]:
        raise AssertionError("invert: want 10 K5 launches and a falling loss")


ENGINE_FRAMES = 8  # progressive frames of the engine phase
DIST_SMALL = dict(size=128, spp=4, depth=5)  # the sharded wavefront render and step (K2 / K2a)
DIST_TIMEOUT_S = 300.0  # every collective of the one-rank group fails after this long


def wall_ms(fn, reps: int = 2) -> float:
    """Mean wall milliseconds per call after a warmup, synchronized: for
    host-bound calls (the wavefront), where the wall is the time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def scratch_dir(name):
    """A directory of the checkout's build/ (gitignored) for files a phase
    writes."""
    path = os.path.join(ROOT, "build", "chip_smoke", name)
    os.makedirs(path, exist_ok=True)
    return path


def trace_names(path):
    """(names of every event, names of the card's kernels) of a chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {str(ev.get("name", "")) for ev in events}
    kernels = {str(ev.get("name", "")) for ev in events if ev.get("cat") == "kernel"}
    return names, kernels


def phase_engine(dev):
    from gpuspectral_tpu_torch.cli.main import main as cli_main
    from gpuspectral_tpu_torch.engine import Engine
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image
    from gpuspectral_tpu_torch.utils import profiling

    hs, depth, frames = HEADLINE["size"], HEADLINE["depth"], ENGINE_FRAMES
    log(f"phase engine: Engine on Cornell {hs}x{hs}, depth {depth}, {frames} progressive "
        "frames (render_step: the wavefront on K2)")
    kw = dict(max_depth=depth, ray_batch=65536)

    def engine(size, scene=None):
        eng = Engine(ROOT, device=dev).init(size, size, **kw)
        if scene is None:
            eng.load_scene(CORNELL)
        else:
            eng.scene = scene
        return eng

    eng = engine(hs)
    frame_s = []
    reset_counts()
    t0 = time.perf_counter()
    img = eng.run(frames, on_frame=lambda i, im: frame_s.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    launches = counts()
    frame_s = np.diff([t0] + frame_s)
    log(f"  {frames} frames in {wall:.3f} s ({frames / wall:.4f} frames/s; per frame "
        f"{[round(float(x), 4) for x in frame_s]} s, each with its host copy); launches {launches}")
    if launches["k1"] or launches["k2a"] < frames or launches["k2b"] < frames or any(
            v for k, v in launches.items() if k not in ("k2a", "k2b")):
        raise AssertionError("engine: want K2a / K2b launched every frame and no other kernel")
    if img.shape != (hs, hs, 3) or not np.isfinite(img).all() or img.mean() <= 0.0:
        raise AssertionError(f"engine image bad: shape {img.shape}, mean {img.mean()}")
    t0 = time.perf_counter()
    ref = render_image(eng.scene, eng.cfg.replace(spp=frames), 0).cpu().numpy()
    ref_s = time.perf_counter() - t0
    err = float(np.abs(img - ref).max())
    log(f"  render_image at {frames} spp, timestamp 0: {ref_s:.3f} s; max |engine - it| {err:.3g}")
    if not np.allclose(img, ref, rtol=1e-4, atol=1e-5):
        raise AssertionError("engine: the frames differ from render_image at spp = frames")

    # checkpoint after half the frames, restore into a fresh Engine, finish
    ck = os.path.join(scratch_dir("engine"), "state.npz")
    first = engine(hs, eng.scene)
    first.run(frames // 2)
    first.checkpoint(ck)
    second = engine(hs, eng.scene)
    second.restore(ck)
    resumed = second.run(frames - frames // 2)
    if second.timestamp != frames or not np.array_equal(resumed, img):
        raise AssertionError("engine: checkpoint / restore differs from the uninterrupted run")
    log(f"  checkpoint at frame {frames // 2}, restored, {frames - frames // 2} more: "
        "equal to the uninterrupted run")

    out = scratch_dir("view")
    reset_counts()
    rc = cli_main(["view", CORNELL, "--size", "64x64", "--depth", str(depth), "--frames", "4",
                   "--every", "2", "--preview", os.path.join(out, "preview.png"),
                   "-o", os.path.join(out, "view.png"), "--tonemap", "--device", str(dev)])
    view = counts()
    if rc != 0 or not all(os.path.exists(os.path.join(out, f)) for f in ("preview.png",
                                                                          "view.png")):
        raise AssertionError("view: no preview or output written")
    if view["k1"] or view["k2a"] < 4:
        raise AssertionError(f"view: want K2 and no K1, got {view}")
    log(f"  view 64x64, 4 frames: preview and output written; launches {view}")

    # one traced 64x64 frame (a traced 512x512 wavefront frame holds ~1M events)
    prof = scratch_dir("trace")
    small = engine(64, eng.scene)
    t0 = time.perf_counter()
    with profiling.trace(prof):
        small.run(1)
    names, kernels = trace_names(os.path.join(prof, profiling.TRACE_FILE))
    k2 = sorted(k for k in kernels if "closest_kernel" in k or "any_kernel" in k)
    log(f"  traced 64x64 frame: {time.perf_counter() - t0:.2f} s, {len(names)} event names, "
        f"{len(kernels)} kernel names, K2's: {k2[:2]}")
    if "Frame" not in names or not k2:
        raise AssertionError("trace: want a Frame event and a K2 kernel")
    return dict(launches=launches, frames_per_s=frames / wall, frame_s=frame_s.tolist(),
                render_image_s=ref_s, max_abs_err=err, view_launches=view)


def phase_dist(dev):
    import torch.distributed as dist

    from gpuspectral_tpu_torch.cli.main import _build
    from gpuspectral_tpu_torch.diff import gradcheck
    from gpuspectral_tpu_torch.integrator import mega, mega_bvh, mega_grad
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image
    from gpuspectral_tpu_torch.parallel import dist as pdist, launch
    from gpuspectral_tpu_torch.parallel.dryrun import (check_grad, check_render, dryrun_multichip,
                                                       value_and_grad)
    from gpuspectral_tpu_torch.utils import RenderConfig

    hs, spp, depth = HEADLINE["size"], HEADLINE["spp"], HEADLINE["depth"]
    log("phase dist: the sharded functions on a one-rank NCCL group, mesh (1, 1)")
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(launch.free_port()))
    launch.initialize(timeout_s=DIST_TIMEOUT_S)
    rows = {}
    try:
        mesh = pdist.make_mesh(1, spp_shards=1)
        log(f"  backend {dist.get_backend()}, mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")

        def args(scene_path, s, n_spp, d):
            return argparse.Namespace(
                scene=scene_path, size=f"{s}x{s}", spp=n_spp, depth=d, no_nee=False,
                jitter=False, ray_batch=65536, bvh=None, bvh_kernel="ftb", light_block=None,
                packet_size=1024, intersector="auto", light_sampling="uniform",
                mis="reference", device=str(dev))

        def sharded_render(key, scene, cfg, unsharded):
            reset_counts()
            img_s, rays_s = pdist.render_image_sharded_fast(scene, cfg, mesh)
            torch.cuda.synchronize()
            c = counts()
            img_u, rays_u = unsharded(scene, cfg, 0)
            if c != dict(NONE, **{key: 1}):
                raise AssertionError(f"render_image_sharded_fast: want one {key} launch, got {c}")
            check_render(f"render_image_sharded_fast ({key})", (img_s, rays_s), (img_u, rays_u),
                         split=False)
            ms_s = cuda_ms(lambda: pdist.render_image_sharded_fast(scene, cfg, mesh))
            ms_u = cuda_ms(lambda: unsharded(scene, cfg, 0))
            log(f"  {key}: render_image_sharded_fast {ms_s:.3f} ms vs unsharded {ms_u:.3f} ms, "
                f"images equal, rays {rays_s:.0f} equal")
            return dict(launches=c[key], ms_sharded=ms_s, ms_unsharded=ms_u, rays=rays_s)

        def sharded_grad(key, scene, cfg, diff, seed):
            target = torch.as_tensor(np.random.default_rng(seed).uniform(
                0.0, 1.0, (cfg.height, cfg.width, 3)).astype(np.float32), device=dev)
            reset_counts()
            got = pdist.grad_step_sharded_fast(scene, cfg, mesh, target, optimize_emission=True)
            torch.cuda.synchronize()
            c = counts()
            ref = value_and_grad(diff, scene, cfg, target)
            if c != dict(NONE, **{key: 1}):
                raise AssertionError(f"grad_step_sharded_fast: want one {key} launch, got {c}")
            err = check_grad(f"grad_step_sharded_fast ({key})", got, ref)
            ms_s = cuda_ms(lambda: pdist.grad_step_sharded_fast(scene, cfg, mesh, target))
            ms_u = cuda_ms(lambda: value_and_grad(diff, scene, cfg, target))
            log(f"  {key}: grad_step_sharded_fast {ms_s:.3f} ms vs value_and_grad through the "
                f"unsharded render {ms_u:.3f} ms; loss {float(got[0]):.7f} vs "
                f"{float(ref[0]):.7f}, max gradient difference {err:.3g}")
            return dict(launches=c[key], ms_sharded=ms_s, ms_unsharded=ms_u, max_abs_err=err)

        cornell, cfg = _build(args(CORNELL, hs, spp, depth))
        rows["k1"] = sharded_render("k1", cornell, cfg, mega.render_mega)
        field, cfg_f = _build(args(SPHERE_FIELD, hs, spp, depth))
        rows["k4"] = sharded_render("k4", field, cfg_f, mega_bvh.render_mega_bvh)
        del field
        g = GRAD
        _, cfg_g = _build(args(CORNELL, g["size"], g["spp"], g["depth"]))
        rows["k5"] = sharded_grad("k5", cornell, cfg_g, mega_grad.render_mega_diff, 8)
        noenv, cfg_n = _build(args(SPHERE_FIELD_NOENV, g["size"], g["spp"], g["depth"]))
        rows["k6"] = sharded_grad("k6", noenv, cfg_n, mega_grad.render_mega_bvh_diff, 7)
        del noenv

        # the sharded wavefront render and step (K2, K2a through closest_diff)
        d = DIST_SMALL
        cfg_w = RenderConfig(width=d["size"], height=d["size"], spp=d["spp"],
                             max_depth=d["depth"], ray_batch=65536)
        reset_counts()
        img_s = pdist.render_image_sharded(cornell, cfg_w, mesh)
        torch.cuda.synchronize()
        c_render = counts()
        img_u = render_image(cornell, cfg_w, 0)
        err = float((img_s - img_u).abs().max())
        ms_s = wall_ms(lambda: pdist.render_image_sharded(cornell, cfg_w, mesh))
        ms_u = wall_ms(lambda: render_image(cornell, cfg_w, 0))
        log(f"  render_image_sharded {d['size']}^2 @{d['spp']} spp d{d['depth']}: {ms_s:.1f} ms "
            f"vs render_image {ms_u:.1f} ms, max difference {err:.3g}; launches {c_render}")
        if c_render["k1"] or c_render["k2a"] < 1 or c_render["k2b"] < 1 or err > 1e-5:
            raise AssertionError("render_image_sharded: want K2 launched and the unsharded image")
        target = torch.zeros((d["size"], d["size"], 3), device=dev)
        reset_counts()
        got = pdist.grad_step_sharded(cornell, cfg_w, mesh, target)
        torch.cuda.synchronize()
        c_grad = counts()
        ref = gradcheck._loss_and_grad(cornell, cfg_w, cornell.bsdf_params, target)
        ms_gs = wall_ms(lambda: pdist.grad_step_sharded(cornell, cfg_w, mesh, target))
        ms_gu = wall_ms(lambda: gradcheck._loss_and_grad(cornell, cfg_w, cornell.bsdf_params,
                                                         target))
        g_err = float((got[1] - ref[1]).abs().max())
        log(f"  grad_step_sharded: {ms_gs:.1f} ms vs autograd of the unsharded MSE {ms_gu:.1f} "
            f"ms, loss {float(got[0]):.7f} vs {float(ref[0]):.7f}, max gradient difference "
            f"{g_err:.3g}; launches {c_grad}")
        if (c_grad["k1"] or c_grad["k5"] or c_grad["k2a"] < 1 or g_err > 1e-5
                or not np.isclose(float(got[0]), float(ref[0]), rtol=1e-5, atol=0)):
            raise AssertionError("grad_step_sharded: want K2a launched and the unsharded step")
        rows["k2"] = dict(render=dict(launches=c_render, ms_sharded=ms_s, ms_unsharded=ms_u,
                                      max_abs_err=err),
                          grad=dict(launches=c_grad, ms_sharded=ms_gs, ms_unsharded=ms_gu,
                                    max_abs_err=g_err))
        t0 = time.perf_counter()
        line = dryrun_multichip(1)
        log(f"  {line} ({time.perf_counter() - t0:.1f} s)")
    finally:
        dist.destroy_process_group()
    log("  process group destroyed")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gpuspectral_tpu_torch import _build
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import build_zoo

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (built now: {info['built_now']}) "
        f"-> {info['path']}")
    for kern, line in info["ptxas"].items():
        log(f"  ptxas {kern}: {line}")

    scenes = {"cornell": load_mitsuba_scene(CORNELL, device=dev)[0], "zoo": build_zoo(dev)}
    k2_err = phase_k2(dev, scenes)
    phase_k1(scenes)
    m = phase_main(dev)
    m["k2a"]["max_abs_err"] = max(m["k2a"]["max_abs_err"], k2_err[0])
    m["k2b"]["max_abs_err"] = max(m["k2b"]["max_abs_err"], k2_err[1])

    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    t0 = time.perf_counter()
    field = build_sphere_field(dev)
    log(f"sphere field build: {time.perf_counter() - t0:.2f} s, {field.num_tris} triangles")
    cases = bvh_cases(dev, scenes, field)
    k3_err, k3_times = phase_k3(dev, cases, field)
    k7 = phase_k7(dev, cases, field)
    k7h = phase_k7h(dev, cases, field)
    del field, cases
    env_err = phase_env(dev)
    k4_err = phase_k4(dev, scenes)
    m["k1"]["max_abs_err"] = max(m["k1"]["max_abs_err"], env_err["k1"])
    m["k4"], scene, cfg, k4_mean = phase_bvh_main(dev)
    m["k4"]["max_abs_err"] = max(m["k4"]["max_abs_err"], k4_err, env_err["k4"])
    wave_c, wave = phase_bvh_wavefront(scene, cfg, k4_mean)
    small, big = k3_times[K3_RAYS["parity"]], k3_times[K3_RAYS["timing"]]
    ptxas = walk_ptxas()
    for key in ("k3a", "k3b"):
        m[key] = dict(launches=wave_c[key], launched_by=wave, max_abs_err=k3_err,
                      ms=small[key], plain_ms=small[key + "_plain"], **k3_times["bounds"][key],
                      rays=K3_RAYS["parity"], ms_1m_rays=big[key],
                      ms_primary_rays=k3_times["primary"][key],
                      k2_ms=small["k2" + key[2]], k2_ms_1m_rays=big["k2" + key[2]],
                      ptxas={k: v for k, v in ptxas.items() if "mega" not in k})
    m["k4"]["ptxas"] = {k: v for k, v in ptxas.items() if k.startswith("mega_bvh_kernel")}
    del scene
    rows, k3_ref = phase_sweep_main(dev, "cluster", ("k7c", "k7d", "k7e"))
    rows_fg, _ = phase_sweep_main(dev, "dfs", ("k7f", "k7g"), k3_ref)
    rows_ab, _ = phase_sweep_main(dev, "binned", ("k7a", "k7b"), k3_ref)
    rows_h, _ = phase_sweep_main(dev, "traverse", ("k7h", "k7h_any"), k3_ref, intersector="mt")
    del k3_ref
    for key, row in dict(rows, **rows_fg, **rows_ab).items():
        m[key] = dict(row, **k7[key])
    closest, any_hit = rows_h["k7h"], rows_h["k7h_any"]
    m["k7h"] = dict(closest, launches=closest["launches"] + any_hit["launches"],
                    launches_closest=closest["launches"], launches_any=any_hit["launches"],
                    **k7h)

    log("phase K5: fused forward-gradient megakernel vs its plain version")
    k5_err = phase_fused(dev, False, dict(cornell=scenes["cornell"],
                                          zoo_diffuse=build_zoo(dev, diffuse_only=True)))
    m["k5"] = phase_grad_main(dev)
    m["k5"]["max_abs_err"] = max(m["k5"]["max_abs_err"], k5_err)
    log("phase K6: fused-BVH forward-gradient megakernel vs its plain version")
    k6_err = phase_fused(dev, True, dict(
        cornell_slot=slot_mode(lambda: load_mitsuba_scene(CORNELL, device=dev)[0]),
        mixed=slot_mode(lambda: mixed_scene(dev)), textured=slot_mode(lambda: textured_scene(dev)),
        sphere_field_noenv=build_sphere_field(dev, n_side=2, segs=16, rings=8, sky_hw=None)))
    m["k6"] = phase_grad_bvh(dev)
    m["k6"]["max_abs_err"] = max(m["k6"]["max_abs_err"], k6_err)
    m["k6"]["ptxas"] = {k: v for k, v in ptxas.items() if k.startswith("mega_bvh_grad")}
    wave_err = phase_grad_wavefront(dev)
    m["k2a"]["autograd_max_abs_err"] = wave_err
    m["k7d"]["autograd_max_abs_err"] = phase_sweep_grad(dev, "cluster", "k7d",
                                                        "K7c + K7d, cluster_closest_diff")
    m["k7f"]["autograd_max_abs_err"] = phase_sweep_grad(dev, "dfs", "k7f", "dfs_closest_diff")
    m["k7a"]["autograd_max_abs_err"] = phase_sweep_grad(dev, "binned", "k7a",
                                                        "binned_closest_diff")
    m["k7h"]["autograd_max_abs_err"] = phase_sweep_grad(
        dev, "traverse", "k7h", "intersector mt, traverse_closest_diff", dict(intersector="mt"))
    phase_invert(dev)
    eng = phase_engine(dev)
    for key in ("k2a", "k2b"):
        m[key].update(launches_engine=eng["launches"][key],
                      launched_by_engine=f"Engine.run, {ENGINE_FRAMES} frames of Cornell "
                                         f"{HEADLINE['size']}^2 d{HEADLINE['depth']}",
                      engine_frames_per_s=eng["frames_per_s"])
    sharded = phase_dist(dev)
    for key in ("k1", "k4", "k5", "k6"):
        fn = "render_image_sharded_fast" if key in ("k1", "k4") else "grad_step_sharded_fast"
        m[key].update(launches_dist=sharded[key]["launches"],
                      launched_by_dist=f"{fn} on a one-rank NCCL mesh (1, 1)",
                      ms_sharded=sharded[key]["ms_sharded"],
                      ms_unsharded=sharded[key]["ms_unsharded"])
    w = sharded["k2"]
    m["k2a"].update(launches_dist=w["render"]["launches"]["k2a"] + w["grad"]["launches"]["k2a"],
                    launched_by_dist="render_image_sharded + grad_step_sharded, one-rank mesh")
    m["k2b"].update(launches_dist=w["render"]["launches"]["k2b"] + w["grad"]["launches"]["k2b"],
                    launched_by_dist="render_image_sharded + grad_step_sharded, one-rank mesh")
    log("phase end: every phase passed")
    specs = [
        ("K1 megakernel render_mega_rows", "gpuspectral_tpu_torch/csrc/mega.cu",
         "gpuspectral_tpu/integrator/mega.py:1452", "k1"),
        ("K2a closest_cuda", "gpuspectral_tpu_torch/csrc/isect.cu",
         "gpuspectral_tpu/ops/pallas_isect.py:138", "k2a"),
        ("K2b any_cuda", "gpuspectral_tpu_torch/csrc/isect.cu",
         "gpuspectral_tpu/ops/pallas_isect.py:171", "k2b"),
        ("K3a ftb_closest", "gpuspectral_tpu_torch/csrc/bvh.cu",
         "gpuspectral_tpu/bvh/ftb.py:334", "k3a"),
        ("K3b ftb_any", "gpuspectral_tpu_torch/csrc/bvh.cu",
         "gpuspectral_tpu/bvh/ftb.py:370", "k3b"),
        ("K4 fused-BVH megakernel render_mega_bvh_rows", "gpuspectral_tpu_torch/csrc/mega_bvh.cu",
         "gpuspectral_tpu/integrator/mega_bvh.py:1009", "k4"),
        ("K5 fused forward-gradient megakernel render_mega_fwdgrad_rows",
         "gpuspectral_tpu_torch/csrc/mega_grad.cu",
         "gpuspectral_tpu/integrator/mega_grad.py:417", "k5"),
        ("K6 fused-BVH forward-gradient megakernel render_mega_bvh_fwdgrad_rows",
         "gpuspectral_tpu_torch/csrc/mega_bvh.cu",
         "gpuspectral_tpu/integrator/mega_grad.py:599", "k6"),
        ("K7c cluster_votes", "gpuspectral_tpu_torch/csrc/cluster.cu",
         "gpuspectral_tpu/bvh/cluster_sweep.py:316", "k7c"),
        ("K7d cluster_closest", "gpuspectral_tpu_torch/csrc/cluster.cu",
         "gpuspectral_tpu/bvh/cluster_sweep.py:369", "k7d"),
        ("K7e cluster_any", "gpuspectral_tpu_torch/csrc/cluster.cu",
         "gpuspectral_tpu/bvh/cluster_sweep.py:418", "k7e"),
        ("K7f dfs_closest", "gpuspectral_tpu_torch/csrc/dfs.cu",
         "gpuspectral_tpu/bvh/dfs_sweep.py:427", "k7f"),
        ("K7g dfs_any", "gpuspectral_tpu_torch/csrc/dfs.cu",
         "gpuspectral_tpu/bvh/dfs_sweep.py:474", "k7g"),
        ("K7a binned_closest", "gpuspectral_tpu_torch/csrc/binned.cu",
         "gpuspectral_tpu/bvh/binned.py:409", "k7a"),
        ("K7b binned_any", "gpuspectral_tpu_torch/csrc/binned.cu",
         "gpuspectral_tpu/bvh/binned.py:449", "k7b"),
        ("K7h traverse_closest / traverse_any", "gpuspectral_tpu_torch/csrc/traverse.cu",
         "gpuspectral_tpu/bvh/kernels.py:269", "k7h"),
    ]
    kernels = []
    for kname, src, rep, key in specs:
        # no PyTorch call computes ray-triangle intersection, a path-traced
        # pixel, a supernode vote, a gated walk, a binned vote-and-sweep or
        # a BVH traversal
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=rep, library_ms=None,
                            **m[key]))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
