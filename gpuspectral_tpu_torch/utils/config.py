"""Render configuration.

The reference hardcodes every knob (SURVEY.md §5.6): window 500x500 in
main.cpp:16, MAX_DEPTH 50 / RR start 10 / firefly clamp 20 in
raygen.rgen:27,60-71, NEE as a compile-time shader constant
(rayhit.rchit:656).  Here they are a frozen dataclass with the same fields
and defaults as gpuspectral_tpu.utils.config.RenderConfig, so one set of
keyword arguments drives both packages.  Fields that steer parts of the JAX
package this port does not have yet (BVH kernels, ray sorting, gradient
remat, the fused-BVH megakernel) are kept so configs stay interchangeable;
the port raises NotImplementedError where one of them asks for such a part.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 64
    max_depth: int = 50  # raygen.rgen:27
    rr_start_depth: int = 10  # raygen.rgen:66
    rr_clamp_min: float = 0.05  # raygen.rgen:67
    firefly_clamp: float = 20.0  # raygen.rgen:60
    nee: bool = True  # rayhit.rchit:656
    jitter: bool = False  # reference does not subpixel-jitter
    shadow_epsilon: float = 0.01  # rayhit.rchit:745-747
    origin_epsilon: float = 1e-4  # rayhit.rchit:793
    ray_batch: int = 8192  # rays processed per wavefront batch
    tri_chunk: int = 512  # triangles per intersection block
    use_bvh: bool = False  # hierarchical traversal (bvh/) vs brute force
    packet_size: int = 1024  # rays per BVH traversal packet
    # "auto": the CUDA kernels for CUDA tensors (the megakernel where
    # eligible, else the wavefront on the brute-force kernel), the plain
    # torch versions for CPU tensors.  "woop" forces the plain torch Woop
    # scan, "mt" the Moller-Trumbore scan (with use_bvh either runs the torch
    # packet traversal), "pallas" the intersection kernels, "mega" the
    # megakernel.
    intersector: str = "auto"
    # BVH Pallas kernel: "ftb" (front-to-back per-(ray,bin) entry-distance
    # traversal with per-lane t-culling, bvh/ftb.py — the round-3 default),
    # "binned" (per-ray-vote grouped sweeps in index order, bvh/binned.py),
    # "cluster" (dense static votes + gated linear sweep) or "dfs" (gated
    # depth-first walk with dynamic occlusion culling)
    bvh_kernel: str = "ftb"
    # reverse-mode remat granularity for differentiable renders:
    # "bounce" re-runs each bounce during backward (path replay, minimal
    # memory); "sample" stores per-bounce residuals within one sample and
    # replays only across samples (~1.5x faster backward, needs
    # O(depth x rays) residual memory)
    grad_remat: str = "bounce"
    # periodic wavefront re-sorting by direction octant + origin Morton key:
    # restores packet coherence for BVH traversal on bounced rays (the EP/
    # queue-compaction analogue, SURVEY.md §2.3); irrelevant to brute force
    sort_rays: bool = False
    sort_interval: int = 4  # bounce iterations between sorts
    # sort NEE shadow rays by segment endpoint (sampled light point) + origin
    # Morton key before the BVH any-hit kernel: shadow rays from one block
    # fan out to different lights, so the path-state sort leaves them
    # incoherent (measured 1.8x fewer supernode votes per block, staircase2)
    shadow_sort: bool = True
    # share the NEE light PICK across aligned groups of this many lanes
    # (0 = per-lane, the reference's semantics).  Unbiased (each lane's pick
    # keeps its marginal distribution) but correlated across the block; turns
    # a block's shadow rays into a coherent beam toward one light, collapsing
    # BVH vote unions.  Enable for BVH-scale scenes.
    light_block: int = 0
    # "uniform" matches the reference (rayhit.rchit:148: randPcg % numLights);
    # "power" importance-samples lights by emitted power (lower variance on
    # many-light scenes, identical expectation)
    light_sampling: str = "uniform"
    # "reference" reproduces the reference's MIS complement weight, which
    # reuses the pdf of its *NEE light sample* (rayhit.rchit:786) — an
    # approximation that overcounts emitter hits.  "exact" computes the true
    # light pdf of the actual BSDF-ray hit point, converging to ground truth.
    mis_mode: str = "reference"
    # --- fused-BVH megakernel (integrator/mega_bvh.py) knobs ---
    # block-synchronous sample regeneration: a block starts sample s+1 only
    # once ALL its lanes finished sample s.  Trades lane occupancy for
    # traversal coherence (every live lane sits at the same depth, so the
    # block's front-to-back bin union stays per-depth-tight)
    mega_sync_regen: bool = False
    # debug: cap front-to-back traversal rounds per query (0 = exact).  A
    # nonzero cap biases the image (misses hits in unswept bins) — perf
    # probing only: the time-vs-cap curve separates per-round cost from
    # effective round count
    debug_rounds_cap: int = 0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
