"""The yardstick of the kernels' roofline shares: a frozen copy of
chip_smoke.py's peaks, operation weights and bound arithmetic (`bound`,
`fused_bound`), with the counts taken by the benchmark's own reference.

A fused kernel's least time is the larger of its operations over the
card's float32 peak and its bytes over the memory bandwidth.  Operations
per ray are tallied on the rays the reference traces (a closest ray's and
a shadow ray's tests, a shaded vertex's work) and multiplied by the rays
the kernel traced; bytes count each table and each output once.
"""

from __future__ import annotations

# the card's published peaks (H100 SXM, float32 outside the tensor cores)
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations, a fused multiply-add counted as two, comparisons not at all
WOOP_FLOPS = 32  # one Woop ray-triangle test
SLAB_FLOPS = 12  # one slab box test: 6 subtractions, 6 products
# one shaded vertex (BSDF sample and eval, light sample, MIS, throughput):
# an estimate, not a count; under 15% of any fused kernel's operations
SHADE_FLOPS = 200
# bytes a pixel lane moves: its pixel id and three radiance planes plus
# the ray count
LANE_BYTES = 4 + 16


def bound_ms(flops: float, n_bytes: float) -> float:
    """The least time in milliseconds: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES_PER_S) * 1e3


def fused_flops(tally_ops: float, tally_hits: int, tally_rays: int, rays: float) -> float:
    """The operations of a fused kernel that traced `rays` rays: the tally's
    tests plus its shaded vertices, per tallied ray, times `rays`."""
    return (tally_ops + tally_hits * SHADE_FLOPS) * rays / max(tally_rays, 1)
