"""Window arithmetic.  A rate is all the work of the window over all its
time; a tail is the tail of every unit the window completed."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    that at least q% of the values do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def beyond(values, q: float) -> int:
    """How many values lie above the q-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)
