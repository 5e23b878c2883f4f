"""A fused kernel's share of its roofline bound, from the traced window:
its device time a unit of work (frame or step) against the bound of the
counts the reference took (runner.Run.counts)."""

from . import roofline


def units(run) -> int:
    """Units of work in the traced window: its spans, or the steps a driver
    counted when a span holds several."""
    return int(run.extra.get("units_traced", len(run.trace.units)))


def roofline_pct(run, pattern: str, kind: str):
    """100 * bound / (kernel seconds a unit), or None when the trace holds
    no such kernel or the run took no count of `kind`."""
    tr, counts = run.trace, run.counts.get(kind)
    if tr is None or counts is None or not tr.units:
        return None
    sec = tr.kernel_s(pattern) / units(run)
    if sec <= 0:
        return None
    return 100.0 * roofline.bound_ms(counts["flops"], counts["bytes"]) / (sec * 1e3)
