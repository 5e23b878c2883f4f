"""The port's own spans in a traced window.

gpuspectral_tpu_torch.utils.profiling.stage leaves a record_function range
in the torch.profiler trace for each span of the port: a host event of
category "user_annotation" whose name starts "gst.", on the profiler's clock
beside the card's kernels.  Here they are clipped to the window as
DeviceTrace clips, and set against the device's activity.  A port without
such spans gives none, and every reader then returns None.

    gst.sync.*   a read-back or upload: the host waits for the device
    self time    a span's duration less the union of the gst.* spans
                 nested in it, each counted once
"""

from __future__ import annotations

from . import kernels

PREFIX = "gst."
SYNC = "gst.sync."


def port_spans(trace) -> list:
    """[(start, end, name)] (microseconds) of the window's gst.* spans."""
    if trace is None:
        return []
    return [(a, b, e["name"]) for a, b, e in trace._clipped(trace.host)
            if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]


def merged(intervals) -> list:
    """Sorted disjoint intervals covering the same time."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def common(xs, ys) -> list:
    """The intervals two sets of intervals share."""
    xs, ys, i, j, out = merged(xs), merged(ys), 0, 0, []
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(trace) -> list:
    """The window's stretches with no kernel, copy or fill on the card."""
    out, end = [], trace.t0
    for a, b in merged((a, b) for a, b, _ in trace._clipped(trace.device)):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if trace.t1 > end:
        out.append((end, trace.t1))
    return out


def self_s(spans, name: str) -> float:
    """Seconds of the spans called `name`, each less the union of the
    other spans nested in it."""
    total = 0.0
    for a, b, n in spans:
        if n == name:
            inner = [(c, d) for c, d, m in spans if a <= c and d <= b and (c, d, m) != (a, b, n)]
            total += (b - a) - length(inner)
    return total * 1e-6


def per_unit_ms(run, name: str):
    """Self time of the spans called `name` a unit of work (ms), or None
    without such spans."""
    spans = port_spans(run.trace)
    if not any(n == name for _, _, n in spans):
        return None
    return self_s(spans, name) / kernels.units(run) * 1e3


def idle_in_port_pct(run):
    """100 x the device's idle time while the host is inside a port span
    but not inside a gst.sync.* span, over all its idle time in the
    window; None without port spans or idle time."""
    spans = port_spans(run.trace)
    if not spans:
        return None
    gaps = idle(run.trace)
    total = length(gaps)
    if total <= 0:
        return None
    in_port = common(gaps, [(a, b) for a, b, _ in spans])
    waiting = common(in_port, [(a, b) for a, b, n in spans if n.startswith(SYNC)])
    return 100.0 * (length(in_port) - length(waiting)) / total


def glue_ms(run, outer: str, others: tuple):
    """Time inside the spans called `outer` and outside every span whose
    name starts with one of `others`, a unit of work (ms); None without
    `outer` spans."""
    spans = port_spans(run.trace)
    inside = [(a, b) for a, b, n in spans if n == outer]
    if not inside:
        return None
    away = [(a, b) for a, b, n in spans if n.startswith(others)]
    return (length(inside) - length(common(inside, away))) * 1e-3 / kernels.units(run)


def syncs_per_unit(run):
    """gst.sync.* spans in the window a unit of work, or None without port
    spans."""
    spans = port_spans(run.trace)
    if not spans:
        return None
    return sum(1 for _, _, n in spans if n.startswith(SYNC)) / kernels.units(run)
