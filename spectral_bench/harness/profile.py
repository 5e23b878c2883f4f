"""Reading a torch.profiler trace of the measured window.

The window is traced with CPU and CUDA activity; the benchmark's own spans
(record_function ranges named "bench.<unit>") mark each unit of work.  The
trace is exported as a chrome trace into TMPDIR, read back here and
deleted.  Device activity is every kernel, copy and fill on the card;
`busy_s` is the length of their union inside the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


def short_name(name: str) -> str:
    """A kernel or op name without its template and parameter lists."""
    s = name.replace("(anonymous namespace)::", "").replace("void ", "")
    s = re.split(r"[(<]", s, maxsplit=1)[0].strip()
    return (s or name)[:80]


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DeviceTrace:
    """Device and host events (microseconds) of one traced window."""

    def __init__(self, events: list, span: str):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
        units = sorted((e for e in self.host
                        if e.get("cat") == "user_annotation" and e.get("name") == span),
                       key=lambda e: e["ts"])
        self.units = units
        if units:
            self.t0 = units[0]["ts"]
            self.t1 = max(e["ts"] + e["dur"] for e in units)
        else:
            self.t0 = self.t1 = 0.0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clipped(self, events):
        for e in events:
            a, b = max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)
            if b > a:
                yield a, b, e

    @property
    def busy_s(self) -> float:
        return _union([(a, b) for a, b, _ in self._clipped(self.device)]) * 1e-6

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the window's kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, e in self._clipped(self.device) if rx.search(e["name"])) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for a, b, e in self._clipped(self.device):
            k = short_name(e["name"])
            tot[k] = tot.get(k, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest stretches of the window with no device activity,
        each named by the innermost host op running at its middle."""
        iv = sorted((a, b) for a, b, _ in self._clipped(self.device))
        gaps, end = [], self.t0
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            around = [e for e in self.host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = short_name(min(around, key=lambda e: e["dur"])["name"]) if around else "host"
            out.append([name, (b - a) * 1e-6])
        return out

    def breakdown(self) -> dict:
        return dict(device_ops=self.top_ops(), idle_gaps=self.idle_gaps())


@contextlib.contextmanager
def traced(enabled: bool, span: str, out: dict):
    """Profile the block when enabled; afterwards out["trace"] holds its
    DeviceTrace (None when not enabled)."""
    out["trace"] = None
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json", prefix="spectral_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = DeviceTrace(events, span)
