"""Profiling / tracing (port of gpuspectral_tpu/utils/profiling.py; SURVEY.md
§5.1 — the Tracy equivalent).

The reference instruments with Tracy: frame marks around Renderer::run and
CPU/GPU zones named after framegraph passes (Renderer.cpp:94,115,
FrameGraph.cpp:258, VulkanDriver.cpp:263).  Here the same roles map to:

  * `trace(log_dir)` runs torch.profiler over the host and, where a CUDA
    device is present, the card's kernels, and writes a chrome trace
    (Perfetto / chrome://tracing) into log_dir,
  * `stage(name)` scopes carry the reference's pass names ("Frame") as
    torch.profiler record_function ranges and, on the card, NVTX ranges, so
    traces line up with Tracy captures,
  * `stage_timer` gives coarse host-side wall-clock stage timing for
    environments without a trace viewer.

Nothing records unless asked: without a running profiler a record_function
range costs a few microseconds, and trace() with an empty log_dir does
nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from .metrics import MetricsLogger

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace into log_dir/TRACE_FILE if log_dir is
    given (CUDA activity too when a CUDA device is present); no-op
    otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def stage(name: str, metrics: Optional[MetricsLogger] = None):
    """Named host-side stage: a record_function range (plus an NVTX range
    where a CUDA device is present) and wall-clock logging."""
    t0 = time.time()
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            scopes.enter_context(torch.cuda.nvtx.range(name))
        yield
    if metrics is not None:
        metrics.log(event="stage", stage=name, seconds=time.time() - t0)


class stage_timer:
    """Accumulating per-stage wall-clock timer (host side)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: dict(seconds=self.totals[name], calls=self.counts[name])
            for name in sorted(self.totals)
        }
