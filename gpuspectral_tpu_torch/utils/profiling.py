"""Profiling / tracing (port of gpuspectral_tpu/utils/profiling.py; SURVEY.md
§5.1 — the Tracy equivalent).

The reference instruments with Tracy: frame marks around Renderer::run and
CPU/GPU zones named after framegraph passes (Renderer.cpp:94,115,
FrameGraph.cpp:258, VulkanDriver.cpp:263).  Here the same roles map to:

  * `trace(log_dir)` runs torch.profiler over the host and, where a CUDA
    device is present, the card's kernels, and writes a chrome trace
    (Perfetto / chrome://tracing) into log_dir,
  * `stage(name)` spans the layer boundaries of the port ("Frame", and the
    "gst.*" spans of the frame and inversion paths): a torch.profiler
    record_function range, on the profiler's clock beside the card's
    kernels; on the card an NVTX range; and the call and its
    time.perf_counter seconds in the process's registry,
  * `count(name, n)` counts what has no span (a kernel's launches,
    "<function>.launch"; "kernels.built" when nvcc ran),
  * `snapshot()`, `calls(name)` and `reset()` read and clear the registry:
    the operator's view without a trace viewer (the CLI's --metrics file
    ends with it as an event="spans" line).

Span names are constant strings.  A span never synchronizes the device or
allocates on it: with no profiler running it costs a record_function enter
and exit, an NVTX push and pop, and a dict update under a lock (the
autograd engine runs CUDA backward passes on a thread of its own).
trace() with an empty log_dir does nothing.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"

_LOCK = threading.Lock()
_REGISTRY: dict = {}  # name -> [calls, seconds]


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


@functools.cache
def _nvtx() -> bool:
    return torch.cuda.is_available()


def _add(name: str, calls: int, seconds: float) -> None:
    with _LOCK:
        rec = _REGISTRY.get(name)
        if rec is None:
            _REGISTRY[name] = [calls, seconds]
        else:
            rec[0] += calls
            rec[1] += seconds


class stage:
    """A named span: `with stage("gst.render"): ...`.  The context value
    is the span itself, whose `seconds` holds its duration once it exits."""

    __slots__ = ("name", "seconds", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "stage":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if _nvtx():
            torch.cuda.nvtx.range_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        _add(self.name, 1, self.seconds)
        return False


def count(name: str, n: int = 1) -> None:
    """Add n calls to the counter `name` (a counter has no seconds)."""
    _add(name, n, 0.0)


def calls(name: str) -> int:
    """The calls of span or counter `name` since the last reset (0 if none)."""
    with _LOCK:
        rec = _REGISTRY.get(name)
        return rec[0] if rec else 0


def snapshot() -> dict:
    """{name: {"calls": int, "seconds": float}} of every span and counter
    since the last reset, names sorted."""
    with _LOCK:
        return {k: dict(calls=v[0], seconds=v[1]) for k, v in sorted(_REGISTRY.items())}


def reset() -> None:
    """Forget every span and counter."""
    with _LOCK:
        _REGISTRY.clear()
