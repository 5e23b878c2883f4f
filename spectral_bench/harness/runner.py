"""One run of one cell: find the cell's files by name, check for the cards
it asks for, hand it to its traffic's driver, read its metrics and print
the result.

Exit codes: 0 with a result line; 2 when the cell's files or entries are
missing; 3 when CUDA or the cards the cell asks for are missing; 4 when
the process loaded JAX or the JAX package.  Only exit 0 prints to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Optional

from . import isolation, manifest, stats


@dataclasses.dataclass
class Run:
    """What a driver measured and checked; the metric readers read it."""

    cell: manifest.Cell
    seed: int
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    unit_s: list = dataclasses.field(default_factory=list)  # each unit's wall time
    unit_work: list = dataclasses.field(default_factory=list)  # paths or steps a unit completed
    attempted: int = 0
    failed: int = 0
    scene_load_s: Optional[float] = None
    memory_peak_bytes: int = 0
    trace: object = None  # profile.DeviceTrace of the window in a traced run
    counts: dict = dataclasses.field(default_factory=dict)  # roofline counts per kind
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit, ok)
    extra: dict = dataclasses.field(default_factory=dict)


def process_start() -> float:
    """The wall-clock time this process started (from /proc, else now)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def cache_env(root: str) -> None:
    """Keep the port's build caches at fixed paths inside the checkout."""
    os.environ["GST_KERNEL_BUILD_DIR"] = os.path.join(root, "build", "spectral_bench", "kernels")
    os.environ["GST_NATIVE_BUILD_DIR"] = os.path.join(root, "build", "spectral_bench", "native")


def result(run: Run, device: dict) -> dict:
    """The result line: the cell's end-to-end metrics, or in a traced run
    its per-layer metrics (a reader that finds nothing is left out)."""
    metrics = {}
    for m in (run.cell.per_layer if run.traced else run.cell.end_to_end):
        v = manifest.reader(m["name"])(run)
        if v is None and not run.traced:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    out = dict(correct=all(ok for *_, ok in run.checks) and bool(run.checks),
               attempted=run.attempted, failed=run.failed, metrics=metrics, device=device)
    if run.traced and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: dict(value=v, limit=lim) for name, v, lim, _ in run.checks}
    return out


def device_info(run: Run, chips: int) -> dict:
    import torch

    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
               memory_peak_bytes=int(run.memory_peak_bytes))
    if run.traced and run.trace is not None:
        dev["busy_s"] = float(run.trace.busy_s)
        dev["window_s"] = float(run.trace.window_s)
    return dev


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = manifest.load_cell(args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        print(f"spectral_bench: cannot load cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"spectral_bench: cell {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 3
    cache_env(manifest.ROOT)
    torch.set_num_threads(1)  # the host's cores are shared: one thread steadies the window
    driver = importlib.import_module(f"spectral_bench.drivers.{cell.traffic['driver']}")
    run = driver.run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                     device="cuda", t_start=t_start)
    out = result(run, device_info(run, cell.chips))
    bad = isolation.loaded()
    if bad:
        print(f"spectral_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    if run.unit_s:
        print(f"window {run.window_s!r} s: {len(run.unit_s)} units, {stats.beyond(run.unit_s, 95)} "
              f"beyond their 95th percentile; set-up {run.setup_s!r} s", file=sys.stderr)
    for name, v, lim, ok in run.checks:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
