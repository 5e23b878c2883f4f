"""The benchmark's data: BENCHMARK.json and the files it names by name.

    configs/<config>.json     a configuration (a scene and how it renders)
    traffic/<traffic>.json    a traffic mix (the job and its driver module)
    limits/<workload>.json    the limits of a cell's comparison
    metrics/<metric>.py       a metric's reader: read(run) -> float | None

A cell is found by its name; everything else follows from names, so a new
cell, configuration, traffic mix or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything its name leads to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload`; raises FileNotFoundError or KeyError when
    a file or an entry is missing."""
    manifest = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = os.path.join(root, "spectral_bench")
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(bench, "traffic", entry["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench, "limits", workload + ".json"))
    return Cell(name=workload, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)])


def reader(metric: str, root: str = ROOT):
    """The read(run) function of metrics/<metric>.py (the name may hold
    dots, so the file is loaded by path)."""
    path = os.path.join(root, "spectral_bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"spectral_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
