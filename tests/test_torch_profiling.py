"""PyTorch port: utils/profiling's spans and counters on the frame and
inversion paths.

On the CPU: the spans of a frame (render_image_stats_auto on K1's and
K4's plain versions), of an inversion, of K5's differentiable render, of
a scene load and of the kernel library's load, nested as the port places
them, in a torch.profiler trace and in the registry; the registry's
count, snapshot and reset, also from many threads; the CLI's --metrics
file ending with the spans.  On the card (marked `cuda`): K1's, K4's and
K5's kernels lie between their launch spans and the read-back that waits
for them (the spans share the profiler's clock with the card), and every
synchronizing runtime call inside a port span lies inside a gst.sync.*
span.

This file imports neither JAX nor the JAX package.
"""

import json
import re
import sys
import threading

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch import _build
from gpuspectral_tpu_torch.diff.invert import invert
from gpuspectral_tpu_torch.integrator import mega_grad as mg
from gpuspectral_tpu_torch.integrator import render_image_stats_auto
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.utils import RenderConfig, profiling

from torch_common import CORNELL_XML, cuda_device  # noqa: F401

EPS_US = 0.01  # chrome traces round ts and dur to the nanosecond
# calls that block the host on the card: the waits, and copies with no Async
# (torch's blocking copies are cudaMemcpyAsync and then cudaStreamSynchronize)
SYNC_CALLS = re.compile(r"^cuda(Stream|Device|Event)Synchronize$|^cudaMemcpy(2D|3D)?(ToSymbol)?$")
STEP_PARTS = ("gst.invert.loss", "gst.invert.backward", "gst.invert.adam", "gst.sync.loss")


@pytest.fixture(scope="module")
def cornell():
    return load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]


def _events(trace_dir):
    return json.loads((trace_dir / profiling.TRACE_FILE).read_text())["traceEvents"]


def _spans(events) -> dict:
    """{name: [(start, end)] in time order} of a trace's gst.* host ranges."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("gst."):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _within(inner, outer) -> bool:
    return outer[0] - EPS_US <= inner[0] and inner[1] <= outer[1] + EPS_US


def test_frame_spans(cornell, tmp_path):
    """An 8x8 frame through render_image_stats_auto with intersector "mega"
    on the CPU (render_mega -> render_mega_rows_ref): its trace holds
    gst.render around the frame's rows (gst.k1.prep) and gst.sync.rays;
    with no profiler running the registry counts each once, and no K1
    launch; the spans change no result."""
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, intersector="mega")
    with profiling.trace(str(tmp_path)):
        img, rays = render_image_stats_auto(cornell, cfg, 0)
    got = _spans(_events(tmp_path))
    (render,), (rows,), (sync,) = got["gst.render"], got["gst.k1.prep"], got["gst.sync.rays"]
    assert _within(rows, render) and _within(sync, render) and rows[1] <= sync[0] + EPS_US
    profiling.reset()
    img2, rays2 = render_image_stats_auto(cornell, cfg, 0)
    snap = profiling.snapshot()
    assert [snap[k]["calls"] for k in ("gst.render", "gst.k1.prep", "gst.sync.rays")] == [1, 1, 1]
    assert snap["gst.render"]["seconds"] >= snap["gst.sync.rays"]["seconds"] > 0
    assert profiling.calls("render_mega_rows.launch") == 0
    assert torch.equal(img, img2) and rays == rays2


def test_k4_frame_spans(cornell, tmp_path):
    """The same frame with use_bvh and intersector "mega_bvh" (render_mega_bvh
    -> render_mega_bvh_rows_ref): K1's frame function, so gst.render holds
    K4's frame rows (gst.k4.prep) and then gst.sync.rays, each counted once
    in the registry, and no kernel launch."""
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, use_bvh=True,
                       intersector="mega_bvh")
    with profiling.trace(str(tmp_path)):
        render_image_stats_auto(cornell, cfg, 0)
    got = _spans(_events(tmp_path))
    (render,), (rows,), (sync,) = got["gst.render"], got["gst.k4.prep"], got["gst.sync.rays"]
    assert _within(rows, render) and _within(sync, render) and rows[1] <= sync[0] + EPS_US
    assert "gst.k1.prep" not in got
    profiling.reset()
    render_image_stats_auto(cornell, cfg, 0)
    snap = profiling.snapshot()
    assert [snap[k]["calls"] for k in ("gst.render", "gst.k4.prep", "gst.sync.rays")] == [1, 1, 1]
    assert not any(k.endswith(".launch") for k in snap if not k.startswith("gst."))


def test_invert_spans(cornell, tmp_path):
    """A two-step invert on the CPU: gst.invert holds gst.invert.setup
    (with the kinds' read-back, one upload each of the mask, the two
    bounds and the target, and the mask's read-back) and
    then two gst.invert.step, each holding its loss, backward pass, Adam
    step and loss read-back in that order; the registry counts the same."""
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1, ray_batch=64)
    target = np.zeros((8, 8, 3), np.float32)
    with profiling.trace(str(tmp_path)):
        invert(cornell, target, cfg, steps=2)
    got = _spans(_events(tmp_path))
    (whole,), (setup,), steps = got["gst.invert"], got["gst.invert.setup"], got["gst.invert.step"]
    assert len(steps) == 2 and all(_within(x, whole) for x in [setup, *steps])
    assert setup[1] <= steps[0][0] + EPS_US
    for name, n in (("gst.sync.kinds", 1), ("gst.sync.upload", 4), ("gst.sync.mask", 1)):
        assert len(got[name]) == n and all(_within(x, setup) for x in got[name])
    for k, step in enumerate(steps):
        parts = [got[name][k] for name in STEP_PARTS]
        assert all(_within(p, step) for p in parts)
        assert all(a[1] <= b[0] + EPS_US for a, b in zip(parts, parts[1:]))
    profiling.reset()
    invert(cornell, target, cfg, steps=2)
    assert {name: profiling.calls(name) for name in ("gst.invert", "gst.invert.setup",
                                                     "gst.invert.step", *STEP_PARTS)} == {
        "gst.invert": 1, "gst.invert.setup": 1, "gst.invert.step": 2,
        **{name: 2 for name in STEP_PARTS}}


def test_k5_diff_spans(cornell):
    """render_mega_diff on the CPU (K5's plain version): the frame's rows
    are a gst.k5.prep span, and the backward pass's contraction is
    gst.grad.contract around the scatter's gst.sync.grad_rows; no K5
    launch."""
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    assert mg.mega_grad_eligible(cornell, cfg)
    params = cornell.bsdf_params.clone().requires_grad_(True)
    profiling.reset()
    mg.render_mega_diff(cornell.replace(bsdf_params=params), cfg, 0).sum().backward()
    snap = profiling.snapshot()
    assert [snap[k]["calls"] for k in ("gst.k5.prep", "gst.grad.contract",
                                       "gst.sync.grad_rows")] == [1, 1, 1]
    assert snap["gst.grad.contract"]["seconds"] >= snap["gst.sync.grad_rows"]["seconds"]
    assert "gst.k5.launch" not in snap and profiling.calls("render_mega_fwdgrad_rows.launch") == 0
    assert params.grad is not None and bool(params.grad[:, 0:3].abs().sum() > 0)


def test_scene_spans():
    """A Mitsuba load with its build is gst.scene.load around the parse,
    the host tables and the upload; a parse alone is gst.scene.parse."""
    profiling.reset()
    load_mitsuba_scene(str(CORNELL_XML), device="cpu")
    snap = profiling.snapshot()
    parts = ("gst.scene.parse", "gst.scene.bvh", "gst.scene.upload")
    assert [snap[k]["calls"] for k in ("gst.scene.load", *parts)] == [1, 1, 1, 1]
    assert snap["gst.scene.load"]["seconds"] >= sum(snap[k]["seconds"] for k in parts)
    profiling.reset()
    load_mitsuba_scene(str(CORNELL_XML), build=False)
    assert list(profiling.snapshot()) == ["gst.scene.parse"]


def test_count_snapshot_reset():
    """count adds calls with no seconds; calls reads 0 for an unknown name;
    a stage records its call also when its block raises, and re-raises;
    snapshot is a sorted copy; reset forgets everything."""
    profiling.reset()
    profiling.count("x.launch")
    profiling.count("x.launch", 3)
    assert profiling.calls("x.launch") == 4 and profiling.calls("missing") == 0
    with pytest.raises(ValueError), profiling.stage("boom"):
        raise ValueError("inside the span")
    snap = profiling.snapshot()
    assert list(snap) == ["boom", "x.launch"]
    assert snap["boom"]["calls"] == 1 and snap["x.launch"] == dict(calls=4, seconds=0.0)
    snap["x.launch"]["calls"] = 0
    assert profiling.calls("x.launch") == 4
    profiling.reset()
    assert profiling.snapshot() == {} and profiling.calls("x.launch") == 0


def test_registry_counts_every_thread():
    """Sixteen threads counting and spanning at once, with the interpreter
    switching threads as often as it can, lose no update (the autograd
    engine records CUDA backward spans from a thread of its own)."""
    n_threads, n = 16, 1000
    profiling.reset()

    def work():
        for _ in range(n):
            profiling.count("t.launch")
            with profiling.stage("t.span"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert profiling.calls("t.launch") == profiling.calls("t.span") == n_threads * n


def test_cli_metrics_end_with_spans(tmp_path):
    """The CLI's --metrics file ends with one event="spans" line holding
    the command's snapshot: for render, its scene load and its frame."""
    from gpuspectral_tpu_torch.cli.main import main

    metrics = tmp_path / "m.jsonl"
    rc = main(["render", str(CORNELL_XML), "--size", "8x8", "--spp", "1", "--depth", "1",
               "-o", str(tmp_path / "o.png"), "--metrics", str(metrics), "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["render", "spans"]
    spans = lines[-1]["spans"]
    assert spans["gst.render"]["calls"] == 1 and spans["gst.scene.load"]["calls"] == 1


def test_kernel_library_load_is_a_span(tmp_path, monkeypatch):
    """The uncached branch of _build.load is the span gst.kernels.load,
    whose seconds build_info reports, and counts kernels.built when nvcc
    ran (nvcc and the library stubbed: this CPU has neither); a load that
    finds the library built counts no build."""

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def compile_stub(out_dir, so, log_path):
        out_dir.mkdir(parents=True, exist_ok=True)
        so.write_bytes(b"")
        log_path.write_text("")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_info", {})
    monkeypatch.setattr(_build, "_compile", compile_stub)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setenv("GST_KERNEL_BUILD_DIR", str(tmp_path))
    profiling.reset()
    lib = _build.load()
    assert isinstance(lib, Lib) and _build.load() is lib
    snap = profiling.snapshot()
    assert snap["gst.kernels.load"]["calls"] == 1 and snap["kernels.built"]["calls"] == 1
    assert _build.build_info()["seconds"] == snap["gst.kernels.load"]["seconds"]
    assert _build.build_info()["built_now"]
    monkeypatch.setattr(_build, "_lib", None)
    _build.load()
    assert profiling.calls("gst.kernels.load") == 2 and profiling.calls("kernels.built") == 1
    assert not _build.build_info()["built_now"]


# ------------------------------------------------------------- on the card


def _kernel(events, pattern):
    (k,) = [e for e in events if e.get("cat") == "kernel" and re.search(pattern, e["name"])]
    return k["ts"], k["ts"] + k["dur"]


def _unspanned_syncs(events) -> list:
    """Synchronizing runtime calls inside a gst.* span but outside every
    gst.sync.* span."""
    spans = _spans(events)
    port = [iv for v in spans.values() for iv in v]
    sync = [iv for k, v in spans.items() if k.startswith("gst.sync.") for iv in v]
    calls = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "cuda_runtime" and SYNC_CALLS.search(e["name"])]
    return [c for c in calls if any(_within(c[:2], p) for p in port)
            and not any(_within(c[:2], s) for s in sync)]


@pytest.mark.cuda
def test_k1_kernel_lies_between_its_spans(cuda_device, tmp_path):  # noqa: F811
    """A profiled 256x256 K1 frame: mega_kernel starts after gst.k1.launch
    begins (after both pieces of gst.k1.prep, the frame's rows and the
    tables) and ends before gst.sync.rays ends, on the profiler's one
    clock; every synchronizing call in the frame's spans is a gst.sync.*
    span's."""
    scene = load_mitsuba_scene(str(CORNELL_XML), device=cuda_device)[0]
    cfg = RenderConfig(width=256, height=256, spp=4, max_depth=4)
    render_image_stats_auto(scene, cfg, 0)  # the kernel library, outside the trace
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        render_image_stats_auto(scene, cfg, 1)
    events = _events(tmp_path)
    got = _spans(events)
    (rows, prep), (launch,), (sync,) = got["gst.k1.prep"], got["gst.k1.launch"], got["gst.sync.rays"]
    k1 = _kernel(events, r"\bmega_kernel\b")
    assert rows[1] <= prep[0] + EPS_US and prep[1] <= launch[0] + EPS_US
    assert launch[0] <= k1[0] and k1[1] <= sync[1]
    assert _unspanned_syncs(events) == []


@pytest.mark.cuda
def test_k4_kernel_lies_between_its_spans(cuda_device, tmp_path):  # noqa: F811
    """Three profiled 256x256 K4 frames of a small One Weekend scene
    (sky-only lighting), two served held tables and one of a scene.replace()
    copy that packs its own: in every frame the two pieces of gst.k4.prep,
    gst.k4.launch and gst.sync.rays lie in gst.render in that order;
    mega_bvh_kernel starts after gst.k4.launch begins and ends before
    gst.sync.rays ends; every synchronizing call in the frames' spans is a
    gst.sync.* span's."""
    from gpuspectral_tpu_torch.scene import SceneBuilder
    from gpuspectral_tpu_torch.scene.data import build_scene
    from gpuspectral_tpu_torch.scene.zoo import populate_one_weekend

    scene = build_scene(populate_one_weekend(SceneBuilder(), grid=2, segs=8, rings=4),
                        cuda_device)
    cfg = RenderConfig(width=256, height=256, spp=4, max_depth=4, use_bvh=True)
    render_image_stats_auto(scene, cfg, 0)  # the kernel library and the tables, untraced
    torch.cuda.synchronize()
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        for s, ts in ((scene, 1), (scene, 2), (scene.replace(), 3)):
            render_image_stats_auto(s, cfg, ts)
    assert profiling.calls("mega_bvh.tables.reused") == 2
    assert profiling.calls("mega_bvh.tables.packed") == 1
    events = _events(tmp_path)
    got = _spans(events)
    k4s = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "kernel" and re.search(r"\bmega_bvh_kernel\b", e["name"]))
    assert [len(got[k]) for k in ("gst.render", "gst.k4.prep", "gst.k4.launch",
                                  "gst.sync.rays")] == [3, 6, 3, 3]
    assert len(k4s) == 3
    for i, render in enumerate(got["gst.render"]):
        rows, prep = got["gst.k4.prep"][2 * i:2 * i + 2]
        launch, sync, k4 = got["gst.k4.launch"][i], got["gst.sync.rays"][i], k4s[i]
        assert all(_within(x, render) for x in (rows, prep, launch, sync))
        assert rows[1] <= prep[0] + EPS_US and prep[1] <= launch[0] + EPS_US
        assert launch[1] <= sync[0] + EPS_US
        assert launch[0] <= k4[0] and k4[1] <= sync[1]
    assert "gst.k1.prep" not in got
    assert _unspanned_syncs(events) == []


@pytest.mark.cuda
def test_k5_kernel_lies_between_its_spans(cuda_device, tmp_path):  # noqa: F811
    """A profiled K5 step of invert at 128x128: mega_grad_kernel starts
    after gst.k5.launch begins and ends before the backward pass's
    gst.sync.grad_rows ends, the first wait for it; every synchronizing
    call in the inversion's spans is a gst.sync.* span's."""
    scene = load_mitsuba_scene(str(CORNELL_XML), device=cuda_device)[0]
    cfg = RenderConfig(width=128, height=128, spp=4, max_depth=4)
    target = np.zeros((128, 128, 3), np.float32)
    invert(scene, target, cfg, steps=1)  # the kernel library, outside the trace
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        invert(scene, target, cfg, steps=1)
    events = _events(tmp_path)
    got = _spans(events)
    (launch,), (sync,) = got["gst.k5.launch"], got["gst.sync.grad_rows"]
    k5 = _kernel(events, r"\bmega_grad_kernel\b")
    assert launch[0] <= k5[0] and k5[1] <= sync[1]
    assert _unspanned_syncs(events) == []
