"""The readers of the port's own spans (harness/spans.py and the metrics
that use it) on planted traces: the device's idle time put down to a port
span, to a gst.sync.* span inside one, or to the harness; self time with
nested children counted once; syncs over units; the window's clipping;
and None from every reader when the trace holds no gst.* span.

    python -m pytest -q spectral_bench/tests/test_port_spans.py
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from spectral_bench.harness import manifest, spans  # noqa: E402
from spectral_bench.harness.profile import DeviceTrace  # noqa: E402
from spectral_bench.harness.runner import Run  # noqa: E402

TRACE_READERS = ("k1_prep_ms", "idle_in_port_pct.render", "host_syncs_per_unit.render",
                 "k5_prep_ms", "grad_glue_host_ms", "idle_in_port_pct.grad",
                 "host_syncs_per_unit.grad")


def ev(cat, name, ts, end):
    return dict(cat=cat, name=name, ts=float(ts), dur=float(end - ts))


def span(name, ts, end):
    return ev("user_annotation", name, ts, end)


def kernel(ts, end):
    return ev("kernel", "mega_kernel", ts, end)


def run_of(events, unit="bench.frame", **extra) -> Run:
    run = Run(cell=None, seed=0, traced=True)
    run.trace = DeviceTrace(events, unit)
    run.extra.update(extra)
    return run


def frames() -> list:
    """Two frames of 100 us.  The card runs K1 at 10-60 and 110-160; it
    is idle 0-10, 60-110 and 160-200 (100 us).  Frame 1: gst.render 5-80,
    its prep 5-9, launch 9-11, the ray total's read-back 12-70.  Frame 2:
    gst.render 105-190, prep 105-108 (with the kernel library's first load
    106-107 nested in it), launch 108-111, read-back 112-170.  The rest is
    the harness's."""
    return [
        span("bench.frame", 0, 100), span("bench.frame", 100, 200),
        kernel(10, 60), kernel(110, 160),
        ev("cuda_runtime", "cudaStreamSynchronize", 12, 70),
        ev("cpu_op", "aten::index", 80, 100),
        span("gst.render", 5, 80), span("gst.k1.prep", 5, 9), span("gst.k1.launch", 9, 11),
        span("gst.sync.rays", 12, 70),
        span("gst.render", 105, 190), span("gst.k1.prep", 105, 108),
        span("gst.kernels.load", 106, 107), span("gst.k1.launch", 108, 111),
        span("gst.sync.rays", 112, 170),
    ]


def test_idle_is_put_down_to_the_port_its_waits_and_the_harness():
    """Idle inside a port span and no sync span: 5-10 (prep, launch),
    70-80, 105-110 (prep, launch), 170-190: 40 of the 100 idle us.  Inside
    a sync span (60-70, 160-170) and outside every port span (0-5, 80-105,
    190-200) it is not the port's own."""
    run = run_of(frames())
    assert spans.length(spans.idle(run.trace)) == pytest.approx(100.0)
    assert spans.idle_in_port_pct(run) == pytest.approx(40.0)
    for name in ("idle_in_port_pct.render", "idle_in_port_pct.grad"):
        assert manifest.reader(name)(run) == pytest.approx(40.0)


def test_self_time_subtracts_nested_children_once():
    """A span of 10 us with a child 1-4, a grandchild 2-3 inside it and a
    second child 3-6 overlapping the first: its self time is 10 - 5."""
    tree = [(0.0, 10.0, "gst.a"), (1.0, 4.0, "gst.b"), (2.0, 3.0, "gst.c"),
            (3.0, 6.0, "gst.d"), (20.0, 30.0, "gst.a")]
    assert spans.self_s(tree, "gst.a") == pytest.approx((5.0 + 10.0) * 1e-6)
    assert spans.self_s(tree, "gst.b") == pytest.approx(2.0 * 1e-6)
    # K1's prep: 4 us, and 3 us less the nested 1 us of the library's load
    run = run_of(frames())
    assert manifest.reader("k1_prep_ms")(run) == pytest.approx((4.0 + 2.0) / 2 * 1e-3)


def test_syncs_are_counted_over_the_units():
    run = run_of(frames())
    assert manifest.reader("host_syncs_per_unit.render")(run) == pytest.approx(1.0)
    chunk = run_of([span("bench.chunk", 0, 1000), kernel(0, 900),
                    *(span("gst.sync.loss", 100 * k, 100 * k + 10) for k in range(1, 7))],
                   unit="bench.chunk", units_traced=4)
    assert manifest.reader("host_syncs_per_unit.grad")(chunk) == pytest.approx(6 / 4)


def test_glue_is_the_inversion_less_k5_and_its_waits():
    """One chunk of 4 steps: gst.invert 10-990 (980 us) holds K5's prep
    and launch (100-150 and 150-160, 500-560) and two waits (200-400, and
    550-700, which overlaps the second prep by 10 us, counted once): glue
    = 980 - 60 - 200 - 200 = 520 us over 4 steps."""
    events = [span("bench.chunk", 0, 1000), kernel(150, 900),
              span("gst.invert", 10, 990), span("gst.k5.prep", 100, 150),
              span("gst.k5.launch", 150, 160), span("gst.k5.prep", 500, 560),
              span("gst.sync.grad_rows", 200, 400), span("gst.sync.loss", 550, 700)]
    run = run_of(events, unit="bench.chunk", units_traced=4)
    assert manifest.reader("grad_glue_host_ms")(run) == pytest.approx(520.0 / 4 * 1e-3)
    assert manifest.reader("k5_prep_ms")(run) == pytest.approx(110.0 / 4 * 1e-3)


def test_spans_are_clipped_to_the_window():
    """A port span that starts before the window counts from its start;
    one wholly outside counts nothing."""
    events = [span("bench.frame", 0, 100), kernel(50, 100),
              span("gst.render", -40, -10), span("gst.render", -20, 30)]
    run = run_of(events)
    assert spans.port_spans(run.trace) == [(0.0, 30.0, "gst.render")]
    assert spans.idle_in_port_pct(run) == pytest.approx(60.0)


def test_every_reader_returns_none_without_port_spans():
    """A trace of a port with no gst.* span (the parent of the spans, or a
    run without a trace) reads None, as the other per-layer readers do."""
    bare = run_of([span("bench.frame", 0, 100), kernel(10, 60),
                   ev("cpu_op", "aten::index", 60, 90)])
    untraced = Run(cell=None, seed=0, traced=False)
    for name in TRACE_READERS:
        assert manifest.reader(name)(bare) is None
        assert manifest.reader(name)(untraced) is None


def test_scene_host_s_reads_the_registry():
    """scene_host_s: the registry's scene load less its upload; None when
    the registry holds no scene load."""
    from gpuspectral_tpu_torch.utils import profiling

    read = manifest.reader("scene_host_s")
    run = Run(cell=None, seed=0, traced=True)
    profiling.reset()
    assert read(run) is None
    with profiling.stage("gst.scene.load") as load:
        with profiling.stage("gst.scene.upload") as upload:
            pass
    assert read(run) == pytest.approx(load.seconds - upload.seconds)
    profiling.reset()
