"""PyTorch port: progressive frames (path_tracer.render_step), the Engine
loop, the CLI's `view` and utils/profiling, on the CPU.

render_step against the JAX package's on the same tables (emission only
bit for bit, with bounces under the gates of tests/test_mega.py), K frames
against one render at spp=K (the twin of tests/test_integrator.py:59-66),
resume from a checkpoint bit for bit (the twin of tests/test_io.py:116-135),
the Engine loop with checkpoint/restore and save (the twin of
tests/test_engine.py:9-38), the viewer and its ANSI preview (the twins of
tests/test_engine.py:41-64), and a profiler trace of one frame."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.integrator.path_tracer import render_step as jax_render_step
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.engine import Engine
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.utils import RenderConfig
from gpuspectral_tpu_torch.utils import profiling

from torch_common import CORNELL_XML, assert_mega_gates, jax_scene_arrays

STEP = dict(width=16, height=16, spp=4, ray_batch=256)
FRAMES = 4


@pytest.fixture(scope="module")
def pair(cornell_scene):
    return cornell_scene, scene_from_arrays(*jax_scene_arrays(cornell_scene), "cpu")


def _port_frames(ts, cfg, frames, accum=None, start=0):
    accum = torch.zeros((cfg.height, cfg.width, 3)) if accum is None else accum
    for t in range(start, frames):
        out = pt.render_step(ts, cfg, accum, t)
        assert out is accum  # updated in place
    return accum


# emission only at 32x32: at 16x16 no pixel centre sees the light
@pytest.mark.parametrize("kw", [dict(max_depth=0, nee=False, width=32, height=32, ray_batch=1024),
                                dict(max_depth=3, nee=True)],
                         ids=["emission_only", "depth3_nee"])
def test_render_step_matches_jax(pair, kw):
    js, ts = pair
    kw = dict(STEP, **kw)
    ref = jnp.zeros((kw["height"], kw["width"], 3))
    for t in range(FRAMES):
        ref = jax_render_step(js, JaxConfig(**kw), ref, jnp.uint32(t))
    got = _port_frames(ts, RenderConfig(**kw), FRAMES).numpy()
    ref = np.asarray(ref)
    if kw["max_depth"] == 0:
        assert ref.max() > 0
        np.testing.assert_array_equal(got, ref)
    else:
        assert_mega_gates(ref, got)


def test_progressive_accumulation_matches_batch(pair):
    """K render_step frames == one render_image with spp=K (same seeds)."""
    _, ts = pair
    cfg = RenderConfig(**STEP, max_depth=3)
    batch = pt.render_image(ts, cfg, 0).numpy()
    got = _port_frames(ts, cfg, FRAMES).numpy()
    np.testing.assert_allclose(got, batch, rtol=1e-4, atol=1e-5)


def test_progressive_resume_exact(pair, tmp_path):
    """Interrupt + resume the accumulation through a checkpoint: bit for bit
    an uninterrupted run (running mean + counter-based RNG are stateless)."""
    _, ts = pair
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, ray_batch=64)
    full = _port_frames(ts, cfg, 4)
    half = _port_frames(ts, cfg, 2)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"accum": half.numpy(), "timestamp": np.uint32(2)})
    state = load_checkpoint(path)
    resumed = _port_frames(ts, cfg, 4, torch.tensor(state["accum"]), int(state["timestamp"]))
    torch.testing.assert_close(resumed, full, rtol=0, atol=0)


def test_render_step_nan_keeps_old_value(pair, monkeypatch):
    _, ts = pair
    cfg = RenderConfig(width=4, height=2, spp=1, max_depth=1)
    frame = torch.full((2, 4, 3), 2.0)
    frame[0, 1, 2] = float("nan")
    frame[1, 3] = float("nan")
    monkeypatch.setattr(pt, "render_image", lambda scene, c, t: frame)
    accum = torch.full((2, 4, 3), 1.0)
    pt.render_step(ts, cfg, accum, 3)  # a = 1/4: 1 * 3/4 + 2 / 4
    want = torch.full((2, 4, 3), 1.25)
    want[0, 1, 2] = 1.0
    want[1, 3] = 1.0
    torch.testing.assert_close(accum, want, rtol=0, atol=0)


def test_engine_progressive_loop(tmp_path):
    e = Engine(device="cpu")
    e.init(16, 16, max_depth=2, ray_batch=256)
    e.load_scene(str(CORNELL_XML))
    frames = []
    img = e.run(3, on_frame=lambda t, im: frames.append((t, im)))
    assert img.shape == (16, 16, 3)
    assert [t for t, _ in frames] == [1, 2, 3]
    assert np.isfinite(img).all() and img.max() > 0
    np.testing.assert_array_equal(frames[-1][1], img)
    assert not np.array_equal(frames[0][1], img)  # the callback's images are copies

    # checkpoint mid-run, keep rendering, restore and catch up
    e2 = Engine(device="cpu")
    e2.init(16, 16, max_depth=2, ray_batch=256)
    e2.load_scene(str(CORNELL_XML))
    e2.run(2)
    ck = str(tmp_path / "state.npz")
    e2.checkpoint(ck)
    full = e2.run(1)

    e3 = Engine(device="cpu")
    e3.init(16, 16, max_depth=2, ray_batch=256)
    e3.load_scene(str(CORNELL_XML))
    e3.restore(ck)
    assert e3.timestamp == 2
    resumed = e3.run(1)
    np.testing.assert_array_equal(resumed, full)

    e3.save(str(tmp_path / "out.png"))
    e3.save(str(tmp_path / "out.exr"))
    assert (tmp_path / "out.png").exists() and (tmp_path / "out.exr").exists()


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine()
    assert Engine(device="cpu").device.type == "cpu"


def test_cli_view_progressive(tmp_path, capsys):
    """The headless viewer writes previews and a final image."""
    from gpuspectral_tpu_torch.cli.main import main

    prev = tmp_path / "prev.png"
    out = tmp_path / "final.png"
    rc = main([
        "view", str(CORNELL_XML), "--size", "16x16", "--depth", "2",
        "--frames", "4", "--every", "2", "--preview", str(prev),
        "-o", str(out), "--tonemap", "--ray-batch", "256", "--ansi", "--device", "cpu",
    ])
    assert rc == 0
    assert prev.exists() and out.exists()
    assert "\x1b[38;2;" in capsys.readouterr().out


def test_ansi_preview_matches_jax():
    from gpuspectral_tpu.cli.main import _ansi_preview as jax_preview
    from gpuspectral_tpu_torch.cli.main import _ansi_preview

    img = np.random.default_rng(0).uniform(0, 2, size=(32, 32, 3)).astype(np.float32)
    for rows in (8, 40):
        s = _ansi_preview(img, max_rows=rows)
        assert s == jax_preview(img, max_rows=rows)
    assert "\x1b[38;2;" in s and s.count("\n") >= 3


def test_trace_one_frame(pair, tmp_path):
    """profiling.trace around one 8x8 Engine frame writes a chrome trace
    holding the frame's "Frame" stage; an empty log_dir traces nothing."""
    _, ts = pair
    e = Engine(device="cpu").init(8, 8, max_depth=1, ray_batch=64)
    e.scene = ts
    with profiling.trace(str(tmp_path / "prof")):
        e.run(1)
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "Frame" in names
    with profiling.trace(""):
        e.run(1)
    assert e.timestamp == 2


def test_stage_timer_and_stage_metrics():
    """utils/profiling's registry, which took the place of stage_timer and
    of stage's "stage" metrics event: each stage adds a call and its
    seconds under its name, snapshot lists the names sorted, and the span
    object holds its own duration."""
    profiling.reset()
    for _ in range(3):
        with profiling.stage("a") as span:
            pass
    with profiling.stage("b"):
        pass
    rep = profiling.snapshot()
    assert list(rep) == ["a", "b"]
    assert rep["a"]["calls"] == 3 and rep["b"]["calls"] == 1
    assert rep["a"]["seconds"] >= span.seconds >= 0
    profiling.reset()
    assert profiling.snapshot() == {}


def test_cli_render_profile_writes_trace(tmp_path):
    from gpuspectral_tpu_torch.cli.main import main

    rc = main(["render", str(CORNELL_XML), "--size", "8x8", "--spp", "1", "--depth", "1",
               "-o", str(tmp_path / "o.png"), "--profile", str(tmp_path / "prof"),
               "--device", "cpu"])
    assert rc == 0
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    assert trace["traceEvents"]
