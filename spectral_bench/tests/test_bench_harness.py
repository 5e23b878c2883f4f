"""CPU tests of the benchmark: the manifest and the files it names, the
window arithmetic, the frozen roofline yardstick, the reference against the
port's plain versions, the control and the planted faults (each must come
out not correct), and the isolation of the run and of the reference.

    python -m pytest -q spectral_bench/tests

Tests marked `cuda` run a cell on the card and skip without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from spectral_bench.harness import compare, isolation, manifest, roofline, stats  # noqa: E402
from spectral_bench.reference import bvh_count, isect, scene_sphere_field, scenes, tracer  # noqa: E402

torch.set_num_threads(2)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_cell(name, **job):
    """A cell of BENCHMARK.json at a small film, for the CPU.  Its limits
    are the small film's: a 32x32 frame's diagonals (exact-t ties at the
    quads' diagonals, broken by another triangle order on each side) are a
    sixteenth of its pixels, and 64 sampled pixels estimate the frame's
    rays to a few per cent."""
    cell = manifest.load_cell(name)
    cell.traffic = dict(cell.traffic, job=dict(cell.traffic["job"], **job), check_pixels=64)
    cell.limits = dict(pixels_off=0.1, mean_gap=0.01, rays_gap=0.1)
    return cell


# ---------------------------------------------------------------- manifest


def test_manifest_keys_names_and_units():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        names.append(metric["name"])
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock",
                                                                          "device_trace")
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e and "\n" not in metric["layer"]
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    assert "setup_s" in e2e


@pytest.mark.parametrize("workload", [w["name"] for w in _manifest()["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = manifest.load_cell(workload)
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(manifest.reader(metric["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert cell.traffic["driver"] in ("frames", "invert")
    reported = [x["name"] for x in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for metric in cell.per_layer:  # a per-layer metric's cell reports what it moves
        assert metric["moves"] in reported


# ---------------------------------------------------------------- arithmetic


def test_window_arithmetic():
    times = [0.1] * 190 + [0.2] * 10
    assert stats.percentile(times, 95) == pytest.approx(0.1)
    assert stats.beyond(times, 95) == 10
    times = [0.1] * 189 + [0.2] * 11
    assert stats.percentile(times, 95) == pytest.approx(0.2)
    assert stats.rate(64 * 1024 * 1024 * 200, 20.0) / 1e6 == pytest.approx(671.08864)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_roofline_yardstick_is_chip_smokes():
    import chip_smoke as cs

    assert (roofline.PEAK_FLOPS, roofline.PEAK_BYTES_PER_S) == (cs.PEAK_FLOPS, cs.PEAK_BYTES_PER_S)
    assert (roofline.WOOP_FLOPS, roofline.SLAB_FLOPS, roofline.SHADE_FLOPS) == (
        cs.WOOP_FLOPS, cs.SLAB_FLOPS, cs.SHADE_FLOPS)
    for flops, n_bytes in ((3.3e9, 1e6), (1e6, 9e9)):
        want = cs.bound(flops, n_bytes)["bound_ms"]
        assert roofline.bound_ms(flops, n_bytes) == pytest.approx(want)


def test_tally_agrees_with_chip_smokes_on_cornell(monkeypatch):
    """The reference's count of K1's work against chip_smoke's WalkTally,
    both on a small Cornell frame on the CPU (the same rays up to exact-t
    ties; shadow tests counted in each scene's own triangle order)."""
    import chip_smoke as cs
    from gpuspectral_tpu_torch.integrator import mega
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils.config import RenderConfig

    w, spp, depth = 16, 2, 12
    path = os.path.join(ROOT, "spectral_bench", "configs", "cornell.xml")
    sc, _ = load_mitsuba_scene(path, device="cpu")
    cfg = RenderConfig(width=w, height=w, spp=spp, max_depth=depth)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ref_cs = cs.tally_rows(sc, cfg, mega.pix_rows(cfg, "cpu"), 11)
    rs = scenes.scene_from_spec({"kind": "mitsuba_xml", "reference_file": path}, ROOT, "cpu")
    mine = tracer.Tally()
    tracer.render_pixels(rs, tracer.RefConfig(width=w, height=w, spp=spp, max_depth=depth),
                         torch.arange(w * w), 11, tally=mine)
    # chip_smoke's rows cover 2 rows of 128 lanes = 256 pixels: the whole frame
    assert ref_cs.closest == pytest.approx(mine.closest, rel=0.02)
    assert ref_cs.shadow == pytest.approx(mine.shadow, rel=0.02)
    assert ref_cs.hits == pytest.approx(mine.hits, rel=0.02)
    assert ref_cs.woop == pytest.approx(mine.woop_tests, rel=0.05)
    ops_cs = cs.fused_bound(ref_cs, 1e9, 0.0)["bound_ms"]
    ops_me = roofline.bound_ms(roofline.fused_flops(mine.woop_tests * roofline.WOOP_FLOPS,
                                                    mine.hits, mine.closest + mine.shadow, 1e9),
                               0.0)
    assert ops_me == pytest.approx(ops_cs, rel=0.05)


# ---------------------------------------------------------------- reference


def test_reference_scenes_match_the_ports():
    from gpuspectral_tpu_torch.scene import SceneBuilder, load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field

    path = os.path.join(ROOT, "spectral_bench", "configs", "cornell.xml")
    b_port = load_mitsuba_scene(path, build=False)
    b_ref, film = scenes.load_mitsuba_xml(path)
    assert film == dict(width=1024, height=1024, spp=64, max_depth=65)
    for b_p, b_r in ((b_port, b_ref), (populate_sphere_field(SceneBuilder()),
                                       scene_sphere_field.sphere_field())):
        for key in ("tri_pos", "tri_nrm", "tri_uv", "tri_bsdf", "tri_emission", "tri_light_idx",
                    "light_pos", "light_emission"):
            assert np.array_equal(np.concatenate(getattr(b_p, key)),
                                  np.concatenate(getattr(b_r, key))), key
        assert np.array_equal(b_p.bsdfs.pack()[1], b_r.bsdfs.pack()[1])
        assert np.array_equal(b_p.cam_to_world, b_r.cam_to_world)
        assert (b_p.envmap_image is None) == (b_r.envmap_image is None)
        if b_p.envmap_image is not None:
            assert np.array_equal(b_p.envmap_image, b_r.envmap_image)
        if b_p.textures:
            assert np.array_equal(np.stack(b_p.textures), np.stack(b_r.textures))


def test_builtin_reference_scenes_are_found_by_name():
    rs = scenes.scene_from_spec({"kind": "builtin", "name": "sphere_field"}, ROOT, "cpu")
    b = scene_sphere_field.sphere_field()
    assert rs.num_tris == sum(len(p) for p in b.tri_pos) and rs.has_envmap
    with pytest.raises(ValueError, match="scene_no_such_scene"):
        scenes.scene_from_spec({"kind": "builtin", "name": "no_such_scene"}, ROOT, "cpu")


def test_reference_matches_the_ports_plain_cornell():
    from gpuspectral_tpu_torch.integrator import path_tracer
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils.config import RenderConfig

    w, spp = 24, 2
    path = os.path.join(ROOT, "spectral_bench", "configs", "cornell.xml")
    sc, _ = load_mitsuba_scene(path, device="cpu")
    cfg = RenderConfig(width=w, height=w, spp=spp, max_depth=65, intersector="woop")
    st = path_tracer.trace_wavefront(sc, cfg, torch.arange(w * w), 4321)
    rs = scenes.scene_from_spec({"kind": "mitsuba_xml", "reference_file": path}, ROOT, "cpu")
    rad, rays = tracer.render_pixels(rs, tracer.RefConfig(width=w, height=w, spp=spp,
                                                          max_depth=65), torch.arange(w * w), 4321)
    n = compare.image_numbers(st["radiance"][None] / spp, rad[None] / spp,
                              [float(st["rays_traced"].double().mean())],
                              [float(rays.double().mean())])
    # the diagonal pixels' rays meet quad diagonals at exact-t ties, which
    # the port breaks by its BVH slot order and the reference by its own
    assert n["pixels_off"] <= 0.02 and n["mean_gap"] <= 2e-3 and n["rays_gap"] <= 0.01


@pytest.mark.parametrize("culled", [False, True])
def test_reference_matches_the_ports_plain_sphere_field(culled, monkeypatch):
    from gpuspectral_tpu_torch.integrator import mega, mega_bvh
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field
    from gpuspectral_tpu_torch.utils.config import RenderConfig

    kw = dict(n_side=2, segs=16, rings=8)
    w, spp = 16, 2
    sc = build_sphere_field(device="cpu", **kw)
    cfg = RenderConfig(width=w, height=w, spp=spp, max_depth=50, use_bvh=True)
    rr, rg, rb, rays_p = mega_bvh.render_mega_bvh_rows_ref(sc, cfg, mega.pix_rows(cfg, "cpu"), 77)
    port = torch.stack([rr, rg, rb], -1).reshape(-1, 3)[:w * w]
    monkeypatch.setattr(isect, "BRUTE_MAX_TRIS", 16 if culled else 10 ** 9)
    rs = scenes.build(scene_sphere_field.sphere_field(**kw), "cpu")
    rad, rays = tracer.render_pixels(rs, tracer.RefConfig(width=w, height=w, spp=spp,
                                                          max_depth=50, tex_mode="corners"),
                                     torch.arange(w * w), 77)
    assert float((port - rad).abs().max()) <= 1e-5
    assert torch.equal(rays_p.reshape(-1)[:w * w].long(), rays)


def test_bvh_walk_finds_the_closest_hits():
    rs = scenes.build(scene_sphere_field.sphere_field(n_side=2, segs=16, rings=8), "cpu")
    tally = tracer.Tally(stride=5)
    tracer.render_pixels(rs, tracer.RefConfig(width=16, height=16, spp=2, tex_mode="corners"),
                         torch.arange(256), 3, tally=tally)
    o, d, lo, hi, anyh = (torch.cat([r[k] for r in tally.rays]) for k in range(5))
    tree = bvh_count.Tree(rs.tri_pos, rs.woop)
    boxes, tris, best = tree.count(o, d, lo, hi, torch.zeros_like(anyh), return_best=True)
    t, _, _, _ = isect.Intersector(rs.woop, rs.tri_pos).closest(o, d, lo, hi)
    assert torch.equal(torch.where(t < isect.BIG, t, hi), torch.minimum(best, hi))
    assert int(tris.sum()) < o.shape[0] * rs.num_tris // 4 and int(boxes.min()) >= 1


# ---------------------------------------------------------------- correct


def _run(cell, program=None, seed=12345678901, seconds=0.5):
    from spectral_bench.drivers import frames

    return frames.run(cell, seed=seed, seconds=seconds, traced=False, device="cpu",
                      t_start=time.time(), program=program)


def test_a_sound_run_is_correct():
    run = _run(small_cell("cornell-frame", width=32, height=32, spp=4))
    assert run.checks and all(ok for *_, ok in run.checks), run.checks


def test_the_control_is_not_correct():
    from spectral_bench.control import ControlFrames

    cell = small_cell("cornell-frame", width=32, height=32, spp=4)
    run = _run(cell, ControlFrames(cell, ROOT, "cpu", 12345678901))
    assert not all(ok for *_, ok in run.checks), run.checks


class _Broken:
    """The port's frames with a fault planted under the timed call."""

    def __init__(self, cell, fault):
        from spectral_bench.drivers import frames

        self.inner = frames.PortFrames(cell, ROOT, "cpu")
        self.cfg, self.fault, self.first = self.inner.cfg, fault, None

    def frame(self, ts):
        from gpuspectral_tpu_torch.integrator import render_image_stats_auto

        if self.fault == "unchanged":  # every frame hands back the first one
            self.first = self.first or self.inner.frame(ts)
            return self.first
        if self.fault == "half":  # half of the samples, the mean over the rest
            return render_image_stats_auto(self.inner.scene,
                                           self.cfg.replace(spp=self.cfg.spp // 2), ts)
        img, rays = self.inner.frame(ts)  # the answer altered where it is made
        return img * 1.001, rays

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(fault):
    cell = small_cell("cornell-frame", width=32, height=32, spp=4)
    run = _run(cell, _Broken(cell, fault))
    assert not all(ok for *_, ok in run.checks), (fault, run.checks)


# ---------------------------------------------------------------- isolation

_ISOLATION = """
import sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from spectral_bench.harness import isolation
{body}
print(",".join(isolation.loaded()) + "|" + ",".join(isolation.loaded({{isolation.PORT}})))
"""


def _loaded(body):
    out = subprocess.run([sys.executable, "-c", _ISOLATION.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, port = out.stdout.strip().splitlines()[-1].split("|")
    return forbidden, port


def test_a_run_loads_no_jax():
    forbidden, port = _loaded("""
from spectral_bench.harness import manifest
from spectral_bench.drivers import frames
cell = manifest.load_cell("cornell-frame")
cell.traffic = dict(cell.traffic, job=dict(cell.traffic["job"], width=16, height=16, spp=2),
                    check_pixels=16)
frames.run(cell, seed=3, seconds=0.2, traced=False, device="cpu", t_start=time.time())
""")
    assert forbidden == "" and port != ""


def test_the_reference_loads_nothing_of_the_port():
    forbidden, port = _loaded("""
from spectral_bench.reference import scenes, scene_sphere_field, tracer, bvh_count
rs = scenes.build(scene_sphere_field.sphere_field(n_side=1, segs=8, rings=4), "cpu")
tracer.render_pixels(rs, tracer.RefConfig(width=8, height=8, spp=1), torch.arange(64), 0)
""")
    assert forbidden == "" and port == ""


def test_isolation_compares_whole_top_level_names():
    mods = ["gpuspectral_tpu_torch", "gpuspectral_tpu_torch.scene", "jaxtyping", "jax.numpy",
            "gpuspectral_tpu.ops"]
    assert isolation.loaded(modules=mods) == ["gpuspectral_tpu.ops", "jax.numpy"]


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in _manifest()["workloads"]
                                      if w["chips"] == 1])
def test_a_cell_runs_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "spectral_bench/run.py", "--workload", workload,
                          "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


# ---------------------------------------------------------------- inversion


def small_invert_cell():
    """cornell-invert at 32x32, 8 spp, with limits of that size (the
    port's CPU path differentiates by autograd, the reference by the
    counting identity)."""
    cell = manifest.load_cell("cornell-invert")
    cell.traffic = dict(cell.traffic, job=dict(cell.traffic["job"], width=32, height=32, spp=8))
    cell.limits = dict(loss_gap=1e-4, grad_gap=0.02, descent_gap=0.05, adam_gap=1e-4)
    return cell


@contextlib.contextmanager
def _planted_adam(fault):
    """torch.optim.Adam, as invert builds it, with a fault planted: its step
    goes uphill, or it restarts its moments at every step."""
    orig = torch.optim.Adam

    def adam(*args, **kwargs):
        if fault == "uphill":
            return orig(*args, maximize=True, **kwargs)
        opt = orig(*args, **kwargs)
        opt.register_step_pre_hook(lambda o, a, k: o.state.clear())
        return opt

    if fault in ("uphill", "adam_reset"):
        torch.optim.Adam = adam
    try:
        yield
    finally:
        torch.optim.Adam = orig


class _BrokenInvert:
    """The port's invert with a fault planted under the timed call."""

    def __init__(self, cell, fault):
        from spectral_bench.drivers import invert

        target, p0 = invert.inputs(cell, ROOT, 12345678901, "cpu")
        self.inner = invert.PortInvert(cell, ROOT, "cpu", target, p0)
        self.cfg, self.scene_load_s, self.fault = self.inner.cfg, 0.0, fault
        self.p0 = self.inner.params

    @property
    def params(self):
        return self.inner.params

    def chunk(self, steps, timestamp0):
        if self.fault == "unchanged":  # a step that leaves the parameters as they were
            self.inner.lr = 0.0
        if self.fault == "half":  # half of the samples, the mean over the rest
            self.inner.cfg = self.cfg.replace(spp=self.cfg.spp // 2)
        if self.fault == "stale":  # a chunk that drops the parameters it was handed
            self.inner.params = self.p0
        with _planted_adam(self.fault):
            history = self.inner.chunk(steps, timestamp0)
        if self.fault == "altered":  # the loss altered where it is produced
            history = [x * 1.001 for x in history]
        return history

    def close(self):
        self.inner.close()


def _run_invert(cell, program=None, seed=12345678901):
    from spectral_bench.drivers import invert

    return invert.run(cell, seed=seed, seconds=0.2, traced=False, device="cpu",
                      t_start=time.time(), program=program)


def test_a_sound_inversion_is_correct():
    run = _run_invert(small_invert_cell())
    assert all(ok for *_, ok in run.checks), run.checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "uphill", "adam_reset",
                                   "stale"])
def test_a_planted_inversion_fault_is_not_correct(fault):
    cell = small_invert_cell()
    run = _run_invert(cell, _BrokenInvert(cell, fault))
    assert not all(ok for *_, ok in run.checks), (fault, run.checks)


def test_plain_adam_is_torchs():
    from spectral_bench.drivers import invert

    g = torch.Generator().manual_seed(5)
    u = torch.zeros(7, requires_grad=True)
    opt = torch.optim.Adam([u], lr=0.02)
    grads, updates = [torch.randn(7, generator=g) for _ in range(4)], []
    for gk in grads:
        before = u.detach().clone()
        u.grad = gk.clone()
        opt.step()
        updates.append(u.detach() - before)
    for d, a in zip(updates, invert.plain_adam(grads, 0.02)):
        assert torch.allclose(d.double(), a, rtol=1e-5, atol=1e-9)


def test_a_nan_in_a_later_step_fails_adam_gap():
    from spectral_bench.drivers import invert

    grads = [torch.tensor([1.0, -2.0]), torch.tensor([0.5, 1.0])]
    steps = [u.float() for u in invert.plain_adam(grads, 0.02)]
    sound = invert.numbers(1.0, grads, steps, 1.0, grads[0], steps[0], 0.02)
    assert sound["adam_gap"] < 1e-6 and sound["descent_gap"] < 1e-6
    steps[1] = torch.tensor([float("nan"), 0.0])
    broken = invert.numbers(1.0, grads, steps, 1.0, grads[0], steps[0], 0.02)
    assert not compare.judge(broken, dict(adam_gap=1e-3))[0][3]


def test_the_inversion_control_is_not_correct(capsys):
    from spectral_bench import control

    cell = small_invert_cell()
    control.invert_readings(cell, 12345678901, "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["control"] for x in lines] == ["control", "half_samples", "loss_altered",
                                             "sign_flipped", "step_left_out"]
    assert not any(x["correct"] for x in lines), lines
