"""PyTorch port: inverse rendering (diff/invert.py) recovers albedo and
light radiance and stays in its domain (tests/test_gradients.py:32, 105,
127, on the port); torch.optim.Adam steps as optax.adam does; the CLI's
invert and gradcheck commands run on the CPU."""

import json

import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu_torch.diff import gradcheck as tgc
from gpuspectral_tpu_torch.diff.invert import (gradient_path, invert, optimizable_mask,
                                               param_bounds)
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import CORNELL_XML

BASE = dict(width=16, height=16, spp=8, max_depth=2, ray_batch=2048, grad_remat="sample")


@pytest.fixture(scope="module")
def cornell():
    return load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]


def test_adam_matches_optax():
    """The same 10 gradients through optax.adam and torch.optim.Adam, at
    invert's default learning rate, give the same parameters: both use eps
    1e-8 and bias correction.  Tolerance 2e-6 (5 ulps at these magnitudes;
    measured 1.19e-6): optax forms the bias correction 1 - 0.999^t in
    float32, where the cancellation leaves a relative error of up to ~6e-5
    in each step, and torch forms it in double."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(8, 12)).astype(np.float32)
    grads = [rng.normal(scale=0.1, size=p0.shape).astype(np.float32) for _ in range(10)]
    lr = 0.02
    opt = optax.adam(lr)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    pt = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([pt], lr=lr)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.as_tensor(g)
        topt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=2e-6, rtol=0)


def test_recovers_albedo(cornell):
    """Adam on the autograd gradient recovers the perturbed diffuse albedo
    (tests/test_gradients.py:32)."""
    cfg = RenderConfig(**BASE)
    with torch.no_grad():
        target = tgc.render_mean(cornell, cfg)
    p0 = cornell.bsdf_params.numpy().copy()
    diffuse = cornell.bsdf_kind.numpy() == 0
    p0[diffuse, 0:3] = np.clip(p0[diffuse, 0:3] + 0.2, 0.05, 0.95)
    params = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([params], lr=0.02)
    losses = []
    for _ in range(40):
        loss, g = tgc._loss_and_grad(cornell, cfg, params.detach(), target)
        params.grad = g
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.15, losses[::8]
    np.testing.assert_allclose(params.detach().numpy()[2, 0:3], cornell.bsdf_params.numpy()[2, 0:3],
                               atol=0.08)


def test_invert_stays_in_domain(cornell):
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2, ray_batch=64)
    params, history = invert(cornell, np.zeros((8, 8, 3), np.float32), cfg, steps=6, lr=1.0)
    kinds = cornell.bsdf_kind.numpy()
    mask = optimizable_mask(kinds)
    lo, hi = param_bounds(kinds)
    p = params.numpy()
    assert len(history) == 6 and np.isfinite(history).all()
    assert np.all(p[mask] >= lo[mask] - 1e-6) and np.all(p[mask] <= hi[mask] + 1e-6)
    np.testing.assert_array_equal(p[~mask], cornell.bsdf_params.numpy()[~mask])


def test_invert_recovers_light_radiance(cornell):
    cfg = RenderConfig(**BASE)
    with torch.no_grad():
        target = tgc.render_mean(cornell, cfg).reshape(16, 16, 3)
    true_emit = cornell.light_emission.numpy()
    init = np.maximum(true_emit * 0.4, 1e-4)
    (params, emit), history = invert(
        cornell, target, cfg, steps=80, lr=0.3, optimize_emission=True, init_emission=init,
        optimize_bsdf=False, timestamp0=0, resample=False)
    assert history[-1] < history[0] * 0.05, history[::8]
    lit = true_emit.sum(-1) > 0
    np.testing.assert_allclose(emit.numpy()[lit], true_emit[lit], rtol=0.15)


def test_invert_checkpoints(cornell, tmp_path):
    from gpuspectral_tpu_torch.io.checkpoint import latest_checkpoint, load_checkpoint

    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1, ray_batch=64)
    invert(cornell, np.zeros((8, 8, 3), np.float32), cfg, steps=4, checkpoint_dir=str(tmp_path),
           checkpoint_every=2)
    ck = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert int(ck["step"]) == 4 and ck["params"].shape == tuple(cornell.bsdf_params.shape)


def test_gradient_path_on_cpu_is_the_wavefront(cornell):
    mask = optimizable_mask(cornell.bsdf_kind.numpy())
    assert gradient_path(cornell, RenderConfig(**BASE), mask, False) == "wavefront"


def test_cli_invert_and_gradcheck(tmp_path, capsys):
    from gpuspectral_tpu_torch.cli.main import main

    rc = main(["invert", str(CORNELL_XML), "--device", "cpu", "--size", "8x8", "--spp", "2",
               "--depth", "2", "--steps", "3", "--metrics", str(tmp_path / "m.jsonl")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["steps"] == 3 and out["mean_param_error"] is not None
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [x["event"] for x in lines] == ["invert_step"] * 3 + ["spans"]
    rc = main(["gradcheck", str(CORNELL_XML), "--device", "cpu", "--size", "8x8", "--spp", "4"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["allclose"] and report["emission"]["checked"] >= 1
    assert main(["gradcheck", str(tmp_path / "missing.xml"), "--device", "cpu"]) == 2
