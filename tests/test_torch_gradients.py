"""PyTorch port: autograd through the differentiable wavefront
(path_tracer.render_sample(differentiable=True)) against jax.grad through
the JAX package's, at the shapes of tests/test_gradients.py: albedo,
emission and GGX alpha gradients, finiteness at every depth, and the
autograd-vs-finite-difference gate.  The same numpy-made targets go to
both; each JAX reference is computed once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.diff import gradcheck as jgc
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.diff import gradcheck as tgc
from gpuspectral_tpu_torch.diff.invert import scatter_light_emission
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.utils import RenderConfig

from test_gradients import _glossy_box_scene
from torch_common import jax_scene_arrays

# Same estimator, same draws, autograd on both sides: what differs is float
# rounding (XLA fuses multiply-adds, torch does not), measured at ~1e-7 of
# the gradient's scale on these shapes; 1e-4 leaves room for a path that
# flips across a seam on a rounding difference.
GRAD_RTOL = 1e-4

BASE = dict(width=16, height=16, spp=8, max_depth=2, ray_batch=256)
GLOSSY = dict(width=24, height=24, spp=8, max_depth=3, ray_batch=576, use_bvh=False,
              jitter=False)


def _target(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)


def _assert_close(got, ref, rtol=GRAD_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    return cornell_scene, scene_from_arrays(*jax_scene_arrays(cornell_scene), "cpu")


@pytest.fixture(scope="module")
def glossy():
    js, row = _glossy_box_scene()
    return js, scene_from_arrays(*jax_scene_arrays(js), "cpu"), row


@pytest.fixture(scope="module")
def kd_ref(cornell):
    js, _ = cornell
    params = np.asarray(js.bsdf_params) * 1.05 + 0.01
    target = _target(256, 0)
    loss, g = jgc._loss_and_grad(js, JaxConfig(**BASE), jnp.asarray(params), jnp.asarray(target))
    return params, target, float(loss), np.asarray(g)


@pytest.mark.parametrize("remat", ["bounce", "sample"])
def test_albedo_grad_matches_jax(cornell, kd_ref, remat):
    params, target, loss_ref, g_ref = kd_ref
    loss, g = tgc._loss_and_grad(cornell[1], RenderConfig(grad_remat=remat, **BASE), params,
                                 target)
    assert abs(float(loss) - loss_ref) <= 1e-6 * loss_ref
    _assert_close(g.numpy(), g_ref)


def test_emission_grad_matches_jax(cornell):
    js, ts = cornell
    lemit = np.asarray(js.light_emission) * 1.2
    target = _target(256, 1)
    _, g_ref = jgc._emission_loss_and_grad(js, JaxConfig(**BASE), jnp.asarray(lemit),
                                           jnp.asarray(target))
    le = torch.as_tensor(lemit).requires_grad_(True)
    img = tgc.render_mean(scatter_light_emission(ts, le), RenderConfig(**BASE),
                          differentiable=True)
    loss = torch.mean((img - torch.as_tensor(target)) ** 2)
    (g,) = torch.autograd.grad(loss, le)
    _assert_close(g.numpy(), np.asarray(g_ref))


@pytest.mark.parametrize("intersector", ["woop", "pallas"])
def test_alpha_grad_matches_jax(glossy, intersector):
    """GGX alpha: the pathwise derivative runs through the sampled half
    vector into the next hit point, so it exercises the (t, u, v) backward
    of the closest hit: "woop" differentiates the plain scan by autograd,
    "pallas" goes through closest_diff (its plain forward on the CPU)."""
    js, ts, row = glossy
    target = _target(24 * 24, 3)
    _, g_ref = jgc._loss_and_grad(js, JaxConfig(**GLOSSY), js.bsdf_params, jnp.asarray(target))
    _, g = tgc._loss_and_grad(ts, RenderConfig(intersector=intersector, **GLOSSY),
                              ts.bsdf_params, target)
    g_ref = np.asarray(g_ref)
    assert abs(g_ref[row, 9]) > 0
    _assert_close(g.numpy(), g_ref)


def test_bvh_diff_path_matches_brute(glossy):
    """ftb_closest_diff (the BVH closest hit's backward) against the
    brute-force scan differentiated by autograd: the same estimator on the
    same scene, only the intersector differs."""
    _, ts, row = glossy
    target = _target(24 * 24, 4)
    cfg = RenderConfig(**{**GLOSSY, "width": 12, "height": 12, "spp": 4})
    _, g_ref = tgc._loss_and_grad(ts, cfg, ts.bsdf_params, target[:144])
    _, g = tgc._loss_and_grad(ts, cfg.replace(use_bvh=True, intersector="pallas"),
                              ts.bsdf_params, target[:144])
    assert abs(float(g_ref[row, 9])) > 0
    _assert_close(g.numpy(), g_ref.numpy(), rtol=1e-6)


def test_ray_batch_does_not_change_render_mean(cornell):
    """render_mean traces cfg.ray_batch lanes at a time: batches that split
    a sample (100 lanes of 64-pixel samples), hold one (64) or all three
    (192) give the same image bit for bit, and the same gradient up to the
    order in which its per-row sums add the batches' lanes (1e-6 of its
    scale)."""
    ts = cornell[1]
    target = torch.as_tensor(_target(64, 5))
    out = []
    for ray_batch in (100, 64, 192):
        cfg = RenderConfig(width=8, height=8, spp=3, max_depth=2, ray_batch=ray_batch,
                           grad_remat="sample")
        p = ts.bsdf_params.clone().requires_grad_(True)
        img = tgc.render_mean(ts.replace(bsdf_params=p), cfg, 7, differentiable=True)
        (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), p)
        out.append((img.detach(), g))
    for img, g in out[:2]:
        assert torch.equal(img, out[2][0])
        _assert_close(g.numpy(), out[2][1].numpy(), rtol=1e-6)


@pytest.mark.parametrize("depth", [0, 3])
def test_gradients_finite_all_depths(cornell, depth):
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=depth, ray_batch=64)
    loss, g = tgc._loss_and_grad(cornell[1], cfg, cornell[1].bsdf_params, np.zeros((64, 3),
                                                                                   np.float32))
    assert np.isfinite(float(loss)) and bool(torch.isfinite(g).all())


def test_ad_matches_finite_differences(cornell):
    # tests/test_gradients.py:13's gate, on the port alone
    ok, report = tgc.check_gradients(cornell[1], RenderConfig(**BASE), rtol=0.08, atol=1e-4)
    assert report["checked"] >= 4
    assert ok, [r for r in report["entries"] if not r["ok"]]


def test_emission_ad_matches_finite_differences(cornell):
    # tests/test_gradients.py:93's gate, on the port alone
    ok, report = tgc.check_emission_gradients(cornell[1], RenderConfig(**BASE), rtol=0.08)
    assert report["checked"] >= 3
    assert ok, [r for r in report["entries"] if not r["ok"]]
