"""Gradient checking: path-replay autograd gradients vs finite differences
(port of gpuspectral_tpu/diff/gradcheck.py).

Every random draw is a pure function of (pixel, timestamp, bounce,
channel) (ops/rng.py), so the rendered image is a deterministic function
of the scene parameters: common-random-numbers central differences and the
autograd gradient through the replayed bounce loop
(path_tracer.trace_rays(differentiable=True)) differentiate the same
function and agree to O(h^2) plus float32 noise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..integrator.path_tracer import render_sample
from ..scene.data import SceneData
from ..utils.config import RenderConfig


def render_mean(scene: SceneData, cfg: RenderConfig, timestamp0: int = 0,
                differentiable: bool = False):
    """(n_pixels, 3) mean of cfg.spp samples, sample s at timestamp
    timestamp0 + s, summed in sample order.  The spp * n_pixels lanes, in
    sample-major order, are traced cfg.ray_batch at a time, so a batch holds
    part of one sample or several (path_tracer.render_sample with a
    timestamp per lane).  Differentiable with cfg.grad_remat "sample": each
    batch runs under torch.utils.checkpoint and is replayed in the backward
    pass; with "bounce" trace_rays checkpoints each bounce instead."""
    from torch.utils.checkpoint import checkpoint

    n_pixels = cfg.width * cfg.height
    n_lanes = cfg.spp * n_pixels
    dev = scene.device
    acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)

    def batch(sc, l0, l1):
        lane = torch.arange(l0, l1, dtype=torch.int64, device=dev)
        return render_sample(sc, cfg, lane % n_pixels, timestamp0 + lane // n_pixels,
                             differentiable=differentiable)[0]

    for l0 in range(0, n_lanes, cfg.ray_batch):
        l1 = min(l0 + cfg.ray_batch, n_lanes)
        if differentiable and cfg.grad_remat == "sample":
            rad = checkpoint(batch, scene, l0, l1, use_reentrant=False)
        else:
            rad = batch(scene, l0, l1)
        for s in range(l0 // n_pixels, (l1 - 1) // n_pixels + 1):  # each sample's lanes
            a, b = max(l0, s * n_pixels), min(l1, (s + 1) * n_pixels)
            acc[a - s * n_pixels:b - s * n_pixels] += rad[a - l0:b - l0]
    return acc / cfg.spp


def _loss(scene, cfg, target, differentiable):
    img = render_mean(scene, cfg, differentiable=differentiable)
    return torch.mean((img - target.reshape(img.shape)) ** 2)


def _loss_and_grad(scene: SceneData, cfg: RenderConfig, params, target):
    """L = mean((render(params) - target)^2) and dL/d bsdf_params."""
    p = torch.as_tensor(params, dtype=torch.float32, device=scene.device).detach().clone()
    p.requires_grad_(True)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device)
    loss = _loss(scene.replace(bsdf_params=p), cfg, target, True)
    (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def _loss_only(scene: SceneData, cfg: RenderConfig, params, target):
    p = torch.as_tensor(params, dtype=torch.float32, device=scene.device)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device)
    with torch.no_grad():
        return _loss(scene.replace(bsdf_params=p), cfg, target, False)


def finite_difference_grad(scene, cfg, params, target, entries, h=1e-3):
    """Central differences on selected (row, col) entries, common random
    numbers (the same seeds and timestamps as the autograd loss)."""
    grads = {}
    params = np.asarray(params, np.float64).astype(np.float32)
    for (r, c) in entries:
        p_plus = params.copy()
        p_plus[r, c] += h
        p_minus = params.copy()
        p_minus[r, c] -= h
        lp = float(_loss_only(scene, cfg, p_plus, target))
        lm = float(_loss_only(scene, cfg, p_minus, target))
        grads[(r, c)] = (lp - lm) / (2 * h)
    return grads


def _compare(ad_grad, fd, rtol, atol, ok):
    rows = []
    for (r, c), fd_val in fd.items():
        ad_val = float(ad_grad[r, c])
        denom = max(abs(fd_val), abs(ad_val), 1e-12)
        good = abs(ad_val - fd_val) <= atol + rtol * max(abs(fd_val), abs(ad_val))
        ok = ok and good
        rows.append(dict(row=int(r), col=int(c), ad=ad_val, fd=fd_val,
                         rel_err=abs(ad_val - fd_val) / denom, ok=bool(good)))
    return ok, rows


def check_gradients(scene: SceneData, cfg: RenderConfig, entries=None, h: float = 1e-3,
                    rtol: float = 0.05, atol: float = 1e-4, perturb: float = 0.05):
    """Returns (ok, report).  The target is rendered at the true parameters;
    the check point is the parameters perturbed by `perturb`, so that the
    gradients are not zero."""
    with torch.no_grad():
        target = render_mean(scene, cfg)
    params = scene.bsdf_params.cpu().numpy() * (1.0 + perturb) + 0.01
    loss, ad_grad = _loss_and_grad(scene, cfg, params, target)
    ad_grad = ad_grad.cpu().numpy()
    if entries is None:
        # every entry with a non-negligible gradient, capped for FD cost
        idx = np.argwhere(np.abs(ad_grad) > 1e-6)
        order = np.argsort(-np.abs(ad_grad[idx[:, 0], idx[:, 1]]), kind="stable")
        entries = [tuple(e) for e in idx[order][:16]]
    fd = finite_difference_grad(scene, cfg, params, target, entries, h=h)
    ok, rows = _compare(ad_grad, fd, rtol, atol, True)
    return ok, dict(loss=float(loss), checked=len(rows), entries=rows, allclose=bool(ok))


def _emission_loss(scene, cfg, lemit, target, differentiable):
    from .invert import scatter_light_emission

    return _loss(scatter_light_emission(scene, lemit), cfg, target, differentiable)


def check_emission_gradients(scene: SceneData, cfg: RenderConfig, entries=None,
                             h: float = 1e-2, rtol: float = 0.05, atol: float = 1e-5,
                             perturb: float = 0.2):
    """Autograd vs central-difference gradients w.r.t. light_emission
    entries, the emission applied to the light table and to the emitting
    triangles alike.  Target at the true radiances; checked at radiances
    scaled by (1 + perturb)."""
    with torch.no_grad():
        target = render_mean(scene, cfg)
    lemit_np = (scene.light_emission.cpu().numpy() * (1.0 + perturb)).astype(np.float32)
    lemit = torch.as_tensor(lemit_np, device=scene.device).requires_grad_(True)
    loss = _emission_loss(scene, cfg, lemit, target, True)
    (ad_grad,) = torch.autograd.grad(loss, lemit)
    loss, ad_grad = loss.detach(), ad_grad.cpu().numpy()
    if entries is None:
        idx = np.argwhere(np.abs(ad_grad) > 1e-7)
        order = np.argsort(-np.abs(ad_grad[idx[:, 0], idx[:, 1]]), kind="stable")
        entries = [tuple(e) for e in idx[order][:8]]
    fd = {}
    with torch.no_grad():
        for (r, c) in entries:
            e_plus, e_minus = lemit_np.copy(), lemit_np.copy()
            e_plus[r, c] += h
            e_minus[r, c] -= h
            lp = float(_emission_loss(scene, cfg, torch.as_tensor(e_plus, device=scene.device),
                                      target, False))
            lm = float(_emission_loss(scene, cfg, torch.as_tensor(e_minus, device=scene.device),
                                      target, False))
            fd[(r, c)] = (lp - lm) / (2 * h)
    ok, rows = _compare(ad_grad, fd, rtol, atol, len(entries) > 0)
    return ok, dict(loss=float(loss), checked=len(rows), entries=rows, allclose=bool(ok))


def run_gradcheck(scene_path: str, spp: int = 32, size: Optional[str] = None,
                  device="cuda"):
    """CLI entry: gradcheck on a scene at small resolution (24x24 unless
    `size`), depth 3; albedo and emission entries.  Every sample goes in one
    batch of lanes."""
    from ..scene import load_mitsuba_scene

    scene, _ = load_mitsuba_scene(scene_path, device=device)
    w = h = 24
    if size:
        w, h = (int(x) for x in size.lower().split("x"))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=3, ray_batch=w * h * spp)
    ok, report = check_gradients(scene, cfg)
    ok_e, report_e = check_emission_gradients(scene, cfg)
    report["emission"] = report_e
    return ok and ok_e, report
