"""Inverse rendering: recover BSDF and emitter parameters from a target image
(port of gpuspectral_tpu/diff/invert.py).

Adam (torch.optim.Adam: the defaults of optax.adam, eps 1e-8 and bias
correction, so the same gradients give the same steps) in an unconstrained
space: params = lo + (hi - lo) * sigmoid(u) per entry (colours in [0, 1],
roughness alphas in [1e-3, 1.5]; `param_bounds`), so no step leaves the
physical domain; emitter radiance as softplus(v) per light, scattered onto
the emitting triangles so that NEE and emitter hits stay consistent.

Gradient path of a step: on a CUDA scene, K5 (`render_mega_diff`) when
mega_grad_eligible holds; else K6 (`render_mega_bvh_diff`) when
mega_bvh_grad_eligible holds and its gradients cover every optimizable
entry (the coverage gate, invert.py:163-186); else the differentiable
wavefront on the intersection kernels.  On a CPU scene the differentiable
wavefront on the plain scans.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..bsdf.table import (
    BSDF_DIFFUSE,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_FLOOR,
    BSDF_ROUGH_PLASTIC,
    BSDF_SMOOTH_FLOOR,
    BSDF_SMOOTH_PLASTIC,
)
from ..scene.data import SceneData
from ..utils.config import RenderConfig
from ..utils.metrics import MetricsLogger
from ..utils.profiling import stage
from .gradcheck import render_mean


def optimizable_mask(kinds: np.ndarray) -> np.ndarray:
    """(B, 12) bool: the continuously optimizable entries (albedo and
    reflectance colours, roughness alphas)."""
    b = kinds.shape[0]
    mask = np.zeros((b, 12), bool)
    for i, k in enumerate(kinds):
        if k in (BSDF_DIFFUSE, BSDF_SMOOTH_PLASTIC, BSDF_SMOOTH_FLOOR,
                 BSDF_ROUGH_FLOOR, BSDF_ROUGH_PLASTIC):
            mask[i, 0:3] = True  # diffuse colour
        if k == BSDF_ROUGH_CONDUCTOR:
            mask[i, 6:9] = True  # reflectance
            mask[i, 9] = True  # alpha
        if k == BSDF_ROUGH_PLASTIC:
            mask[i, 6] = True  # alpha
        if k == BSDF_ROUGH_FLOOR:
            mask[i, 4] = True  # alpha
    return mask


_ALPHA_LO, _ALPHA_HI = 1e-3, 1.5


def param_bounds(kinds: np.ndarray):
    """(lo, hi) arrays (B, 12): colours in [0, 1], roughness alphas in
    [1e-3, 1.5]; [0, 1] placeholders elsewhere (those entries never move)."""
    b = kinds.shape[0]
    lo = np.zeros((b, 12), np.float32)
    hi = np.ones((b, 12), np.float32)
    for i, k in enumerate(kinds):
        if k == BSDF_ROUGH_CONDUCTOR:
            lo[i, 9], hi[i, 9] = _ALPHA_LO, _ALPHA_HI
        if k == BSDF_ROUGH_PLASTIC:
            lo[i, 6], hi[i, 6] = _ALPHA_LO, _ALPHA_HI
        if k == BSDF_ROUGH_FLOOR:
            lo[i, 4], hi[i, 4] = _ALPHA_LO, _ALPHA_HI
    return lo, hi


def params_to_unconstrained(params, lo, hi):
    """u = logit((p - lo) / (hi - lo)), clipped into the open interval."""
    t = torch.clamp((params - lo) / (hi - lo), 1e-4, 1.0 - 1e-4)
    return torch.log(t) - torch.log1p(-t)


def unconstrained_to_params(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def emission_to_unconstrained(e):
    """Inverse softplus (stable): v = e + log(-expm1(-e)) for e > 0."""
    e = torch.clamp(e.to(torch.float32), min=1e-6)
    return e + torch.log(-torch.expm1(-e))


def unconstrained_to_emission(v):
    return torch.logaddexp(v, torch.zeros_like(v))  # jax.nn.softplus


def scatter_light_emission(scene: SceneData, light_emission):
    """The scene with `light_emission` applied to the light table (NEE) and
    to the emitting triangles (emitter hits) alike."""
    lidx = scene.tri_light_idx.long()
    tri_emission = torch.where((lidx >= 0)[:, None],
                               light_emission[torch.clamp(lidx, min=0)], scene.tri_emission)
    return scene.replace(light_emission=light_emission, tri_emission=tri_emission)


def _render(scene: SceneData, cfg: RenderConfig, spp: int, timestamp0: int):
    """(H, W, 3) mean of `spp` samples from timestamp0 (no gradient)."""
    with torch.no_grad():
        return render_mean(scene, cfg.replace(spp=spp), timestamp0).reshape(
            cfg.height, cfg.width, 3)


def gradient_path(scene: SceneData, cfg: RenderConfig, mask, optimize_emission: bool):
    """"mega" (K5), "mega_bvh" (K6) or "wavefront" for a step of invert on
    this scene (invert.py:157-186)."""
    from ..integrator.mega_grad import (MAX_GRAD_LIGHTS, mega_bvh_grad_eligible,
                                        mega_bvh_grad_rows, mega_grad_eligible)

    if scene.device.type != "cuda":
        return "wavefront"
    if mega_grad_eligible(scene, cfg):
        return "mega"
    if not mega_bvh_grad_eligible(scene, cfg):
        return "wavefront"
    # coverage gate: K6 gives gradients only for its rows' kd columns and,
    # with at most MAX_GRAD_LIGHTS lights, emitter radiance; any wider set
    # of optimizable entries would get exact zeros and never train
    m = np.asarray(mask) > 0
    covered = np.zeros(m.shape[0], bool)
    covered[list(mega_bvh_grad_rows(scene))] = True
    rows_ok = not m[~covered].any()
    kd_cols_only = not m[:, 3:].any()
    em_ok = (not optimize_emission) or scene.num_lights <= MAX_GRAD_LIGHTS
    return "mega_bvh" if (rows_ok and kd_cols_only and em_ok) else "wavefront"


def _make_step(scene, cfg, mask, lo, hi, target, optimize_emission):
    """(loss_fn, to_physical, path): the loss of the unconstrained
    variables {"u": (B, 12)} (+ {"v": (L, 3)}) at a timestamp, through the
    gradient path of `gradient_path`."""
    from ..integrator.mega_grad import render_mega_bvh_diff, render_mega_diff

    target_flat = target.reshape(-1, 3)
    n_pixels = cfg.width * cfg.height
    with stage("gst.sync.mask"):
        mask_host = mask.cpu().numpy()
    path = gradient_path(scene, cfg, mask_host, optimize_emission)

    def to_physical(ov):
        sc = scene
        if "u" in ov:
            params = torch.where(mask > 0, unconstrained_to_params(ov["u"], lo, hi),
                                 scene.bsdf_params)
            sc = sc.replace(bsdf_params=params)
        if optimize_emission:
            sc = scatter_light_emission(sc, unconstrained_to_emission(ov["v"]))
        return sc

    def loss_fn(ov, timestamp0):
        sc = to_physical(ov)
        if path == "mega":
            img = render_mega_diff(sc, cfg, timestamp0).reshape(n_pixels, 3)
        elif path == "mega_bvh":
            img = render_mega_bvh_diff(sc, cfg, timestamp0).reshape(n_pixels, 3)
        else:
            img = render_mean(sc, cfg, timestamp0, differentiable=True)
        return torch.mean((img - target_flat) ** 2)

    return loss_fn, to_physical, path


def _upload(x, dev):
    """A host array as float32 on dev, one "gst.sync.upload" span: the copy
    of a pageable array waits for the stream."""
    with stage("gst.sync.upload"):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


def invert(scene: SceneData, target, cfg: RenderConfig, steps: int = 100, lr: float = 0.02,
           init_params=None, metrics: Optional[MetricsLogger] = None,
           checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
           optimize_emission: bool = False, init_emission=None, optimize_bsdf: bool = True,
           timestamp0: int = 1000, resample: bool = True):
    """Optimize scene.bsdf_params (and, with optimize_emission, the emitter
    radiances) toward `target` (H, W, 3), stepping in the unconstrained
    (sigmoid / softplus) space.  resample=True draws fresh paths every step
    (timestamp0 + i * spp); False keeps one sample set, so that with the
    target's timestamp the loss has an exact zero at the truth.

    The call is the span "gst.invert" (utils/profiling), its set-up and
    each step (loss, backward pass, Adam, the loss read back) spans of
    their own, and each read-back or upload a "gst.sync.*" span.

    Returns (params, history), or ((params, light_emission), history) when
    optimize_emission is set."""
    with stage("gst.invert"):
        with stage("gst.invert.setup"):
            dev = scene.device
            with stage("gst.sync.kinds"):
                kinds = scene.bsdf_kind.cpu().numpy()
            mask = _upload(optimizable_mask(kinds), dev)
            lo, hi = (_upload(x, dev) for x in param_bounds(kinds))
            params = scene.bsdf_params if init_params is None else _upload(init_params, dev)
            if optimize_emission and init_emission is not None:
                emission = _upload(init_emission, dev)
            else:
                emission = scene.light_emission
            target = _upload(target, dev)
            opt_vars = {}
            if optimize_bsdf:
                u = params_to_unconstrained(params, lo, hi)
                opt_vars["u"] = u.detach().requires_grad_(True)
            if optimize_emission:
                v = emission_to_unconstrained(emission)
                opt_vars["v"] = v.detach().requires_grad_(True)
            opt = torch.optim.Adam(list(opt_vars.values()), lr=lr)
            loss_fn, to_physical, path = _make_step(scene, cfg, mask, lo, hi, target,
                                                    optimize_emission)

        history = []
        for i in range(steps):
            with stage("gst.invert.step"):
                t0 = time.time()
                opt.zero_grad()
                with stage("gst.invert.loss"):
                    loss = loss_fn(opt_vars, timestamp0 + (i * cfg.spp if resample else 0))
                with stage("gst.invert.backward"):
                    loss.backward()
                with stage("gst.invert.adam"):
                    if "u" in opt_vars:
                        opt_vars["u"].grad.mul_(mask)  # only optimizable entries move
                    opt.step()
                with stage("gst.sync.loss"):
                    loss = float(loss.detach())
                dt = time.time() - t0
                history.append(loss)
                if metrics:
                    metrics.log(event="invert_step", step=i, loss=loss, seconds=dt,
                                grad_steps_per_s=1.0 / max(dt, 1e-9), path=path)
                if checkpoint_dir and (i + 1) % checkpoint_every == 0:
                    from ..io.checkpoint import save_checkpoint

                    with torch.no_grad(), stage("gst.sync.checkpoint"):
                        sc = to_physical(opt_vars)
                        save_checkpoint(f"{checkpoint_dir}/ckpt_{i + 1:06d}.npz",
                                        dict(params=sc.bsdf_params.cpu().numpy(),
                                             light_emission=sc.light_emission.cpu().numpy(),
                                             step=np.int64(i + 1), loss=np.float64(loss)))
        with torch.no_grad():
            final = to_physical(opt_vars)
    if optimize_emission:
        return (final.bsdf_params, final.light_emission), history
    return final.bsdf_params, history
