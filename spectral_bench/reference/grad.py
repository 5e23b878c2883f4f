"""The reference of an inverse-rendering step: the loss and the gradient
that diff/invert.py's Adam gets, for a scene of diffuse BSDFs at a depth
no deeper than Russian roulette's start (what the fused-gradient kernel K5
covers).

The image's derivative with respect to each diffuse albedo comes from the
counting identity (a frozen copy of the port's plain version of K5's hook,
integrator/mega_grad.py:make_diffuse_grad_hook): on a path with n_b
bounces on row b, d contribution / d kd_b = n_b * contribution / kd_b,
plus the NEE term of the vertex's own BSDF.  Every pixel's partials are
summed over its samples in one pass, then contracted with the loss's
cotangent.  The parameterization (a sigmoid per entry between the bounds,
only the optimizable entries moving) is a frozen copy of diff/invert.py's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bsdf_table as bt
from . import tracer

KD_EPS = 1e-4
ALPHA_LO, ALPHA_HI = 1e-3, 1.5
LANE_CHUNK = 1 << 21


def optimizable_mask(kinds: np.ndarray) -> np.ndarray:
    mask = np.zeros((kinds.shape[0], 12), bool)
    for i, k in enumerate(kinds):
        if k in (bt.BSDF_DIFFUSE, bt.BSDF_SMOOTH_PLASTIC, bt.BSDF_SMOOTH_FLOOR,
                 bt.BSDF_ROUGH_FLOOR, bt.BSDF_ROUGH_PLASTIC):
            mask[i, 0:3] = True
        if k == bt.BSDF_ROUGH_CONDUCTOR:
            mask[i, 6:10] = True
        if k == bt.BSDF_ROUGH_PLASTIC:
            mask[i, 6] = True
        if k == bt.BSDF_ROUGH_FLOOR:
            mask[i, 4] = True
    return mask


def param_bounds(kinds: np.ndarray):
    lo = np.zeros((kinds.shape[0], 12), np.float32)
    hi = np.ones((kinds.shape[0], 12), np.float32)
    for i, k in enumerate(kinds):
        col = {bt.BSDF_ROUGH_CONDUCTOR: 9, bt.BSDF_ROUGH_PLASTIC: 6,
               bt.BSDF_ROUGH_FLOOR: 4}.get(int(k))
        if col is not None:
            lo[i, col], hi[i, col] = ALPHA_LO, ALPHA_HI
    return lo, hi


def to_unconstrained(params, lo, hi):
    t = torch.clamp((params - lo) / (hi - lo), 1e-4, 1.0 - 1e-4)
    return torch.log(t) - torch.log1p(-t)


def to_params(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def _hook(n_rows: int, n_lights: int, kd):
    """The per-lane partials of the radiance sums: a frozen copy of
    make_diffuse_grad_hook with grad_rows = every row."""
    kd_c = torch.clamp(kd, min=KD_EPS)

    def hook(st, ctx):
        f32 = torch.float32
        W, e, fl, lemit = ctx["weight"], ctx["e"], ctx["f_light"], ctx["lemit"]
        accf = ctx["acc"].to(f32)
        hitm = accf * ctx["hit"].to(f32)
        neem = accf * ctx["nee_done"].to(f32) * ctx["lfront"]
        bidx, lhit, nee_s = ctx["bidx"], ctx["lhit"], ctx["nee_s"]
        emit_coeff = ctx["emit_w"] * ctx["light_flag"]
        fresh = ctx["depth"] == 0
        parts = st["g_parts"].clone()
        n = st["g_n"].clone()
        for b in range(n_rows):
            selb = (bidx == b).to(f32)
            nbi = torch.where(torch.as_tensor(fresh), 0, n[:, b])
            nb = nbi.to(f32)
            for c in range(3):
                dfl = fl[:, c] / kd_c[b, c]
                direct = neem * selb * nee_s * W[:, c] * lemit[:, c] * dfl
                suffix = accf * e[:, c] * nb / kd_c[b, c]
                parts[:, 3 * b + c] = parts[:, 3 * b + c] + (direct + suffix)
            n[:, b] = nbi + (ctx["cont"] & (bidx == b)).to(torch.int64)
        for li in range(n_lights):
            sel_hit = hitm * (lhit == li).to(f32)
            sel_nee = neem * (ctx["lidx"] == li).to(f32)
            for c in range(3):
                te, le = 3 * n_rows + 3 * li + c, 3 * n_rows + 3 * n_lights + 3 * li + c
                parts[:, te] = parts[:, te] + sel_hit * emit_coeff * W[:, c]
                parts[:, le] = parts[:, le] + sel_nee * nee_s * fl[:, c] * W[:, c]
        st["g_parts"], st["g_n"] = parts, n
        return st

    return hook


def image_and_partials(rs, rc: tracer.RefConfig, timestamp0: int, tally=None, state_dtype=None):
    """Every pixel's mean radiance (N, 3) over its samples and the mean's
    partials with respect to each row's diffuse albedo (N, B, 3)."""
    n_rows, n_lights = rs.bsdf_kind.shape[0], rs.num_lights
    tabs = tracer.tables(rs, rc)
    hook = _hook(n_rows, n_lights, rs.bsdf_params[:, 0:3])
    n_pix = rc.width * rc.height
    dev = rs.device
    rad = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_pix, 3 * n_rows), dtype=torch.float32, device=dev)
    lanes = n_pix * rc.spp
    for b in range(0, lanes, LANE_CHUNK):
        lane = torch.arange(b, min(lanes, b + LANE_CHUNK), device=dev)
        pix, sample = lane % n_pix, lane // n_pix
        r = lane.shape[0]
        state0 = dict(g_parts=torch.zeros((r, 3 * n_rows + 6 * n_lights), dtype=torch.float32,
                                          device=dev),
                      g_n=torch.zeros((r, n_rows), dtype=torch.int64, device=dev))
        st = tracer.trace(rs, rc, pix, sample, timestamp0, tabs, tally, state_dtype,
                          grad_hook=hook, hook_state=state0, lane0=b)
        rad.index_add_(0, pix, st["radiance"])
        parts.index_add_(0, pix, st["g_parts"][:, :3 * n_rows])
    return rad / rc.spp, parts.reshape(n_pix, n_rows, 3) / rc.spp


def loss_and_grad(rs, rc: tracer.RefConfig, u, lo, hi, mask, target, timestamp0: int,
                  tally=None, state_dtype=None):
    """(loss, dL/du masked) of one step of invert: the scene's BSDF table
    at lo + (hi - lo) * sigmoid(u) on the masked entries, the MSE of its
    image against target (H, W, 3)."""
    params = torch.where(mask > 0, to_params(u, lo, hi), rs.bsdf_params)
    img, parts = image_and_partials(rs.replace(bsdf_params=params), rc, timestamp0, tally,
                                    state_dtype)
    diff = (img - target.reshape(-1, 3)).double()
    loss = float((diff * diff).mean())
    cot = 2.0 * diff / diff.numel()  # dL / d image
    d_kd = (cot[:, None, :] * parts.double()).sum(0)  # (B, 3)
    d_params = torch.zeros_like(params, dtype=torch.float64)
    d_params[:, 0:3] = d_kd
    s = torch.sigmoid(u.double())
    d_u = d_params * (hi - lo).double() * s * (1.0 - s)
    return loss, (d_u * mask.double()).float()
