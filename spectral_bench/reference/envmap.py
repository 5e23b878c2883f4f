"""Frozen copy of gpuspectral_tpu_torch/integrator/envmap.py for the benchmark's plain
reference (imports nothing of the port).  The original's docstring:

Environment emitter: evaluation, importance sampling and pdf (port of
gpuspectral_tpu/integrator/envmap.py).

Lat-long radiance maps (Mitsuba `envmap`) and `constant` emitters (a 1x1
map) shade on ray miss.  Mitsuba's equirectangular convention (Y-up):

    d' = R_world_to_env @ d
    u  = (1 + sign(d'.x) * acos(-d'.z / |d'.xz|) / pi) / 2
    v  = acos(clamp(d'.y)) / pi

with the polynomial `acos_fast` on every path (never acosf or torch.acos:
the JAX package and both megakernels use the same polynomial, so texel
decisions agree across them).  Bilinear filtering, wrap in u, clamp in v.
Every operation is separately rounded and in the JAX package's order; the
megakernels (csrc/bounce.cuh) repeat the same sequence.
"""

from __future__ import annotations

import math

import torch

from . import math3d as m3

_F32 = torch.float32


def _c(x, like):
    """A float32 constant on `like`'s device (a tensor operand, so torch
    neither turns a division into a reciprocal multiply nor widens it)."""
    return torch.tensor(x, dtype=_F32, device=like.device)


def acos_fast(x):
    """Abramowitz & Stegun 4.4.45 arccos, |err| <= 6.8e-5 rad (envmap.py:28)."""
    ax = torch.abs(x)
    p = torch.full_like(ax, -0.0187293)
    p = p * ax + _c(0.0742610, x)
    p = p * ax - _c(0.2121144, x)
    p = p * ax + _c(1.5707288, x)
    r = m3.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x < 0.0, _c(math.pi, x) - r, r)


def _to_env(rot, direction):
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    ex = rot[0, 0] * dx + rot[0, 1] * dy + rot[0, 2] * dz
    ey = rot[1, 0] * dx + rot[1, 1] * dy + rot[1, 2] * dz
    ez = rot[2, 0] * dx + rot[2, 1] * dy + rot[2, 2] * dz
    return ex, ey, ez


def _dir_uv(ex, ey, ez):
    """(u, v) lat-long coordinates of an env-space direction (envmap.py:45)."""
    pi = _c(math.pi, ex)
    r = m3.sqrt(ex * ex + ez * ez)
    c = torch.clamp(-ez / torch.clamp(r, min=1e-20), -1.0, 1.0)
    phi = torch.where(ex < 0.0, -1.0, 1.0) * acos_fast(c)
    u = (1.0 + phi / pi) * 0.5
    v = acos_fast(torch.clamp(ey, -1.0, 1.0)) / pi
    return u, v


def eval_envmap(envmap, rot, direction):
    """Radiance (R,3) of the (H,W,3) map along world-space unit directions
    (R,3); rot is the (3,3) world->env rotation."""
    h, w = envmap.shape[0], envmap.shape[1]
    u, v = _dir_uv(*_to_env(rot, direction))
    fx = u * _c(w, u) - 0.5
    fy = v * _c(h, v) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    # clamp the unclamped row pair so both rows collapse to the edge texel
    y0u = y0.to(torch.int64)
    y0i = torch.clamp(y0u, 0, h - 1)
    y1i = torch.clamp(y0u + 1, 0, h - 1)
    flat = envmap.reshape(-1, 3)
    c00 = flat[y0i * w + x0i]
    c01 = flat[y0i * w + x1i]
    c10 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample_envmap(envmap, rot, cdf, pdf_map, u1, u2):
    """Importance-sample a direction from the texel distribution: u1 picks
    the texel by inverting the CDF (searchsorted side="left"), the CDF
    residual and u2 place the direction uniformly in solid angle inside it.
    Returns (direction (R,3) world-space, pdf (R,) per steradian)."""
    h, w = pdf_map.shape[0], pdf_map.shape[1]
    n = h * w
    pi = _c(math.pi, u1)
    idx = torch.clamp(torch.searchsorted(cdf, u1, side="left"), 0, n - 1)
    hi = cdf[idx]
    lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
    jv = torch.clamp((u1 - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    y = torch.div(idx, w, rounding_mode="floor")
    x = idx - y * w
    yf = y.to(_F32)
    u = (x.to(_F32) + u2) / _c(w, u1)
    phi = (2.0 * u - 1.0) * pi
    c0 = torch.cos(pi * yf / _c(h, u1))
    c1 = torch.cos(pi * (yf + 1.0) / _c(h, u1))
    cos_t = c0 + jv * (c1 - c0)
    ct = torch.clamp(cos_t, -1.0, 1.0)
    st = m3.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    e0, e1, e2 = st * torch.sin(phi), ct, -st * torch.cos(phi)
    # env->world: rot is orthonormal world->env, so its transpose
    d = torch.stack([
        e0 * rot[0, 0] + e1 * rot[1, 0] + e2 * rot[2, 0],
        e0 * rot[0, 1] + e1 * rot[1, 1] + e2 * rot[2, 1],
        e0 * rot[0, 2] + e1 * rot[1, 2] + e2 * rot[2, 2],
    ], dim=-1)
    pdf = pdf_map.reshape(-1)[idx]
    return d, pdf


def envmap_pdf(pdf_map, rot, direction):
    """Solid-angle pdf that sample_envmap assigns to `direction` (nearest
    texel: the distribution is piecewise constant)."""
    h, w = pdf_map.shape[0], pdf_map.shape[1]
    u, v = _dir_uv(*_to_env(rot, direction))
    x = torch.clamp((u * _c(w, u)).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * _c(h, v)).to(torch.int64), 0, h - 1)
    return pdf_map.reshape(-1)[y * w + x]
