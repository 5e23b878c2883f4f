"""Frozen copy of gpuspectral_tpu_torch/ops/sampling.py for the benchmark's plain
reference (imports nothing of the port).  The original's docstring:

Sampling routines for the path integrator (port of
gpuspectral_tpu/ops/sampling.py; behavior specs cite rayhit.rchit).

All functions take explicit uniforms (u1, u2 in [0,1)) and broadcast over
leading batch axes.
"""

from __future__ import annotations

import math

import torch

from . import math3d as m3

M_PI = math.pi


def sample_concentric_disk(u1, u2):
    """Concentric square->disk map (rayhit.rchit:89-105)."""
    ux = 2.0 * u1 - 1.0
    uy = 2.0 * u2 - 1.0
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    th = torch.where(
        use_x,
        (M_PI / 4.0) * m3.safe_div(uy, ux, 1e-12),
        M_PI / 2.0 - (M_PI / 4.0) * m3.safe_div(ux, uy, 1e-12),
    )
    at_origin = (ux == 0.0) & (uy == 0.0)
    x = torch.where(at_origin, 0.0, r * torch.cos(th))
    y = torch.where(at_origin, 0.0, r * torch.sin(th))
    return x, y


def sample_cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere direction in the shading frame
    (rayhit.rchit:107-111).  Returns (..., 3)."""
    x, y = sample_concentric_disk(u1, u2)
    z = m3.sqrt(torch.clamp(1.0 - x * x - y * y, min=1e-24))
    return torch.stack([x, y, z], dim=-1)


def cosine_hemisphere_pdf(w):
    """pdf of the cosine sampler (rayhit.rchit:113-115)."""
    return torch.clamp(torch.abs(w[..., 2]) / M_PI, min=1e-6)


def sample_half_beckmann(u1, u2, alpha):
    """Beckmann-distributed half vector (rayhit.rchit:155-166); the
    reference samples Beckmann while shading with GGX, reproduced here."""
    phi = 2.0 * M_PI * u1
    log_sample = torch.log(torch.clamp(1.0 - u2, min=1e-12))
    tan2 = -alpha * alpha * log_sample
    cost = 1.0 / m3.sqrt(1.0 + tan2)
    sint = m3.sqrt(torch.clamp(1.0 - cost * cost, min=1e-24))
    return torch.stack([torch.cos(phi) * sint, torch.sin(phi) * sint, cost], dim=-1)


def power_heuristic(f_pdf, g_pdf):
    """Power heuristic MIS weight (rayhit.rchit:206-210)."""
    f = f_pdf
    g = g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0, f * f / torch.clamp(denom, min=1e-12), 0.0)


def sample_triangle_light(v0, v1, v2, emission, shade_pos, u1, u2):
    """Area-sample one triangle light toward `shade_pos`
    (rayhit.rchit:123-145).  Returns (light_pos, emitted, pdf), pdf in
    solid angle, emitted zeroed on the back side."""
    su = m3.sqrt(torch.clamp(u1, min=0.0))
    bu = 1.0 - su
    bv = u2 * su
    bw = 1.0 - bu - bv
    area = 0.5 * torch.abs(m3.length(m3.cross(v2 - v0, v1 - v0)))
    normal = m3.normalize(m3.cross(v1 - v0, v2 - v0))
    light_pos = bu[..., None] * v0 + bv[..., None] * v1 + bw[..., None] * v2
    delta = light_pos - shade_pos
    dist = m3.length(delta)
    l_dir = delta / torch.clamp(dist, min=1e-12)[..., None]
    cos_light = m3.dot(-l_dir, normal)
    emitted = emission * (cos_light > 0.0)[..., None].to(emission.dtype)
    pdf = dist * dist / torch.clamp(torch.abs(cos_light) * area, min=1e-12)
    return light_pos, emitted, pdf
