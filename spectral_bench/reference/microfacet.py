"""Frozen copy of gpuspectral_tpu_torch/ops/microfacet.py for the benchmark's plain
reference (imports nothing of the port).  The original's docstring:

Fresnel and microfacet (GGX/Beckmann) library (port of
gpuspectral_tpu/ops/microfacet.py; behavior specs cite rayhit.rchit).

Divisions and square roots carry the same guards as the reference so that
masked lanes never produce inf/nan.
"""

from __future__ import annotations

import math

import torch

from . import math3d as m3

M_PI = math.pi


def _safe_sqrt(x):
    return m3.sqrt(torch.clamp(x, min=1e-24))


def fresnel_dielectric_exact(no, cos_tho, nt, cos_tht):
    """Exact unpolarized dielectric Fresnel from both angles
    (rayhit.rchit:218-226)."""
    a = nt * cos_tho - no * cos_tht
    ad = nt * cos_tho + no * cos_tht
    b = no * cos_tho - nt * cos_tht
    bd = no * cos_tho + nt * cos_tht
    A = (a * a) / torch.clamp(ad * ad, min=1e-12)
    B = (b * b) / torch.clamp(bd * bd, min=1e-12)
    return 0.5 * (A + B)


def fresnel_dielectric(cos_tho, no, nt):
    """Dielectric Fresnel from |cos theta_o| with internal Snell solve;
    returns 1 on total internal reflection (rayhit.rchit:239-247)."""
    cos_tho = torch.abs(cos_tho)
    sin_tho = _safe_sqrt(1.0 - cos_tho * cos_tho)
    sqrt_term = 1.0 - ((no * no) / (nt * nt)) * (sin_tho * sin_tho)
    tir = sqrt_term <= 0.0
    cos_tht = _safe_sqrt(torch.where(tir, 1.0, sqrt_term))
    fr = fresnel_dielectric_exact(no, cos_tho, nt, cos_tht)
    return torch.where(tir, 1.0, fr)


def fresnel_conductor(cos_th, eta, k):
    """Unpolarized conductor Fresnel with complex IOR eta + i*k, vectorized
    over RGB (rayhit.rchit:269-288)."""
    cos_th = torch.abs(cos_th)[..., None]
    cos2 = cos_th * cos_th
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = _safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + cos2
    a = _safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_th
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


def refract_local(wo, n, no, nt):
    """Refract `wo` about normal `n` in the shading frame
    (rayhit.rchit:290-299).  Returns (wt, ok); ok=False flags total
    internal reflection."""
    sin_tho = _safe_sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2)
    sqrt_term = 1.0 - ((no * no) / (nt * nt)) * (sin_tho * sin_tho)
    ok = sqrt_term > 0.0
    cos_tht = _safe_sqrt(torch.where(ok, sqrt_term, 1.0))
    eta = no / nt
    wt = eta[..., None] * (-wo) + (eta * m3.dot(wo, n) - cos_tht)[..., None] * n
    return wt, ok


def beckmann_d(wh, alpha):
    """Beckmann NDF (rayhit.rchit:177-183)."""
    cos2 = torch.clamp(wh[..., 2] * wh[..., 2], min=1e-12)
    tan2 = (wh[..., 0] ** 2 + wh[..., 1] ** 2) / cos2
    a = torch.exp(-tan2 / torch.clamp(alpha * alpha, min=1e-12))
    b = M_PI * alpha * alpha * cos2 * cos2
    return a / torch.clamp(b, min=1e-12)


def ggx_d(wh, alpha):
    """GGX NDF (rayhit.rchit:185-192).  Returns 0 at grazing."""
    cos2 = wh[..., 2] * wh[..., 2]
    grazing = cos2 <= 1e-12
    cos2s = torch.clamp(cos2, min=1e-12)
    tan2 = (wh[..., 0] ** 2 + wh[..., 1] ** 2) / cos2s
    b = 1.0 + tan2 / torch.clamp(alpha * alpha, min=1e-12)
    a = M_PI * alpha * alpha * cos2s * cos2s * b * b
    return torch.where(grazing, 0.0, 1.0 / torch.clamp(a, min=1e-12))


def ggx_lambda(w, alpha):
    """Smith Lambda for GGX (rayhit.rchit:194-200)."""
    cos2 = w[..., 2] * w[..., 2]
    grazing = cos2 <= 1e-12
    cos2s = torch.clamp(cos2, min=1e-12)
    tan2 = (w[..., 0] ** 2 + w[..., 1] ** 2) / cos2s
    a = -1.0 + _safe_sqrt(1.0 + alpha * alpha * tan2)
    return torch.where(grazing, 0.0, 0.5 * a)


def ggx_masking(wo, wi, alpha):
    """Smith height-correlated masking-shadowing G (rayhit.rchit:202-204)."""
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def schlick_fresnel(r0, cos_tho):
    """Schlick approximation (rayhit.rchit:326-330)."""
    a = 1.0 - cos_tho
    a5 = a * a * a * a * a
    return r0 + a5 * (1.0 - r0)


def coupled_diffuse_term(r0, cos_tho, cos_thi):
    """Coupled matte-specular diffuse factor (rayhit.rchit:301-308)."""
    # tensor numerator: torch's `float / tensor` rounds twice
    k = torch.full_like(r0, 21.0) / (20.0 * M_PI * torch.clamp(1.0 - r0, min=1e-6))
    a = 1.0 - cos_tho
    b = 1.0 - cos_thi
    a5 = a * a * a * a * a
    b5 = b * b * b * b * b
    return k * (1.0 - a5) * (1.0 - b5)


def fresnel_blend_diffuse_term(r0, cos_tho, cos_thi):
    """Ashikhmin-Shirley Fresnel-blend diffuse factor (rayhit.rchit:310-317)."""
    k = 28.0 / (23.0 * M_PI)
    a = 1.0 - 0.5 * cos_tho
    b = 1.0 - 0.5 * cos_thi
    a5 = a * a * a * a * a
    b5 = b * b * b * b * b
    return k * (1.0 - r0) * (1.0 - a5) * (1.0 - b5)


def internal_scatter_escape_fraction(r0, no, nt):
    """Internal-scattering escape fraction R_i (rayhit.rchit:320-324)."""
    re = (M_PI * 20.0 * r0 + 1.0) / 21.0
    eta = no / nt
    return 1.0 - eta * eta * (1.0 - re)
