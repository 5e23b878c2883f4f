"""Frozen copy of gpuspectral_tpu_torch/bsdf/dispatch.py for the benchmark's plain
reference (imports nothing of the port).  The original's docstring:

BSDF sample/eval with dispatch by kind (port of
gpuspectral_tpu/bsdf/dispatch.py; behavior spec rayhit.rchit:341-654).

Every kind present in the scene is evaluated for the whole batch and the
result selected by `kind`, as the reference's vectorized dispatch does.
Conventions: `wo`, `wi` in the local shading frame (+z = shading normal),
`params` rows per bsdf/table.py, explicit uniforms (u_sel, u1, u2).

Reference quirks kept: rough lobes sample a Beckmann half vector while
shading with GGX, and rough plastic's eval clamps its Beckmann pdf term to
>= 0.01 where its sampler does not.
"""

from __future__ import annotations

import math

import torch

from . import math3d as m3
from . import microfacet as mf
from . import sampling as smp
from .bsdf_table import (
    BSDF_DIFFUSE,
    BSDF_SMOOTH_DIELECTRIC,
    BSDF_SMOOTH_CONDUCTOR,
    BSDF_SMOOTH_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_SMOOTH_FLOOR,
    BSDF_ROUGH_FLOOR,
    BSDF_ROUGH_PLASTIC,
)

M_PI = math.pi


def is_transmission(kind):
    """Only the smooth dielectric transmits (rayhit.rchit:620-627)."""
    return kind == BSDF_SMOOTH_DIELECTRIC


def _abs_z(w):
    return torch.abs(w[..., 2])


def _safe_inv(x, eps=1e-12):
    return 1.0 / torch.clamp(x, min=eps)


def _false(x):
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


def _true(x):
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


# ---------------------------------------------------------------------------
# Per-kind samplers.  Each returns (wi, f_rgb, pdf, is_delta).
# ---------------------------------------------------------------------------


def _sample_diffuse(p, wo, u_sel, u1, u2):
    kd = p[..., 0:3]
    wi = smp.sample_cosine_hemisphere(u1, u2)
    f = kd / M_PI
    pdf = smp.cosine_hemisphere_pdf(wi)
    return wi, f, pdf, _false(pdf)


def _sample_smooth_dielectric(p, wo, u_sel, u1, u2):
    ior_in = torch.clamp(p[..., 0], min=1e-2)
    ior_out = torch.clamp(p[..., 1], min=1e-2)
    entering = wo[..., 2] > 0.0
    no = torch.where(entering, ior_out, ior_in)
    nt = torch.where(entering, ior_in, ior_out)
    cos_tho = wo[..., 2]
    nz = torch.where(entering, 1.0, -1.0)
    n = torch.stack([torch.zeros_like(nz), torch.zeros_like(nz), nz], dim=-1)
    wt, ok = mf.refract_local(wo, n, no, nt)
    mirror = m3.reflect_local(wo)

    fr = mf.fresnel_dielectric_exact(no, torch.abs(cos_tho), nt, torch.abs(wt[..., 2]))
    fr = torch.where(ok, fr, 1.0)

    reflecting = (~ok) | (u_sel < fr)
    wi = torch.where(reflecting[..., None], mirror, wt)
    inv_cos = _safe_inv(torch.abs(cos_tho))
    f_reflect = torch.where(ok, fr, 1.0) * inv_cos
    eta2 = (no * no) * _safe_inv(nt * nt)
    f_refract = eta2 * (1.0 - fr) * _safe_inv(torch.abs(wt[..., 2]))
    f_scalar = torch.where(reflecting, f_reflect, f_refract)
    pdf = torch.where(reflecting, torch.where(ok, fr, 1.0), 1.0 - fr)
    f = f_scalar[..., None].expand(wi.shape)
    return wi, f, pdf, _true(pdf)


def _sample_smooth_conductor(p, wo, u_sel, u1, u2):
    ior_in, ior_out = p[..., 0], p[..., 1]
    fr = torch.where(
        ior_in == 0.0, 1.0,
        mf.fresnel_dielectric(_abs_z(wo), ior_out, torch.clamp(ior_in, min=1e-6)),
    )
    wi = m3.reflect_local(wo)
    f = (fr * _safe_inv(_abs_z(wo)))[..., None] * torch.ones_like(wi)
    pdf = torch.ones_like(fr)
    return wi, f, pdf, _true(pdf)


def _sample_smooth_floor(p, wo, u_sel, u1, u2):
    kd, r0 = p[..., 0:3], p[..., 3]
    fr = mf.schlick_fresnel(r0, _abs_z(wo))
    mirror = m3.reflect_local(wo)
    wi_d = smp.sample_cosine_hemisphere(u1, u2)
    spec = u_sel < fr
    wi = torch.where(spec[..., None], mirror, wi_d)
    coupled = mf.coupled_diffuse_term(r0, _abs_z(wo), _abs_z(wi))
    f_diff = kd * coupled[..., None]
    f = torch.where(spec[..., None], f_diff + (fr * _safe_inv(_abs_z(wo)))[..., None], f_diff)
    pdf = torch.where(spec, fr, (1.0 - fr) * smp.cosine_hemisphere_pdf(wi))
    return wi, f, pdf, spec


def _sample_smooth_plastic(p, wo, u_sel, u1, u2):
    kd = p[..., 0:3]
    ior_in, ior_out, r0 = p[..., 3], p[..., 4], p[..., 5]
    no, nt = ior_out, torch.clamp(ior_in, min=1e-6)
    fri = mf.fresnel_dielectric(_abs_z(wo), no, nt)
    spec = u_sel < fri
    mirror = m3.reflect_local(wo)
    wi_d = smp.sample_cosine_hemisphere(u1, u2)
    wi = torch.where(spec[..., None], mirror, wi_d)
    fro = mf.fresnel_dielectric(_abs_z(wi), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    eta = no / nt
    d = (
        kd
        * (eta * eta * (1.0 - fri) * (1.0 - fro))[..., None]
        * _safe_inv(M_PI * (1.0 - kd * ri[..., None]))
    )
    f = torch.where(spec[..., None], (fri * _safe_inv(_abs_z(wo)))[..., None] * torch.ones_like(d), d)
    pdf = torch.where(spec, fri, (1.0 - fri) * smp.cosine_hemisphere_pdf(wi))
    return wi, f, pdf, spec


def _rough_common_wi(wo, u_sel, u1, u2, alpha):
    """50/50 half-vector-reflect / cosine lobe selection shared by rough
    plastic and rough floor (rayhit.rchit:532-547,583-594)."""
    wh = smp.sample_half_beckmann(u1, u2, alpha)
    wh = torch.where(wh[..., 2:3] <= 0.0, -wh, wh)
    wi_spec = m3.normalize(-wo + 2.0 * m3.dot(wh, wo)[..., None] * wh)
    wi_d = smp.sample_cosine_hemisphere(u1, u2)
    use_spec = u_sel < 0.5
    return torch.where(use_spec[..., None], wi_spec, wi_d)


def _sample_rough_conductor(p, wo, u_sel, u1, u2):
    eta, k, refl, alpha = p[..., 0:3], p[..., 3:6], p[..., 6:9], p[..., 9]
    fr = mf.fresnel_conductor(_abs_z(wo), eta, k)
    wh = smp.sample_half_beckmann(u1, u2, alpha)
    wh = torch.where(wh[..., 2:3] <= 0.0, -wh, wh)
    wi = m3.normalize(-wo + 2.0 * m3.dot(wh, wo)[..., None] * wh)
    denom = 4.0 * _abs_z(wi) * _abs_z(wo)
    f = refl * fr * (mf.ggx_d(wh, alpha) * mf.ggx_masking(wo, wi, alpha) * _safe_inv(denom))[..., None]
    pdf = mf.beckmann_d(wh, alpha) * _abs_z(wh) * _safe_inv(4.0 * torch.abs(m3.dot(wo, wh)))
    return wi, f, pdf, _false(pdf)


def _rough_plastic_f_pdf(p, wo, wi, eval_clamp: bool):
    """Rough plastic shading shared by sample and eval
    (rayhit.rchit:548-582); `eval_clamp` is the eval-only pdf clamp
    (rayhit.rchit:577)."""
    kd = p[..., 0:3]
    ior_in, ior_out, r0, alpha = p[..., 3], p[..., 4], p[..., 5], p[..., 6]
    no, nt = ior_out, torch.clamp(ior_in, min=1e-6)
    eta = no / nt
    wh = m3.normalize(wi + wo)
    fri = mf.fresnel_dielectric(torch.abs(m3.dot(wh, wo)), no, nt)
    fro = mf.fresnel_dielectric(torch.abs(m3.dot(wh, wi)), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    spec = (fri * mf.ggx_d(wh, alpha) * mf.ggx_masking(wo, wi, alpha)) * _safe_inv(
        4.0 * _abs_z(wo) * _abs_z(wi)
    )
    d = kd * ((1.0 - fri) * (1.0 - fro) * eta * eta)[..., None] * _safe_inv(
        M_PI * (1.0 - kd * ri[..., None])
    )
    bd = mf.beckmann_d(wh, alpha) * _abs_z(wh)
    if eval_clamp:
        bd = torch.clamp(bd, min=0.01)
    pdf = 0.5 * bd * _safe_inv(4.0 * torch.abs(m3.dot(wo, wh))) + 0.5 * smp.cosine_hemisphere_pdf(wi)
    return d + spec[..., None], pdf


def _sample_rough_plastic(p, wo, u_sel, u1, u2):
    alpha = p[..., 6]
    wi = _rough_common_wi(wo, u_sel, u1, u2, alpha)
    f, pdf = _rough_plastic_f_pdf(p, wo, wi, eval_clamp=False)
    return wi, f, pdf, _false(pdf)


def _rough_floor_f_pdf(p, wo, wi):
    """Rough floor shading shared by sample and eval (rayhit.rchit:595-617)."""
    kd, r0, alpha = p[..., 0:3], p[..., 3], p[..., 4]
    wh = m3.normalize(wi + wo)
    fr = mf.schlick_fresnel(r0, torch.abs(m3.dot(wo, wh)))
    d = kd * mf.fresnel_blend_diffuse_term(r0, _abs_z(wo), _abs_z(wi))[..., None]
    spec = fr * mf.ggx_d(wh, alpha) * _safe_inv(
        4.0 * torch.abs(m3.dot(wo, wh)) * torch.maximum(_abs_z(wo), _abs_z(wi))
    )
    pdf = 0.5 * mf.beckmann_d(wh, alpha) * _abs_z(wh) * _safe_inv(
        4.0 * torch.abs(m3.dot(wo, wh))
    ) + 0.5 * smp.cosine_hemisphere_pdf(wi)
    return d + spec[..., None], pdf


def _sample_rough_floor(p, wo, u_sel, u1, u2):
    alpha = p[..., 4]
    wi = _rough_common_wi(wo, u_sel, u1, u2, alpha)
    f, pdf = _rough_floor_f_pdf(p, wo, wi)
    return wi, f, pdf, _false(pdf)


_SAMPLERS = {
    BSDF_DIFFUSE: _sample_diffuse,
    BSDF_SMOOTH_DIELECTRIC: _sample_smooth_dielectric,
    BSDF_SMOOTH_CONDUCTOR: _sample_smooth_conductor,
    BSDF_SMOOTH_PLASTIC: _sample_smooth_plastic,
    BSDF_ROUGH_CONDUCTOR: _sample_rough_conductor,
    BSDF_SMOOTH_FLOOR: _sample_smooth_floor,
    BSDF_ROUGH_FLOOR: _sample_rough_floor,
    BSDF_ROUGH_PLASTIC: _sample_rough_plastic,
}


# ---------------------------------------------------------------------------
# Per-kind eval (for NEE light directions).  Each returns (f, pdf, is_delta).
# ---------------------------------------------------------------------------


def _eval_diffuse(p, wo, wi):
    kd = p[..., 0:3]
    pdf = smp.cosine_hemisphere_pdf(wi)
    return kd / M_PI, pdf, _false(pdf)


def _eval_delta(p, wo, wi):
    # smooth dielectric/conductor evaluate to 0 (rayhit.rchit:400-404,420-426)
    z = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    return torch.zeros_like(wo), torch.ones_like(z), _true(z)


def _eval_smooth_floor(p, wo, wi):
    kd, r0 = p[..., 0:3], p[..., 3]
    fr = mf.schlick_fresnel(r0, _abs_z(wo))
    f = kd * mf.coupled_diffuse_term(r0, _abs_z(wo), _abs_z(wi))[..., None]
    pdf = (1.0 - fr) * smp.cosine_hemisphere_pdf(wi)
    return f, pdf, _false(pdf)


def _eval_smooth_plastic(p, wo, wi):
    kd = p[..., 0:3]
    ior_in, ior_out, r0 = p[..., 3], p[..., 4], p[..., 5]
    no, nt = ior_out, torch.clamp(ior_in, min=1e-6)
    fri = mf.fresnel_dielectric(_abs_z(wo), no, nt)
    fro = mf.fresnel_dielectric(_abs_z(wi), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    eta = no / nt
    f = kd * ((1.0 - fri) * (1.0 - fro) * eta * eta)[..., None] * _safe_inv(
        M_PI * (1.0 - kd * ri[..., None])
    )
    pdf = (1.0 - fri) * smp.cosine_hemisphere_pdf(wi)
    return f, pdf, _false(pdf)


def _eval_rough_conductor(p, wo, wi):
    eta, k, refl, alpha = p[..., 0:3], p[..., 3:6], p[..., 6:9], p[..., 9]
    fr = mf.fresnel_conductor(_abs_z(wo), eta, k)
    wh = m3.normalize(wo + wi)
    denom = 4.0 * _abs_z(wi) * _abs_z(wo)
    f = fr * refl * (mf.ggx_d(wh, alpha) * mf.ggx_masking(wo, wi, alpha) * _safe_inv(denom))[..., None]
    pdf = mf.beckmann_d(wh, alpha) * _abs_z(wh) * _safe_inv(4.0 * torch.abs(m3.dot(wo, wh)))
    return f, pdf, _false(pdf)


def _eval_rough_plastic(p, wo, wi):
    f, pdf = _rough_plastic_f_pdf(p, wo, wi, eval_clamp=True)
    return f, pdf, _false(pdf)


def _eval_rough_floor(p, wo, wi):
    f, pdf = _rough_floor_f_pdf(p, wo, wi)
    return f, pdf, _false(pdf)


_EVALS = {
    BSDF_DIFFUSE: _eval_diffuse,
    BSDF_SMOOTH_DIELECTRIC: _eval_delta,
    BSDF_SMOOTH_CONDUCTOR: _eval_delta,
    BSDF_SMOOTH_PLASTIC: _eval_smooth_plastic,
    BSDF_ROUGH_CONDUCTOR: _eval_rough_conductor,
    BSDF_SMOOTH_FLOOR: _eval_smooth_floor,
    BSDF_ROUGH_FLOOR: _eval_rough_floor,
    BSDF_ROUGH_PLASTIC: _eval_rough_plastic,
}


def sample_bsdf(params, kind, wo, u_sel, u1, u2, present=None):
    """Sample every kind in `present` (default: all 8) and select by `kind`.

    params: (..., NUM_PARAMS); kind: (...,) int; wo: (..., 3); u_*: (...,).
    Returns (wi, f, pdf, is_delta)."""
    kinds = tuple(_SAMPLERS) if present is None else tuple(present)
    if len(kinds) == 1:
        return _SAMPLERS[kinds[0]](params, wo, u_sel, u1, u2)
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(wo)
    pdf = torch.ones(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    delta = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    for t in kinds:
        wi_t, f_t, pdf_t, d_t = _SAMPLERS[t](params, wo, u_sel, u1, u2)
        sel = kind == t
        wi = torch.where(sel[..., None], wi_t, wi)
        f = torch.where(sel[..., None], f_t, f)
        pdf = torch.where(sel, pdf_t, pdf)
        delta = torch.where(sel, d_t, delta)
    return wi, f, pdf, delta


def eval_bsdf(params, kind, wo, wi, present=None):
    """Evaluate (f, pdf, is_delta) for a direction pair; select by `kind`."""
    kinds = tuple(_EVALS) if present is None else tuple(present)
    if len(kinds) == 1:
        return _EVALS[kinds[0]](params, wo, wi)
    f = torch.zeros_like(wo)
    pdf = torch.ones(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    delta = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    for t in kinds:
        f_t, pdf_t, d_t = _EVALS[t](params, wo, wi)
        sel = kind == t
        f = torch.where(sel[..., None], f_t, f)
        pdf = torch.where(sel, pdf_t, pdf)
        delta = torch.where(sel, d_t, delta)
    return f, pdf, delta
