"""The comparison that decides `correct`: numbers computed from what the
timed path produced and what the reference computed, each held to its
limit from the cell's limits file (a number passes when it does not
exceed its limit)."""

from __future__ import annotations

import torch

# a channel is off when it differs from the reference by more than this,
# relative to max(1, |reference|)
PIXEL_TOL = 1e-4


def image_numbers(prog, ref, prog_rays, ref_rays) -> dict:
    """prog, ref: (F, P, 3) radiance of P sampled pixels in F checked frames
    (the program's image, the reference's mean over the same samples);
    prog_rays: (F,) rays a pixel of each whole frame traced on average (the
    frame's ray total over its pixels); ref_rays: (F,) the reference's
    average over the sampled pixels.

      pixels_off  share of sampled pixels with a channel off (PIXEL_TOL)
      mean_gap    |mean(prog) - mean(ref)| / mean(ref) over every channel
      rays_gap    the largest |prog_rays - ref_rays| / ref_rays of a frame
    """
    prog, ref = prog.double(), ref.double()
    tol = PIXEL_TOL * torch.clamp(ref.abs(), min=1.0)
    off = ((prog - ref).abs() > tol).any(-1) | ~torch.isfinite(prog).all(-1)
    prog_rays, ref_rays = torch.as_tensor(prog_rays).double(), torch.as_tensor(ref_rays).double()
    return dict(
        pixels_off=float(off.double().mean()),
        mean_gap=float((prog.mean() - ref.mean()).abs() / ref.mean().abs()),
        rays_gap=float(((prog_rays - ref_rays).abs() / ref_rays).max()),
    )


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number the limits name; a NaN
    fails."""
    out = []
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"the limits name {name!r}, which this comparison does not compute")
        v = float(numbers[name])
        out.append((name, v, float(limit), v <= float(limit)))
    return out
