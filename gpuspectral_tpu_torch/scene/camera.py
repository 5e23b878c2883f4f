"""Pinhole camera ray generation (port of gpuspectral_tpu/scene/camera.py).

Mitsuba convention: d_c = normalize(-xy.x, -xy.y, z), d_w = to_world[:3,:3]
@ d_c, fragCoord (0,0) at the top-left pixel, samples at integer pixel
coordinates unless a jitter in [0,1)^2 is passed.  The rotation is applied
as explicit component products, never as a matmul.
"""

from __future__ import annotations

import torch

from ..ops import math3d as m3
from .data import CameraData


def generate_rays(cam: CameraData, width: int, height: int, pixel_index, jitter_u=None):
    """pixel_index: (...,) integer flat index (y*width + x).
    Returns (origin (...,3), direction (...,3))."""
    px = (pixel_index % width).to(torch.float32)
    py = torch.div(pixel_index, width, rounding_mode="floor").to(torch.float32)
    if jitter_u is not None:
        px = px + jitter_u[0]
        py = py + jitter_u[1]
    xy_x = px - width / 2.0
    xy_y = py - height / 2.0
    # a tensor numerator: `float / tensor` in torch is reciprocal-then-
    # multiply, two roundings where the reference divides once
    half = torch.tensor(max(width, height) / 2.0, dtype=torch.float32,
                        device=cam.fov.device)
    z = half / torch.tan(cam.fov / 2.0)
    d_cam = m3.normalize(
        torch.stack([-xy_x, -xy_y, z.expand(xy_x.shape)], dim=-1)
    )
    r = cam.to_world[:3, :3]
    dx, dy, dz = d_cam[..., 0], d_cam[..., 1], d_cam[..., 2]
    d_world = torch.stack(
        [
            r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz,
            r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz,
            r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz,
        ],
        dim=-1,
    )
    origin = cam.to_world[:3, 3].expand(d_world.shape)
    return origin, d_world
