"""The sphere field of gpuspectral_tpu_torch/scene/zoo.py, generated by a
frozen copy of its code: the reference's builder of the builtin scene
"sphere_field"."""

from __future__ import annotations

import numpy as np

from . import bsdf_table as bt
from .scenes import TEX_RES, Builder, rectangle


def build_builder(spec: dict) -> Builder:
    return sphere_field()


def _checkerboard(color0, color1, uscale, vscale):
    u = (np.arange(TEX_RES) + 0.5) / TEX_RES
    v = (np.arange(TEX_RES) + 0.5) / TEX_RES
    uu, vv = np.meshgrid(u, 1.0 - v)
    cell = (np.floor(uu * 2 * uscale) + np.floor(vv * 2 * vscale)) % 2
    return np.where(cell[..., None] > 0.5, np.asarray(color0, np.float32),
                    np.asarray(color1, np.float32)).astype(np.float32)


def _uv_sphere(segs: int, rings: int):
    th = np.pi * np.arange(rings + 1) / rings
    ph = 2.0 * np.pi * np.arange(segs + 1) / segs
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    grid = np.stack(np.broadcast_arrays(st * np.cos(ph), ct + 0.0 * ph, st * np.sin(ph)),
                    -1).astype(np.float32)
    uvg = np.stack(np.broadcast_arrays(ph[None, :] / (2 * np.pi), 1.0 - th[:, None] / np.pi),
                   -1).astype(np.float32)
    i, j = np.meshgrid(np.arange(rings), np.arange(segs), indexing="ij")
    i, j = i.ravel(), j.ravel()
    upper = [(i, j), (i, j + 1), (i + 1, j)]
    lower = [(i, j + 1), (i + 1, j + 1), (i + 1, j)]
    keep_u, keep_l = i > 0, i < rings - 1
    tris = [np.stack([grid[a, c] for a, c in upper], 1)[keep_u],
            np.stack([grid[a, c] for a, c in lower], 1)[keep_l]]
    uvs = [np.stack([uvg[a, c] for a, c in upper], 1)[keep_u],
           np.stack([uvg[a, c] for a, c in lower], 1)[keep_l]]
    pos = np.concatenate(tris)
    return pos, pos.copy(), np.concatenate(uvs)


def _floor_grid(n: int, half: float):
    x = np.linspace(-half, half, n + 1, dtype=np.float32)
    uv = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.ravel(), j.ravel()

    def corner(a, c):
        return (np.stack([x[a], np.zeros_like(x[a]), x[c]], -1),
                np.stack([uv[a], 1.0 - uv[c]], -1))

    quads = [corner(i, j), corner(i, j + 1), corner(i + 1, j + 1), corner(i + 1, j)]
    tri = [(0, 1, 2), (0, 2, 3)]
    pos = np.concatenate([np.stack([quads[k][0] for k in t], 1) for t in tri])
    uvs = np.concatenate([np.stack([quads[k][1] for k in t], 1) for t in tri])
    nrm = np.broadcast_to(np.float32([0.0, 1.0, 0.0]), pos.shape).copy()
    return pos.astype(np.float32), nrm, uvs.astype(np.float32)


def _sky(h: int, w: int) -> np.ndarray:
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]
    zenith = np.array([0.25, 0.45, 0.9], np.float32)
    horizon = np.array([0.9, 0.9, 0.85], np.float32)
    ground = np.array([0.12, 0.1, 0.08], np.float32)
    col = np.where((v < 0.5)[:, None], up * zenith + (1.0 - up) * horizon, ground)
    sky = np.broadcast_to(col[:, None, :], (h, w, 3)).copy()
    sky[max(0, h // 5), (3 * w) // 8] = (60.0, 55.0, 45.0)
    return sky.astype(np.float32)


def sphere_field(n_side: int = 6, segs: int = 64, rings: int = 32, sky_hw=(32, 64)) -> Builder:
    """The sphere field: n_side x n_side UV spheres whose BSDFs cycle
    through all eight kinds, a checkerboard floor, a back wall, a quad light
    and a lat-long sky (none when sky_hw is None)."""
    b = Builder()
    rect_pos, rect_nrm, rect_uv = rectangle()
    half = n_side / 2.0
    s = half + 2.0
    floor = b.add_bsdf(bt.diffuse((0.8, 0.8, 0.8)),
                       texture=_checkerboard((0.9, 0.9, 0.9), (0.25, 0.25, 0.3), n_side, n_side))
    fpos, fnrm, fuv = _floor_grid(8 * n_side, s)
    b.add_object(fpos, fnrm, fuv, np.eye(4, dtype=np.float32), floor, twofaced=True)
    wall = b.add_bsdf(bt.diffuse((0.6, 0.55, 0.5)))
    back = np.array([[s, 0, 0, 0], [0, s, 0, s - 1.0], [0, 0, -1, -(half + 1.0)], [0, 0, 0, 1]],
                    np.float32)
    b.add_object(rect_pos, rect_nrm, rect_uv, back, wall, twofaced=True)
    kinds = [
        bt.diffuse((0.7, 0.3, 0.3)),
        bt.smooth_dielectric(1.5),
        bt.smooth_conductor(0.0),
        bt.smooth_plastic((0.2, 0.4, 0.7), 1.5),
        bt.rough_conductor((1.66, 0.88, 0.52), (9.2, 6.3, 4.8), (1, 1, 1), 0.2),
        bt.smooth_floor((0.3, 0.6, 0.3), 0.04),
        bt.rough_floor((0.7, 0.5, 0.3), 0.04, 0.3),
        bt.rough_plastic((0.6, 0.6, 0.2), 1.5, alpha=0.2),
    ]
    rows = [b.add_bsdf(k) for k in kinds]
    spos, snrm, suv = _uv_sphere(segs, rings)
    for k in range(n_side * n_side):
        x = (k % n_side) - (n_side - 1) / 2.0
        z = (k // n_side) - (n_side - 1) / 2.0
        xf = np.array([[0.4, 0, 0, x], [0, 0.4, 0, 0.4], [0, 0, 0.4, z], [0, 0, 0, 1]], np.float32)
        b.add_object(spos, snrm, suv, xf, rows[k % len(rows)])
    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    light_xf = np.array([[1.5, 0, 0, 0], [0, 0, -1, half + 2.0], [0, 1.5, 0, 0], [0, 0, 0, 1]],
                        np.float32)
    b.add_object(rect_pos, rect_nrm, rect_uv, light_xf, light, emission=(12.0, 12.0, 12.0))
    if sky_hw is not None:
        b.envmap_image = _sky(*sky_hw)
    eye = np.array([0.0, half + 1.0, 2.0 * half + 2.5], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    left = np.cross([0.0, 1.0, 0.0], fwd)
    left /= np.linalg.norm(left)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = left, np.cross(fwd, left), fwd, eye
    b.cam_to_world, b.cam_fov = cam, float(np.deg2rad(45))
    return b
