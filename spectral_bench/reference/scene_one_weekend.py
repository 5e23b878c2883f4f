"""The final scene of "Ray Tracing in One Weekend" as
gpuspectral_tpu_torch/scene/zoo.py:populate_one_weekend builds it, generated
by a frozen copy of its code: the reference's builder of the builtin scene
"one_weekend".  Its departures from the book (UV spheres, the ground as a
square, the port's BSDFs, a pinhole, the sky as a map) are listed there and
in configs/oneweekend.json."""

from __future__ import annotations

import numpy as np

from . import bsdf_table as bt
from .scene_sphere_field import _uv_sphere
from .scenes import Builder, rectangle


def build_builder(spec: dict) -> Builder:
    return one_weekend()


def _sky(h: int = 32, w: int = 64) -> np.ndarray:
    t = 0.5 * (np.cos(np.pi * (np.arange(h) + 0.5) / h) + 1.0)[:, None]
    col = (1.0 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
    return np.broadcast_to(col[:, None, :], (h, w, 3)).astype(np.float32)


def one_weekend(grid: int = 11, segs: int = 32, rings: int = 16) -> Builder:
    """The book's random_scene(): the draws of np.random.default_rng(0) in
    its order, spheres as UV meshes, the ground sphere as its tangent
    square, the sky gradient as a 32 x 64 map."""
    b = Builder()
    g = np.random.default_rng(0)
    spos, snrm, suv = _uv_sphere(segs, rings)

    def sphere(centre, radius, row):
        xf = np.eye(4, dtype=np.float32)
        xf[:3, :3] *= np.float32(radius)
        xf[:3, 3] = centre
        b.add_object(spos, snrm, suv, xf, row)

    rect_pos, rect_nrm, rect_uv = rectangle()
    ground = b.add_bsdf(bt.diffuse((0.5, 0.5, 0.5)))
    ground_xf = np.array([[1000, 0, 0, 0], [0, 0, 1, 0], [0, -1000, 0, 0], [0, 0, 0, 1]],
                         np.float32)
    b.add_object(rect_pos, rect_nrm, rect_uv, ground_xf, ground, twofaced=True)

    for a in range(-grid, grid):
        for c in range(-grid, grid):
            choose_mat = g.random()
            centre = np.array([a + 0.9 * g.random(), 0.2, c + 0.9 * g.random()])
            if np.linalg.norm(centre - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                row = bt.diffuse(g.random(3) * g.random(3))
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * g.random(3)
                fuzz = 0.5 * g.random()
                row = bt.rough_conductor((1, 1, 1), (10, 10, 10), albedo, max(fuzz, 0.01))
            else:
                row = bt.smooth_dielectric(1.5)
            sphere(centre, 0.2, b.add_bsdf(row))

    sphere((0.0, 1.0, 0.0), 1.0, b.add_bsdf(bt.smooth_dielectric(1.5)))
    sphere((-4.0, 1.0, 0.0), 1.0, b.add_bsdf(bt.diffuse((0.4, 0.2, 0.1))))
    sphere((4.0, 1.0, 0.0), 1.0,
           b.add_bsdf(bt.rough_conductor((1, 1, 1), (10, 10, 10), (0.7, 0.6, 0.5), 0.01)))
    b.envmap_image = _sky()

    eye = np.array([13.0, 2.0, 3.0])
    fwd = -eye / np.linalg.norm(eye)
    left = np.cross([0.0, 1.0, 0.0], fwd)
    left /= np.linalg.norm(left)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = left, np.cross(fwd, left), fwd, eye
    b.cam_to_world = cam
    b.cam_fov = float(2.0 * np.arctan(1.5 * np.tan(np.deg2rad(10.0))))
    return b
