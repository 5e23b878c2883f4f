"""The all-BSDF "zoo" scene: floor, back wall, one small cube of each of the
seven non-diffuse BSDF kinds, and a ceiling area light (the scene of
tests/test_all_bsdfs_scene.py, built in code).

`populate_zoo` only calls add_bsdf / add_object / set_camera, so it fills a
gpuspectral_tpu SceneBuilder exactly as it fills this package's; the BSDF
rows come from the numpy table module both packages share.
"""

from __future__ import annotations

import numpy as np

from ..bsdf import table as bt
from .obj import make_cube, make_rectangle


def populate_zoo(b):
    """Add the zoo's objects, lights and camera to SceneBuilder `b`."""
    pos, nrm, uv = make_rectangle()

    diffuse = b.add_bsdf(bt.diffuse((0.7, 0.7, 0.7)))
    floor_xf = np.array([[4, 0, 0, 0], [0, 0, 4, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, floor_xf, diffuse, twofaced=True)
    back_xf = np.array([[4, 0, 0, 0], [0, 4, 0, 2], [0, 0, -1, -4], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, back_xf, diffuse, twofaced=True)

    kinds = [
        bt.smooth_dielectric(1.5),
        bt.smooth_conductor(0.0),
        bt.smooth_plastic((0.6, 0.2, 0.2), 1.5),
        bt.rough_conductor((1.66, 0.88, 0.52), (9.2, 6.3, 4.8), (1, 1, 1), 0.2),
        bt.smooth_floor((0.3, 0.5, 0.7), 0.04),
        bt.rough_floor((0.7, 0.5, 0.3), 0.04, 0.3),
        bt.rough_plastic((0.2, 0.6, 0.2), 1.5, alpha=0.2),
    ]
    cpos, cnrm, cuv = make_cube()
    for i, k in enumerate(kinds):
        idx = b.add_bsdf(k)
        x = -3.0 + i
        xf = np.array(
            [[0.35, 0, 0, x], [0, 0.35, 0, 0.35], [0, 0, 0.35, 0], [0, 0, 0, 1]],
            np.float32,
        )
        b.add_object(cpos, cnrm, cuv, xf, idx)

    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    light_xf = np.array([[1.5, 0, 0, 0], [0, 0, -1, 4], [0, 1.5, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, light_xf, light, emission=(10.0, 10.0, 10.0))

    b.set_camera(
        np.array([[1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 7], [0, 0, 0, 1]], np.float32),
        fov_radians=np.deg2rad(45),
    )
    return b


def build_zoo(device="cpu"):
    """The zoo as this package's SceneData on `device`."""
    from .data import SceneBuilder, build_scene

    return build_scene(populate_zoo(SceneBuilder()), device)
