"""Scenes built in code.

  zoo           floor, back wall, one small cube of each of the seven
                non-diffuse BSDF kinds, and a ceiling area light (the scene
                of tests/test_all_bsdfs_scene.py)
  sphere field  a BVH-scale scene: a grid of UV spheres cycling through all
                eight BSDF kinds on a checkerboard-textured floor, a back
                wall, one quad area light and a procedural lat-long sky; at
                its full size (6x6 spheres of 64 segments x 32 rings, a 32x64
                sky) 147,460 triangles, the class of the reference's coffee
                scene (168k), with a textured material and an image
                environment of 2048 texels; "sphere_field_noenv" is the same
                scene without the sky (the gradient benchmark's)
  one weekend   the final scene of "Ray Tracing in One Weekend": 486 UV
                spheres of random materials on a ground square under the
                book's sky gradient, 466,562 triangles and 487 BSDF rows at
                its full size, lit by the sky alone

The populate_* functions only call add_bsdf / add_object / set_envmap /
set_camera, so they fill a gpuspectral_tpu SceneBuilder exactly as they fill
this package's; the BSDF rows and the texture come from numpy modules.
"""

from __future__ import annotations

import numpy as np

from ..bsdf import table as bt
from .obj import make_cube, make_rectangle
from .texture import make_checkerboard


def populate_zoo(b, diffuse_only: bool = False):
    """Add the zoo's objects, lights and camera to SceneBuilder `b`.
    diffuse_only: the seven cubes get diffuse BSDFs of six colours instead
    (eight BSDF rows in all: a scene the fused-gradient kernel K5 takes)."""
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
    if diffuse_only:
        colours = [(0.8, 0.2, 0.2), (0.2, 0.8, 0.2), (0.2, 0.2, 0.8), (0.8, 0.8, 0.2),
                   (0.2, 0.8, 0.8), (0.6, 0.4, 0.3)]
        rows = [b.add_bsdf(bt.diffuse(c)) for c in colours]
        kinds = [None] * len(kinds)
    cpos, cnrm, cuv = make_cube()
    for i, k in enumerate(kinds):
        idx = rows[i % len(rows)] if diffuse_only else b.add_bsdf(k)
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


def build_zoo(device="cuda", diffuse_only: bool = False):
    """The zoo as this package's SceneData on `device`."""
    from .data import SceneBuilder, build_scene

    return build_scene(populate_zoo(SceneBuilder(), diffuse_only), device)


def _uv_sphere(segs: int, rings: int):
    """Unit UV sphere: (positions, normals, uvs) of its triangles, wound
    counter-clockwise seen from outside; the pole rings are single
    triangles."""
    th = np.pi * np.arange(rings + 1) / rings
    ph = 2.0 * np.pi * np.arange(segs + 1) / segs
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    grid = np.stack(np.broadcast_arrays(st * np.cos(ph), ct + 0.0 * ph, st * np.sin(ph)),
                    -1).astype(np.float32)  # (rings+1, segs+1, 3)
    uvg = np.stack(np.broadcast_arrays(ph[None, :] / (2 * np.pi), 1.0 - th[:, None] / np.pi),
                   -1).astype(np.float32)
    i, j = np.meshgrid(np.arange(rings), np.arange(segs), indexing="ij")
    i, j = i.ravel(), j.ravel()
    upper = [(i, j), (i, j + 1), (i + 1, j)]
    lower = [(i, j + 1), (i + 1, j + 1), (i + 1, j)]
    keep_u, keep_l = i > 0, i < rings - 1
    tris = [np.stack([grid[a, b] for a, b in upper], 1)[keep_u],
            np.stack([grid[a, b] for a, b in lower], 1)[keep_l]]
    uvs = [np.stack([uvg[a, b] for a, b in upper], 1)[keep_u],
           np.stack([uvg[a, b] for a, b in lower], 1)[keep_l]]
    pos = np.concatenate(tris)
    return pos, pos.copy(), np.concatenate(uvs)


def _floor_grid(n: int, half: float):
    """An n x n grid of quads over [-half, half]^2 at y = 0, facing +y, its
    uvs spanning [0, 1] across the floor.  Fine enough that shading with
    per-corner texels (the fused-BVH megakernel's rule) follows the
    checkerboard closely."""
    x = np.linspace(-half, half, n + 1, dtype=np.float32)
    uv = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.ravel(), j.ravel()

    def corner(a, b):
        return (np.stack([x[a], np.zeros_like(x[a]), x[b]], -1),
                np.stack([uv[a], 1.0 - uv[b]], -1))

    quads = [corner(i, j), corner(i, j + 1), corner(i + 1, j + 1), corner(i + 1, j)]
    tri = [(0, 1, 2), (0, 2, 3)]
    pos = np.concatenate([np.stack([quads[k][0] for k in t], 1) for t in tri])
    uvs = np.concatenate([np.stack([quads[k][1] for k in t], 1) for t in tri])
    nrm = np.broadcast_to(np.float32([0.0, 1.0, 0.0]), pos.shape).copy()
    return pos.astype(np.float32), nrm, uvs.astype(np.float32)


def _sky(h: int, w: int) -> np.ndarray:
    """Procedural lat-long sky (row 0 = zenith): a blue-to-white gradient
    above the horizon, a dim ground below, and a small bright sun."""
    v = (np.arange(h, dtype=np.float32) + 0.5) / h  # 0 zenith .. 1 nadir
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]
    zenith = np.array([0.25, 0.45, 0.9], np.float32)
    horizon = np.array([0.9, 0.9, 0.85], np.float32)
    ground = np.array([0.12, 0.1, 0.08], np.float32)
    col = np.where((v < 0.5)[:, None], up * zenith + (1.0 - up) * horizon, ground)
    sky = np.broadcast_to(col[:, None, :], (h, w, 3)).copy()
    sun_y, sun_x = max(0, h // 5), (3 * w) // 8
    sky[sun_y, sun_x] = (60.0, 55.0, 45.0)
    return sky.astype(np.float32)


def populate_sphere_field(b, n_side: int = 6, segs: int = 64, rings: int = 32,
                          sky_hw=(32, 64)):
    """Add the sphere field to SceneBuilder `b`: n_side x n_side spheres
    (radius 0.4, 1.0 apart) whose BSDFs cycle through all eight kinds, a
    checkerboard-textured floor, a back wall, a quad area light and a
    sky_hw lat-long sky (no environment emitter when sky_hw is None)."""
    rect_pos, rect_nrm, rect_uv = make_rectangle()
    half = n_side / 2.0
    s = half + 2.0
    floor_mat = b.add_bsdf(bt.diffuse((0.8, 0.8, 0.8)),
                           texture=make_checkerboard((0.9, 0.9, 0.9), (0.25, 0.25, 0.3),
                                                     n_side, n_side))
    fpos, fnrm, fuv = _floor_grid(8 * n_side, s)
    b.add_object(fpos, fnrm, fuv, np.eye(4, dtype=np.float32), floor_mat, twofaced=True)
    wall = b.add_bsdf(bt.diffuse((0.6, 0.55, 0.5)))
    back_xf = np.array([[s, 0, 0, 0], [0, s, 0, s - 1.0], [0, 0, -1, -(half + 1.0)],
                        [0, 0, 0, 1]], np.float32)
    b.add_object(rect_pos, rect_nrm, rect_uv, back_xf, wall, twofaced=True)

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
        xf = np.array([[0.4, 0, 0, x], [0, 0.4, 0, 0.4], [0, 0, 0.4, z], [0, 0, 0, 1]],
                      np.float32)
        b.add_object(spos, snrm, suv, xf, rows[k % len(rows)])

    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    light_xf = np.array([[1.5, 0, 0, 0], [0, 0, -1, half + 2.0], [0, 1.5, 0, 0],
                         [0, 0, 0, 1]], np.float32)
    b.add_object(rect_pos, rect_nrm, rect_uv, light_xf, light, emission=(12.0, 12.0, 12.0))
    if sky_hw is not None:
        b.set_envmap(_sky(*sky_hw))

    # look at the grid from the front, above
    eye = np.array([0.0, half + 1.0, 2.0 * half + 2.5], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    left = np.cross([0.0, 1.0, 0.0], fwd)
    left /= np.linalg.norm(left)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = left, np.cross(fwd, left), fwd, eye
    b.set_camera(cam, fov_radians=np.deg2rad(45))
    return b


def populate_sphere_field_noenv(b):
    """The sphere field without its sky: the fused-gradient kernels (K6,
    like the JAX kernel) take no scene with an environment emitter, so this
    is the BVH-scale scene of the gradient benchmark."""
    return populate_sphere_field(b, sky_hw=None)


def _one_weekend_sky(h: int = 32, w: int = 64) -> np.ndarray:
    """The book's sky as a lat-long map (row 0 = zenith), constant along a
    row: lerp(white, (0.5, 0.7, 1.0), t) with t = 0.5 (cos theta + 1) at
    the row's centre."""
    t = 0.5 * (np.cos(np.pi * (np.arange(h) + 0.5) / h) + 1.0)[:, None]
    col = (1.0 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
    return np.broadcast_to(col[:, None, :], (h, w, 3)).astype(np.float32)


def populate_one_weekend(b, grid: int = 11, segs: int = 32, rings: int = 16):
    """Add the final scene of Peter Shirley's "Ray Tracing in One Weekend"
    (its random_scene()) to SceneBuilder `b`: a grey Lambertian ground, a
    small sphere (radius 0.2) at (a + 0.9 U, 0.2, b + 0.9 U) for a, b in
    [-grid, grid) unless it lies within 0.9 of (4, 0.2, 0), of a material
    drawn by choose_mat = U (below 0.8 Lambertian with albedo U3 * U3,
    below 0.95 metal with albedo in [0.5, 1) and fuzz in [0, 0.5), else
    glass of IOR 1.5), three spheres of radius 1 (glass at (0, 1, 0),
    Lambertian (0.4, 0.2, 0.1) at (-4, 1, 0), metal (0.7, 0.6, 0.5) of fuzz
    0 at (4, 1, 0)), the camera at (13, 2, 3) looking at the origin with a
    vertical field of view of 20 degrees at aspect 3:2, and a sky gradient
    the only light.  The draws come from np.random.default_rng(0) in the
    book's order: the scene is fixed.  At the defaults: 486 spheres and the
    ground, 466,562 triangles, 487 BSDF rows (one for each object).

    Where it departs from the book (the port traces triangles, and has
    neither the book's materials nor a thin lens):
      * each sphere is a UV mesh of `segs` x `rings` with smooth vertex
        normals (960 triangles at the defaults);
      * the ground sphere (centre (0, -1000, 0), radius 1000) is its tangent
        square at y = 0, 2000 on a side: two triangles, two-faced;
      * Lambertian is bt.diffuse, glass bt.smooth_dielectric(1.5) (exact
        Fresnel, not Schlick's), metal bt.rough_conductor with eta 1, k 10
        (0.96 reflectance at normal incidence), the albedo as its
        reflectance and alpha = max(fuzz, 0.01) (a Beckmann lobe, not a
        perturbation inside a sphere of radius fuzz);
      * a pinhole: the aperture 0.1 becomes 0; the port's field of view
        spans the wider side, so fov_radians = 2 atan(1.5 tan 10 deg);
      * the sky is a 32 x 64 map (_one_weekend_sky), which the fused
        kernels take (mega.MEGA_ENV_MAX_TEXELS);
      * the estimator is the port's: NEE on the sky with MIS and Russian
        roulette, where the book samples the BSDF alone.  Both would
        estimate the same image, but the port's MIS gives a BSDF-sampled
        sky hit full weight when the sky sample of its vertex fell below
        the surface, so its image reads a few per cent brighter."""
    g = np.random.default_rng(0)
    spos, snrm, suv = _uv_sphere(segs, rings)

    def sphere(centre, radius, row):
        xf = np.eye(4, dtype=np.float32)
        xf[:3, :3] *= np.float32(radius)
        xf[:3, 3] = centre
        b.add_object(spos, snrm, suv, xf, row)

    rect_pos, rect_nrm, rect_uv = make_rectangle()
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
    b.set_envmap(_one_weekend_sky())

    eye = np.array([13.0, 2.0, 3.0])
    fwd = -eye / np.linalg.norm(eye)
    left = np.cross([0.0, 1.0, 0.0], fwd)
    left /= np.linalg.norm(left)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = left, np.cross(fwd, left), fwd, eye
    b.set_camera(cam, fov_radians=2.0 * np.arctan(1.5 * np.tan(np.deg2rad(10.0))))
    return b


# scenes built in code, by the name the CLI takes as "builtin:<name>"
BUILTIN = {"sphere_field": populate_sphere_field,
           "sphere_field_noenv": populate_sphere_field_noenv,
           "one_weekend": populate_one_weekend}


def build_sphere_field(device="cuda", **kw):
    """The sphere field as this package's SceneData on `device`
    (populate_sphere_field's keywords)."""
    from .data import SceneBuilder, build_scene

    return build_scene(populate_sphere_field(SceneBuilder(), **kw), device)
