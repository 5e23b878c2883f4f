"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy; tables cross over as
numpy arrays.  Tests that need an NVIDIA GPU take the `cuda_device`
fixture, which skips when torch sees no CUDA device, and carry the `cuda`
marker.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch.bsdf import table as bt
from gpuspectral_tpu_torch.bsdf.table import diffuse
from gpuspectral_tpu_torch.scene.obj import make_rectangle
from gpuspectral_tpu_torch.scene.texture import make_checkerboard
from gpuspectral_tpu_torch.utils import profiling

from gpuspectral_tpu_torch.scene.data import ARRAY_FIELDS, META_FIELDS

REPO = pathlib.Path(__file__).resolve().parents[1]
CORNELL_XML = REPO / "scenes" / "cornell" / "scene.xml"

# The suite runs as several pytest workers on one machine, and torch's
# default of one intra-op thread per core in every worker oversubscribes
# the cores many times over: the port's CPU tests took 2.5x as long on six
# workers of an 8-core machine as with one thread each.
torch.set_num_threads(1)


def launches(fn) -> int:
    """The launches a kernel wrapper has counted (utils/profiling:
    "<function>.launch")."""
    return profiling.calls(f"{fn.__name__}.launch")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def jax_scene_arrays(js):
    """(arrays, meta) of a gpuspectral_tpu SceneData for scene_from_arrays."""
    arrays = {}
    for k in ARRAY_FIELDS:
        if k.startswith("cam_"):
            arrays[k] = np.asarray(getattr(js.camera, k[4:]))
        else:
            arrays[k] = np.asarray(getattr(js, k))
    meta = {k: getattr(js, k) for k in META_FIELDS}
    return arrays, meta


def assert_mega_gates(ref, got, rays_ref=None, rays_got=None, *, max_frac=0.02, thresh=1e-3):
    """The statistical gates of tests/test_mega.py: at most `max_frac` of
    pixels off by more than `thresh`, image means within 2e-3, ray counts
    within 1%.  Pixels differ only where a path diverges on a float
    rounding (a seam hit, a near-tie in a lobe or Russian-roulette pick)."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.isfinite(got).all()
    d = np.abs(ref - got).max(-1)
    assert np.mean(d > thresh) <= max_frac, float(np.mean(d > thresh))
    assert abs(float(ref.mean()) - float(got.mean())) < 2e-3
    if rays_ref is not None:
        assert abs(float(rays_ref) - float(rays_got)) / float(rays_ref) < 0.01


def sky(h=8, w=16):
    """A lat-long sky gradient with one bright sun texel."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    env = np.stack([0.4 + 0.5 * yy / h, 0.3 + 0.2 * xx / w, np.full((h, w), 0.6)],
                   axis=-1).astype(np.float32)
    env[2, 3] = (25.0, 20.0, 5.0)  # a bright "sun" texel
    return env


def env_box(builder, with_light: bool, envmap=None):
    """tests/test_envmap.py:_env_box_builder, into any SceneBuilder: an open
    box under an environment emitter, optionally with an area light."""
    s = 1.0
    quads = [
        [[-s, 0, -s], [-s, 0, s], [s, 0, s]], [[-s, 0, -s], [s, 0, s], [s, 0, -s]],
        [[-s, 0, -s], [s, 0, -s], [s, 2, -s]], [[-s, 0, -s], [s, 2, -s], [-s, 2, -s]],
        [[-s, 0, -s], [-s, 2, -s], [-s, 2, s]], [[-s, 0, -s], [-s, 2, s], [-s, 0, s]],
    ]
    v = np.asarray(quads, np.float32)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    nrm = np.broadcast_to(n[:, None, :], (v.shape[0], 3, 3)).copy()
    bidx = builder.add_bsdf(diffuse([0.6, 0.4, 0.3]))
    builder.add_object(v, nrm, None, np.eye(4, dtype=np.float32), bidx)
    if with_light:
        # the light has its own bsdf row: the JAX BVH wavefront misreads an
        # emissive triangle of bsdf row 0 (see bvh/ftb.py:unpack_meta)
        lv = np.asarray([[[-0.2, 1.9, -0.2], [0.2, 1.9, -0.2], [0.2, 1.9, 0.2]]], np.float32)
        ln = np.broadcast_to(np.float32([0, -1, 0]), (1, 3, 3)).copy()
        builder.add_object(lv, ln, None, np.eye(4, dtype=np.float32),
                           builder.add_bsdf(diffuse([0.0, 0.0, 0.0])), emission=(6.0, 6.0, 6.0))
    if envmap is None:
        envmap = np.broadcast_to(np.float32([1.5, 0.8, 0.4]), (1, 1, 3))
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]  # a turned map
    builder.set_envmap(envmap, to_world=rot)
    to_world = np.eye(4, dtype=np.float32)
    to_world[:3, 3] = (0.0, 1.0, 3.0)
    to_world[2, 2] = -1.0
    builder.set_camera(to_world, float(np.deg2rad(60.0)))
    return builder


def textured_floor(builder, texture):
    """tests/test_textures.py:_textured_scene, into any SceneBuilder."""
    pos, nrm, uv = make_rectangle()
    mat = builder.add_bsdf(bt.diffuse((1.0, 1.0, 1.0)), texture=texture)
    floor = np.array([[2, 0, 0, 0], [0, 0, 2, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    builder.add_object(pos, nrm, uv, floor, mat, twofaced=True)
    plastic = builder.add_bsdf(bt.rough_plastic((0.2, 0.6, 0.2), 1.5, alpha=0.2),
                               texture=make_checkerboard((1, 0.5, 0.5), (0.5, 0.5, 1), 4, 2))
    wall = np.array([[1, 0, 0, 0], [0, 1, 0, 1], [0, 0, 1, -1.5], [0, 0, 0, 1]], np.float32)
    builder.add_object(pos, nrm, uv, wall, plastic)
    light = builder.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    lxf = np.array([[1, 0, 0, 0], [0, 0, -1, 3], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    builder.add_object(pos, nrm, uv, lxf, light, emission=(10.0, 10.0, 10.0))
    builder.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 4], [0, 0, 0, 1]],
                                np.float32), np.deg2rad(60))
    return builder


def mixed_bsdf_scene(builder):
    """tests/test_mega_grad.py:230's mixed-BSDF scene, into any SceneBuilder:
    a diffuse floor, a mirror cube and an area light.  Returns (builder,
    (diffuse row, mirror row, light row))."""
    from gpuspectral_tpu_torch.scene.obj import make_cube

    rpos, rnrm, ruv = make_rectangle()
    cpos, cnrm, cuv = make_cube()
    kd = builder.add_bsdf(bt.diffuse((0.6, 0.4, 0.3)))
    mirror = builder.add_bsdf(bt.smooth_conductor(0.0))
    floor = np.array([[2, 0, 0, 0], [0, 0, 2, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    builder.add_object(rpos, rnrm, ruv, floor, kd, twofaced=True)
    boxxf = np.array([[0.5, 0, 0, -0.5], [0, 0.5, 0, -0.49], [0, 0, 0.5, 0], [0, 0, 0, 1]],
                     np.float32)
    builder.add_object(cpos, cnrm, cuv, boxxf, mirror)
    light = builder.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    lxf = np.array([[1, 0, 0, 0], [0, 0, -1, 2.5], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    builder.add_object(rpos, rnrm, ruv, lxf, light, emission=(8.0, 8.0, 8.0))
    builder.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 0.6], [0, 0, -1, 3], [0, 0, 0, 1]],
                                np.float32), np.deg2rad(60))
    return builder, (kd, mirror, light)


def textured_diffuse_scene(builder):
    """tests/test_mega_grad.py:289's vertex-textured diffuse scene (a
    u-gradient texture on a diffuse floor, an area light)."""
    from gpuspectral_tpu_torch.scene.data import TEX_RES

    pos, nrm, uv = make_rectangle()
    u = (np.arange(TEX_RES, dtype=np.float32) + 0.5) / TEX_RES
    grad_tex = np.broadcast_to(u[None, :, None], (TEX_RES, TEX_RES, 3)).copy()
    mat = builder.add_bsdf(bt.diffuse((0.7, 0.5, 0.4)), texture=grad_tex)
    floor = np.array([[2, 0, 0, 0], [0, 0, 2, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    builder.add_object(pos, nrm, uv, floor, mat, twofaced=True)
    light = builder.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    lxf = np.array([[1, 0, 0, 0], [0, 0, -1, 3], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    builder.add_object(pos, nrm, uv, lxf, light, emission=(10.0, 10.0, 10.0))
    builder.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 4], [0, 0, 0, 1]],
                                np.float32), np.deg2rad(60))
    return builder
