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

from gpuspectral_tpu_torch.scene.data import ARRAY_FIELDS

REPO = pathlib.Path(__file__).resolve().parents[1]
CORNELL_XML = REPO / "scenes" / "cornell" / "scene.xml"


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
    meta = dict(num_tris=js.num_tris, num_lights=js.num_lights,
                kinds_present=js.kinds_present, has_area_lights=js.has_area_lights,
                has_textures=js.has_textures, has_envmap=js.has_envmap)
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
