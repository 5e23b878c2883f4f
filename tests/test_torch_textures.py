"""PyTorch port: textures (scene/texture.py, the wavefront's texture
lookup and modulation).  The checkerboard atlas and the nearest-texel
lookup equal the JAX package's bit for bit (run eagerly); the textured
wavefront is held to the JAX wavefront under the gates of tests/test_mega.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.integrator import path_tracer as jpt
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.scene.texture import make_checkerboard as jax_checkerboard
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.scene import data as tdata
from gpuspectral_tpu_torch.scene.texture import make_checkerboard, missing_texture
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import assert_mega_gates, jax_scene_arrays, textured_floor


@pytest.mark.parametrize("args", [((1, 0, 0), (0, 0, 1), 1, 1), ((0.9, 0.8, 0.7), (0.1, 0.2, 0.3), 8, 3)])
def test_checkerboard_equal_jax(args):
    got = make_checkerboard(*args)
    np.testing.assert_array_equal(got, jax_checkerboard(*args))
    assert got.shape == (tdata.TEX_RES, tdata.TEX_RES, 3) and got.dtype == np.float32
    assert (missing_texture() == 1.0).all()


def _pair():
    # a low-contrast checker: where XLA's fused uv arithmetic and the
    # port's pick neighbouring texels, a pixel moves by a fraction of it
    checker = make_checkerboard((0.9, 0.9, 0.9), (0.6, 0.6, 0.6), 8, 8)
    js = textured_floor(JaxBuilder(), checker).build()
    return js, tdata.scene_from_arrays(*jax_scene_arrays(js), "cpu")


def test_texture_lookup_bitwise():
    js, ts = _pair()
    assert ts.has_textures and ts.textures.shape[0] == 2
    rng = np.random.default_rng(0)
    n = 4096
    uv_c = rng.uniform(-2, 3, size=(n, 3, 2)).astype(np.float32)
    tex_id = rng.integers(-1, 2, size=n).astype(np.int32)
    bu = rng.uniform(0, 1, size=n).astype(np.float32)
    bv = (rng.uniform(0, 1, size=n) * (1 - bu)).astype(np.float32)
    want = np.asarray(jpt._texture_lookup(js, jnp.asarray(uv_c), jnp.asarray(tex_id),
                                          jnp.asarray(bu), jnp.asarray(bv)))
    got = pt._texture_lookup(ts, torch.as_tensor(uv_c), torch.as_tensor(tex_id),
                             torch.as_tensor(bu), torch.as_tensor(bv)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[tex_id < 0] == 1.0).all()


@pytest.mark.parametrize("opts", [dict(), dict(use_bvh=True, intersector="pallas")],
                         ids=["brute", "bvh"])
def test_textured_wavefront_matches_jax(opts):
    js, ts = _pair()
    base = dict(width=24, height=24, spp=2, max_depth=3, ray_batch=576, **opts)
    ref, rays_ref = jpt.render_image_stats(js, JaxConfig(**base), jnp.uint32(0))
    got, rays_got = pt.render_image_stats(ts, RenderConfig(**base), 0)
    assert_mega_gates(np.asarray(ref), got.numpy(), float(rays_ref), rays_got)
    # and the texture really shades: a white texture renders like none
    plain = tdata.scene_from_arrays(*jax_scene_arrays(
        textured_floor(JaxBuilder(), np.ones((tdata.TEX_RES,) * 2 + (3,), np.float32)).build()),
        "cpu")
    white = pt.render_image_stats(plain, RenderConfig(**base), 0)[0].numpy()
    assert (got.numpy() <= white + 1e-5).all() and (white - got.numpy()).max() > 1e-2
