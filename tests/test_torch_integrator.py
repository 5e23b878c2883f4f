"""PyTorch port: the wavefront path tracer against the JAX wavefront
(gpuspectral_tpu.integrator.path_tracer.render_image_stats) on the same
scene tables, carried across with scene_from_arrays.

Both draw the same counter-based random numbers and run the same estimator,
so they differ only where a path diverges on a float rounding: XLA-CPU
fuses more multiply-adds into FMAs than the port does (the port fuses
those of the Woop test and the hit point, where a rounding moves a ray
across a seam) and takes sin/cos/log from another libm than torch-CPU.  Emission-only renders involve no random draw and must be
exact; renders with bounces are held to the gates of tests/test_mega.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.integrator.path_tracer import render_image_stats as jax_render_stats
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.integrator import render_image_auto, render_image_stats_auto
from gpuspectral_tpu_torch.ops import cuda_isect
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.scene.zoo import populate_zoo
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import REPO, assert_mega_gates, jax_scene_arrays, launches

PINNED = REPO / "tests" / "data" / "cornell_64x64_spp32_d6_seed0.npz"


@pytest.fixture(scope="module")
def pair(cornell_scene):
    """(JAX scene, the port's scene from the same tables) by name."""
    zoo = populate_zoo(JaxBuilder()).build()
    return {name: (js, scene_from_arrays(*jax_scene_arrays(js), "cpu"))
            for name, js in (("cornell", cornell_scene), ("zoo", zoo))}


def _both(pair, name, **kw):
    js, ts = pair[name]
    base = dict(width=32, height=32, ray_batch=1024)
    base.update(kw)
    ref, rays_ref = jax_render_stats(js, JaxConfig(**base), jnp.uint32(0))
    got, rays_got = pt.render_image_stats(ts, RenderConfig(**base), 0)
    return np.asarray(ref), float(rays_ref), got.numpy(), rays_got


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_emission_only_exact(pair, name):
    ref, rays_ref, got, rays_got = _both(pair, name, max_depth=0, nee=False, spp=1)
    assert ref.max() > 0
    np.testing.assert_array_equal(got, ref)
    assert rays_got == rays_ref


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_one_bounce_matches_jax(pair, name):
    ref, _, got, _ = _both(pair, name, max_depth=1, nee=False, spp=1)
    d = np.abs(ref - got).max(-1)
    assert np.mean(d > 1e-4) < 0.01
    assert abs(ref.mean() - got.mean()) < 2e-3


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_full_matches_jax(pair, name):
    ref, rays_ref, got, rays_got = _both(pair, name, max_depth=4, nee=True, spp=2)
    assert_mega_gates(ref, got, rays_ref, rays_got)


@pytest.mark.parametrize("opts", [
    dict(mis_mode="exact"),
    dict(light_sampling="power"),
    dict(light_block=64),
    dict(jitter=True),
    dict(nee=False),
], ids=["mis_exact", "power", "light_block", "jitter", "no_nee"])
def test_options_match_jax(pair, opts):
    ref, rays_ref, got, rays_got = _both(pair, "cornell", max_depth=4, spp=2, **opts)
    assert_mega_gates(ref, got, rays_ref, rays_got)


def test_pinned_seed_regression(pair):
    # tests/test_regression_image.py:25-28 gates on the committed snapshot
    ref = np.load(PINNED)["img"]
    cfg = RenderConfig(width=64, height=64, spp=32, max_depth=6, ray_batch=4096)
    img = pt.render_image(pair["cornell"][1], cfg, 0).numpy()
    assert img.shape == ref.shape
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=1e-4)
    rel = np.abs(img - ref) / np.maximum(ref, 1e-2)
    assert np.quantile(rel, 0.99) < 5e-3, float(np.quantile(rel, 0.99))
    assert rel.max() < 0.05, float(rel.max())


def test_auto_dispatch_on_cpu_is_the_wavefront(pair):
    ts = pair["cornell"][1]
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3, ray_batch=256)
    n0 = launches(cuda_isect.closest_cuda)
    img, rays = render_image_stats_auto(ts, cfg, 5)
    ref, rays_ref = pt.render_image_stats(ts, cfg, 5)
    assert torch.equal(img, ref) and rays == rays_ref
    assert torch.equal(render_image_auto(ts, cfg, 5), ref)
    assert launches(cuda_isect.closest_cuda) == n0


def test_ray_batch_does_not_change_the_image(pair):
    ts = pair["cornell"][1]
    a, ra = pt.render_image_stats(ts, RenderConfig(width=16, height=16, spp=2, max_depth=3, ray_batch=64), 0)
    b, rb = pt.render_image_stats(ts, RenderConfig(width=16, height=16, spp=2, max_depth=3, ray_batch=256), 0)
    assert torch.equal(a, b) and ra == rb


def test_render_sample_matches_jax(pair):
    from gpuspectral_tpu.integrator.path_tracer import render_sample as jax_render_sample

    js, ts = pair["cornell"]
    cfg = dict(width=16, height=16, max_depth=3)
    pix = np.arange(256, dtype=np.uint32)
    ref, rays_ref = jax_render_sample(js, JaxConfig(**cfg), jnp.asarray(pix), jnp.uint32(3))
    got, rays_got = pt.render_sample(ts, RenderConfig(**cfg), torch.as_tensor(pix.astype(np.int64)), 3)
    assert_mega_gates(np.asarray(ref)[:, None], got.numpy()[:, None],
                      float(np.asarray(rays_ref).sum()), float(rays_got.sum()))


def test_later_slices_raise(pair):
    # BVH traversal, ray sorting and every BVH kernel of the JAX package are
    # in the port; a bvh_kernel it does not have raises
    ts = pair["cornell"][1]
    for kw in (dict(use_bvh=True, bvh_kernel="bogus"),):
        with pytest.raises(NotImplementedError):
            pt.render_image_stats(ts, RenderConfig(width=8, height=8, spp=1, max_depth=1, **kw))
    img, rays = pt.render_image_stats(ts, RenderConfig(width=8, height=8, spp=1, max_depth=1,
                                                       use_bvh=True, sort_rays=True))
    assert bool(torch.isfinite(img).all()) and rays > 0
