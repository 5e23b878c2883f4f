"""PyTorch port: the fused-BVH megakernel's plain version,
render_mega_bvh_rows_ref (the torch wavefront on the plain K3 over the
kernel's pixel rows, textures by the per-corner blend), against the JAX
kernel render_mega_bvh(..., interpret=True) under the gates of
tests/test_mega_bvh.py; K1's environment path (its plain version) against
the JAX megakernel under the gates of tests/test_mega.py; and the
dispatch of render_image_stats_auto.  The CUDA kernels against their plain
versions: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from gpuspectral_tpu.bvh import build as bvh_build
from gpuspectral_tpu.integrator import mega as jmega
from gpuspectral_tpu.integrator import mega_bvh as jmb
from gpuspectral_tpu.scene import load_mitsuba_scene as jax_load
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.integrator import mega, mega_bvh, render_image_stats_auto
from gpuspectral_tpu_torch.scene.data import TEX_RES, scene_from_arrays
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import (CORNELL_XML, assert_mega_gates, env_box, jax_scene_arrays,
                          launches, sky as _sky, textured_floor)


def _cfg(**kw):
    base = dict(width=32, height=32, spp=2, max_depth=3, ray_batch=1024, use_bvh=True)
    base.update(kw)
    return base


def _port(js):
    return scene_from_arrays(*jax_scene_arrays(js), "cpu")


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    return cornell_scene, _port(cornell_scene)


def _k4_both(js, ts, **kw):
    ref, rays_ref = jmb.render_mega_bvh(js, JaxConfig(**_cfg(**kw)), 0, interpret=True)
    got, rays_got = mega_bvh.render_mega_bvh(ts, RenderConfig(**_cfg(**kw)), 0)
    return np.asarray(ref), float(rays_ref), got.numpy(), rays_got


def test_eligibility(cornell):
    ts = cornell[1]
    assert mega_bvh.mega_bvh_eligible(ts, RenderConfig(**_cfg()))
    assert not mega_bvh.mega_bvh_eligible(ts, RenderConfig(**_cfg(use_bvh=False)))
    assert mega_bvh.mega_bvh_eligible(ts, RenderConfig(**_cfg(light_sampling="power")))


def test_big_sky_stays_on_the_wavefront(monkeypatch):
    """Maps past MEGA_ENV_MAX_TEXELS are ineligible for both megakernels
    (tests/test_envmap.py:337): even forced, dispatch takes the wavefront."""
    big = np.random.default_rng(0).uniform(0.1, 1.0, (64, 64, 3)).astype(np.float32)
    js = env_box(JaxBuilder(), True, big).build()
    ts = _port(js)
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, ray_batch=64)
    assert not jmega.mega_eligible(js, JaxConfig(width=8, height=8))
    assert not mega.mega_eligible(ts, cfg)
    assert not mega_bvh.mega_bvh_eligible(ts, cfg.replace(use_bvh=True))
    small = _port(env_box(JaxBuilder(), True, _sky(32, 64)).build())
    assert mega.mega_eligible(small, cfg) and mega_bvh.mega_bvh_eligible(
        small, cfg.replace(use_bvh=True))

    def fail(*a, **k):
        raise AssertionError("megakernel dispatched")

    monkeypatch.setattr(mega_bvh, "render_mega_bvh", fail)
    monkeypatch.setattr(mega, "render_mega", fail)
    img, rays = render_image_stats_auto(ts, cfg.replace(use_bvh=True, intersector="mega_bvh"))
    assert bool(torch.isfinite(img).all()) and rays > 0


def test_forced_mega_bvh_on_cpu_runs_the_plain_version(cornell):
    ts = cornell[1]
    cfg = RenderConfig(**_cfg(max_depth=2, spp=1, intersector="mega_bvh"))
    n0 = launches(mega_bvh.render_mega_bvh_rows)
    got, rays = render_image_stats_auto(ts, cfg, 0)
    ref, rays_ref = mega_bvh.render_mega_bvh(ts, cfg, 0)
    assert torch.equal(got, ref) and rays == rays_ref
    assert launches(mega_bvh.render_mega_bvh_rows) == n0


def test_uniform_matches_jax_kernel(cornell):
    ref, rays_ref, got, rays_got = _k4_both(*cornell)
    assert_mega_gates(ref, got, rays_ref, rays_got)


def test_power_exact_matches_jax_kernel(cornell):
    # tests/test_mega_bvh.py:53-67: shared-edge tie-break flips only
    ref, _, got, _ = _k4_both(*cornell, light_sampling="power", mis_mode="exact", spp=4)
    d = np.abs(got - ref).max(-1)
    assert (d > 1e-4).sum() <= 8, (d > 1e-4).sum()
    assert abs(got.mean() - ref.mean()) < 2e-3


def test_slot_mode_matches_jax_kernel(monkeypatch):
    monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
    js = jax_load(str(CORNELL_XML))[0]
    ref, _, got, rays_got = _k4_both(js, _port(js), max_depth=4)
    d = np.abs(got - ref).max(-1)
    assert (d > 1e-4).sum() <= 8, (d > 1e-4).sum()
    assert abs(got.mean() - ref.mean()) < 2e-3
    assert rays_got > 0


def test_textured_vertex_sampling_matches_jax_kernel():
    """Both kernels blend per-corner texels barycentrically
    (tests/test_mega_bvh.py:134): a u-gradient texture."""
    u = (np.arange(TEX_RES, dtype=np.float32) + 0.5) / TEX_RES
    grad = np.broadcast_to(u[None, :, None], (TEX_RES, TEX_RES, 3)).copy()
    js = textured_floor(JaxBuilder(), grad).build()
    ref, rays_ref, got, rays_got = _k4_both(js, _port(js), spp=4, max_depth=2)
    assert ref.max() > 0
    assert_mega_gates(ref, got, rays_ref, rays_got)


def test_image_env_matches_jax_kernel():
    js = env_box(JaxBuilder(), True, _sky()).build()
    ref, rays_ref, got, rays_got = _k4_both(js, _port(js), width=16, height=16)
    assert_mega_gates(ref, got, rays_ref, rays_got)


@pytest.mark.parametrize("with_light", [False, True])
@pytest.mark.parametrize("kind", ["constant", "image"])
def test_k1_environment_matches_jax_kernel(kind, with_light):
    """K1's environment path (tests/test_envmap.py:246-335): the plain
    version against the JAX megakernel."""
    js = env_box(JaxBuilder(), with_light, _sky() if kind == "image" else None).build()
    ts = _port(js)
    base = dict(width=16, height=16, spp=2, max_depth=3, ray_batch=256)
    assert mega.mega_eligible(ts, RenderConfig(**base))
    ref, rays_ref = jmega.render_mega(js, JaxConfig(**base), 0, interpret=True)
    got, rays_got = mega.render_mega(ts, RenderConfig(**base), 0)
    assert_mega_gates(np.asarray(ref), got.numpy(), float(rays_ref), rays_got)
