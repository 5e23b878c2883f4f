"""PyTorch port: the megakernel's plain version, render_mega_rows_ref (the
torch wavefront over the kernel's pixel rows), against the JAX megakernel
render_mega(..., interpret=True), under the gates of tests/test_mega.py
(the CUDA kernel K1 against the plain version: tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from gpuspectral_tpu.integrator import mega as jmega
from gpuspectral_tpu_torch.integrator import mega
from gpuspectral_tpu_torch.integrator import render_image_stats_auto
from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.utils import RenderConfig
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig

from torch_common import assert_mega_gates, jax_scene_arrays, launches


@pytest.fixture(scope="module")
def scenes(cornell_scene):
    return cornell_scene, scene_from_arrays(*jax_scene_arrays(cornell_scene), "cpu")


def _cfg(**kw):
    base = dict(width=32, height=32, ray_batch=1024)
    base.update(kw)
    return base


def _both(scenes, **kw):
    js, ts = scenes
    ref, rays_ref = jmega.render_mega(js, JaxConfig(**_cfg(**kw)), 0, interpret=True)
    got, rays_got = mega.render_mega(ts, RenderConfig(**_cfg(**kw)), 0)
    return np.asarray(ref), float(rays_ref), got.numpy(), rays_got


def test_eligibility(scenes):
    ts = scenes[1]
    assert mega.mega_eligible(ts, RenderConfig())
    assert not mega.mega_eligible(ts, RenderConfig(use_bvh=True))
    assert not mega.mega_eligible(ts, RenderConfig(light_sampling="power"))


def test_emission_only_exact(scenes):
    ref, rays_ref, got, rays_got = _both(scenes, max_depth=0, nee=False, spp=1)
    np.testing.assert_array_equal(got, ref)
    assert rays_got == rays_ref


def test_one_bounce_matches_jax_megakernel(scenes):
    ref, _, got, _ = _both(scenes, max_depth=1, nee=False, spp=1)
    d = np.abs(ref - got).max(-1)
    assert np.mean(d > 1e-4) < 0.01
    assert abs(ref.mean() - got.mean()) < 2e-3


def test_full_matches_jax_megakernel(scenes):
    ref, rays_ref, got, rays_got = _both(scenes, max_depth=4, nee=True, spp=2)
    assert_mega_gates(ref, got, rays_ref, rays_got)


def test_padding_lanes_left_out(scenes):
    # 24x24 = 576 pixels fill 4.5 rows of 128 lanes: the padded lanes point
    # at pixel 0 and count neither in the image nor in the ray total
    ref, rays_ref, got, rays_got = _both(scenes, width=24, height=24, max_depth=2, spp=1)
    assert got.shape == (24, 24, 3)
    assert_mega_gates(ref, got, rays_ref, rays_got)
    full = render_image_stats(scenes[1], RenderConfig(width=24, height=24, max_depth=2, spp=1,
                                                      ray_batch=576), 0)
    np.testing.assert_array_equal(got, full[0].numpy())
    assert rays_got == full[1]


def test_timestamp_advances_samples(scenes):
    ts = scenes[1]
    cfg = RenderConfig(**_cfg(max_depth=2, nee=True, spp=1))
    a = mega.render_mega(ts, cfg, 0)[0].numpy()
    b = mega.render_mega(ts, cfg, 7)[0].numpy()
    assert not np.array_equal(a, b)
    assert abs(a.mean() - b.mean()) < 0.02


def test_forced_mega_on_cpu_runs_the_plain_version(scenes):
    ts = scenes[1]
    cfg = RenderConfig(**_cfg(max_depth=2, spp=1, intersector="mega"))
    n0 = launches(mega.render_mega_rows)
    got, rays = render_image_stats_auto(ts, cfg, 0)
    ref, rays_ref = mega.render_mega(ts, cfg, 0)
    assert torch.equal(got, ref) and rays == rays_ref
    assert launches(mega.render_mega_rows) == n0


def test_render_mega_rows_validates(scenes):
    ts = scenes[1]
    cfg = RenderConfig(**_cfg(spp=1, max_depth=1))
    with pytest.raises(ValueError, match="pix"):
        mega.render_mega_rows(ts, cfg, torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="pix"):
        mega.render_mega_rows(ts, cfg, torch.zeros((2, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="eligible"):
        mega.render_mega_rows(ts, cfg.replace(light_sampling="power"),
                              torch.zeros((2, 128), dtype=torch.int32))


def test_pack_tables_match_jax(scenes):
    js, ts = scenes
    _, attr_j, light_j, cam_j = jmega._pack_tables(js)
    woop_t, attr, light, cam = mega._pack_tables(ts)
    attr_j = np.asarray(attr_j).T  # (T, 31)
    a = attr.numpy()
    assert a.shape == (attr_j.shape[0], 32) and (a[:, 31] == 0).all()
    exact = list(range(0, 27))  # normals, emission, flags, kind, params
    np.testing.assert_array_equal(a[:, exact], attr_j[:, exact])
    # geometric normal and area: the same formula, XLA fuses the cross product
    np.testing.assert_allclose(a[:, 27:31], attr_j[:, 27:31], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(light.numpy(), np.asarray(light_j).T[:, :12])
    np.testing.assert_array_equal(cam.numpy(), np.asarray(cam_j)[0, :13])
    np.testing.assert_array_equal(woop_t.numpy(), np.asarray(js.tri_woop_t))


def test_woop_rows_are_the_kernel_table(scenes):
    """K1 / K5's (num_tris, 12) Woop rows (staged as three float4 a triangle
    by csrc/brute.cuh) are the columns of the (12, n) table they replace,
    and of the table JAX _pack_tables hands its megakernel, bit for bit."""
    js, ts = scenes
    rows = mega.woop_rows(ts)
    n = ts.num_tris
    assert rows.shape == (n, 12) and rows.dtype == torch.float32 and rows.is_contiguous()
    assert rows.data_ptr() % 16 == 0
    assert torch.equal(rows, ts.tri_woop_t[:, :n].t())
    woop_j = np.asarray(jmega._pack_tables(js)[0])
    np.testing.assert_array_equal(rows.numpy(), woop_j[:, :n].T)


def test_woop_rows_must_be_aligned(scenes):
    """The rows are read with 128-bit loads: a table at an odd offset or of
    another type is refused before any launch."""
    ts = scenes[1]
    t = ts.tri_woop.shape[0]
    buf = torch.zeros(t * 12 + 1, dtype=torch.float32)
    buf[1:] = ts.tri_woop.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        mega.woop_rows(ts.replace(tri_woop=buf[1:].view(t, 12)))
    with pytest.raises(ValueError, match="float32"):
        mega.woop_rows(ts.replace(tri_woop=ts.tri_woop.double()))


def test_k5_rows_validate(scenes):
    """render_mega_fwdgrad_rows refuses what render_mega_rows refuses: pixel
    rows not (rows, LANES) int32, rows on another device than the scene, a
    configuration K5 does not cover."""
    from gpuspectral_tpu_torch.integrator import mega_grad as mg

    ts = scenes[1]
    cfg = RenderConfig(**_cfg(spp=1, max_depth=1))
    for pix in (torch.zeros((2, 64), dtype=torch.int32), torch.zeros((2, 128), dtype=torch.int64),
                torch.zeros((256,), dtype=torch.int32)):
        with pytest.raises(ValueError, match="pix"):
            mg.render_mega_fwdgrad_rows(ts, cfg, pix)
    with pytest.raises(ValueError, match="eligible"):
        mg.render_mega_fwdgrad_rows(ts, cfg.replace(max_depth=20),
                                    torch.zeros((2, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="eligible"):
        mega.render_mega_rows(ts, cfg.replace(use_bvh=True), torch.zeros((2, 128), dtype=torch.int32))
    meta = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    for fn in (mega.render_mega_rows, mg.render_mega_fwdgrad_rows):
        with pytest.raises(ValueError, match="on meta"):
            fn(ts, cfg, meta)
