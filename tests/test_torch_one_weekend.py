"""PyTorch port: the final scene of "Ray Tracing in One Weekend"
(scene/zoo.py:populate_one_weekend, the builtin "one_weekend").

On the CPU: the port's generator and the benchmark reference's frozen copy
(spectral_bench/reference/scene_one_weekend.py) give the same triangles,
normals, BSDF rows, sky and camera; the full-size scene has the book's
sphere count and the expected triangles and BSDF rows, and the fused-BVH
megakernel K4 covers it; on a small copy of the scene, the plain version of
K4 (render_mega_bvh_rows_ref) matches the reference tracer pixel for pixel
under the benchmark's per-pixel rule, sky-only NEE included.  On the card
(marked `cuda`): render_image_stats_auto sends the scene to K4 alone, and
K4 matches its plain version.

This file imports neither JAX nor the JAX package.
"""

import sys

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch.bsdf import table as bt
from gpuspectral_tpu_torch.integrator import mega, mega_bvh, render_image_stats_auto
from gpuspectral_tpu_torch.scene import SceneBuilder
from gpuspectral_tpu_torch.scene.data import build_scene
from gpuspectral_tpu_torch.scene.zoo import BUILTIN, populate_one_weekend
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import REPO, cuda_device, launches  # noqa: F401

sys.path.insert(0, str(REPO))
from spectral_bench.harness import compare  # noqa: E402
from spectral_bench.reference import scene_one_weekend, scenes, tracer  # noqa: E402

SMALL = dict(grid=2, segs=8, rings=4)
FULL_SPHERES = 486  # 483 small spheres kept of 22 x 22, and the three large ones
FULL_TRIS = FULL_SPHERES * 960 + 2


def _cat(b, key):
    return np.concatenate(getattr(b, key))


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "full"])
def test_reference_copy_matches_the_port(kw):
    b_p = populate_one_weekend(SceneBuilder(), **kw)
    b_r = scene_one_weekend.one_weekend(**kw)
    for key in ("tri_pos", "tri_nrm", "tri_uv", "tri_bsdf", "tri_emission", "tri_twofaced",
                "tri_light_idx"):
        assert np.array_equal(_cat(b_p, key), _cat(b_r, key)), key
    for got, want in zip(b_p.bsdfs.pack(), b_r.bsdfs.pack()):
        assert np.array_equal(got, want)
    assert np.array_equal(b_p.envmap_image, b_r.envmap_image)
    assert np.array_equal(b_p.cam_to_world, b_r.cam_to_world) and b_p.cam_fov == b_r.cam_fov
    assert not b_p.light_pos and not b_r.light_pos


def test_the_books_scene():
    """The full size: the ground, 483 small spheres and the three large
    ones, one BSDF row each; the sky gradient from white at the nadir's
    side to (0.5, 0.7, 1.0) at the zenith's; the camera at (13, 2, 3) on
    the origin with 20 degrees of vertical field on a 3:2 film."""
    b = BUILTIN["one_weekend"](SceneBuilder())
    sizes = [p.shape[0] for p in b.tri_pos]
    assert sizes == [2] + [960] * FULL_SPHERES and sum(sizes) == FULL_TRIS
    kinds, _ = b.bsdfs.pack()
    assert len(kinds) == FULL_SPHERES + 1
    assert set(int(k) for k in kinds) == {bt.BSDF_DIFFUSE, bt.BSDF_SMOOTH_DIELECTRIC,
                                          bt.BSDF_ROUGH_CONDUCTOR}
    sky = b.envmap_image
    assert sky.shape == (32, 64, 3) and np.all(sky[:, :1] == sky)
    assert np.all(np.diff(sky[:, 0, 0]) > 0) and np.allclose(sky[0, 0], [0.5, 0.7, 1.0], atol=2e-3)
    assert np.allclose(b.cam_to_world[:3, 3], [13, 2, 3])
    assert np.allclose(b.cam_to_world[:3, 2], -np.array([13, 2, 3]) / np.sqrt(182), atol=1e-6)
    assert np.tan(b.cam_fov / 2) == pytest.approx(1.5 * np.tan(np.deg2rad(10)))
    ground = b.tri_pos[0]
    assert np.all(ground[..., 1] == 0) and np.abs(ground).max() == 1000 and b.tri_twofaced[0].all()
    up = np.cross(ground[:, 1] - ground[:, 0], ground[:, 2] - ground[:, 0])
    assert np.all(up[:, [0, 2]] == 0) and np.all(up[:, 1] > 0)


@pytest.fixture(scope="module")
def full_scene():
    return build_scene(populate_one_weekend(SceneBuilder()), "cpu")


def test_k4_covers_the_full_scene(full_scene):
    """At its full size the scene is K4's with use_bvh (and never K1's):
    466,562 triangles, the sky its only light (one zero pad light row), 487
    BSDF rows."""
    sc = full_scene
    cfg = RenderConfig(width=1200, height=800, spp=10, max_depth=50, use_bvh=True)
    assert mega_bvh.mega_bvh_eligible(sc, cfg) and not mega.mega_eligible(sc, cfg)
    assert sc.num_tris == FULL_TRIS and sc.bsdf_kind.shape[0] == FULL_SPHERES + 1
    assert sc.has_envmap and not sc.has_area_lights and sc.num_lights == 1
    assert float(sc.light_emission.abs().sum()) == 0.0 and mega.env_fused_ok(sc)


def _pixels(w, h, n, seed):
    return torch.as_tensor(np.sort(np.random.default_rng(seed).choice(w * h, n, replace=False)),
                           dtype=torch.int32)


def test_plain_k4_matches_the_reference():
    """128 pixels of a 60 x 40 frame at 8 spp, depth 6, on the small scene:
    the plain K4 against the reference tracer, every pixel within the
    benchmark's per-pixel rule (compare.PIXEL_TOL) and the same rays."""
    w, h, spp, depth, ts = 60, 40, 8, 6, 2024
    sc = build_scene(populate_one_weekend(SceneBuilder(), **SMALL), "cpu")
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth, use_bvh=True)
    pix = _pixels(w, h, mega.LANES, 5)
    rr, rg, rb, rays_p = mega_bvh.render_mega_bvh_rows_ref(sc, cfg, pix[None], ts)
    port = torch.stack([rr, rg, rb], -1).reshape(-1, 3) / spp
    rs = scenes.build(scene_one_weekend.one_weekend(**SMALL), "cpu")
    rad, rays = tracer.render_pixels(
        rs, tracer.RefConfig(width=w, height=h, spp=spp, max_depth=depth, tex_mode="corners"),
        pix.long(), ts)
    n = compare.image_numbers(port[None], (rad / spp)[None], [float(rays_p.double().mean())],
                              [float(rays.double().mean())])
    assert n["pixels_off"] == 0.0 and n["mean_gap"] <= 1e-6, n
    assert torch.equal(rays_p.reshape(-1).long(), rays)
    assert float(port.mean()) > 0.1  # the sky lights the frame


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_k4_takes_the_scene_on_the_card(cuda_device):  # noqa: F811
    """The small scene at 128 x 64, 4 spp, depth 8 through
    render_image_stats_auto with use_bvh: one K4 launch, no K1 launch, and
    K4's rows equal to its plain version's within the per-pixel rule."""
    from gpuspectral_tpu_torch.utils import profiling

    w, h, spp, depth, ts = 128, 64, 4, 8, 7
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth, use_bvh=True)
    sc = build_scene(populate_one_weekend(SceneBuilder(), **SMALL), cuda_device)
    render_image_stats_auto(sc, cfg, ts)  # the kernel library
    profiling.reset()
    img, rays = render_image_stats_auto(sc, cfg, ts)
    assert launches(mega_bvh.render_mega_bvh_rows) == 1
    assert launches(mega.render_mega_rows) == 0
    assert sum(v["calls"] for k, v in profiling.snapshot().items()
               if k.endswith(".launch") and not k.startswith("gst.")) == 1
    sc_cpu = build_scene(populate_one_weekend(SceneBuilder(), **SMALL), "cpu")
    pix = _pixels(w, h, mega.LANES, 11)
    rr, rg, rb, rays_p = mega_bvh.render_mega_bvh_rows_ref(sc_cpu, cfg, pix[None], ts)
    ref = torch.stack([rr, rg, rb], -1).reshape(-1, 3) / spp
    got = img.reshape(-1, 3)[pix.long().to(img.device)].cpu()
    n = compare.image_numbers(got[None].float(), ref[None], [rays / (w * h)],
                              [float(rays_p.double().mean())])
    assert n["pixels_off"] <= 0.02 and n["mean_gap"] <= 1e-3, n
