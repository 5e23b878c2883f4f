"""PyTorch port: the (tiles x spp) distribution of
gpuspectral_tpu_torch.parallel over gloo ranks on the CPU.

One 4-rank gang (tests/torch_mh_worker.py, the GPUSPECTRAL_FAKE_HOSTS
simulation, mesh (2, 2)) runs every sharded function once; the tests hold
its results against the JAX package's sharded functions on an in-process
4-device (2, 2) mesh (the twin of tests/test_multihost.py:27-67), against
the port's unsharded renders and gradients (the twins of
tests/test_multihost.py:70-190), and against a one-rank group in this
process (the twin of tests/test_gradients.py:79-90).  Every rank's
collectives time out after RANK_TIMEOUT_S and the gang is killed after
GANG_TIMEOUT_S, so a hang fails this file instead of the suite's clock."""

import sys

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch.integrator import mega, mega_bvh, mega_grad as mg
from gpuspectral_tpu_torch.integrator.path_tracer import render_image
from gpuspectral_tpu_torch.diff import gradcheck as tgc
from gpuspectral_tpu_torch.parallel import launch
from gpuspectral_tpu_torch.parallel import dist as pdist
from gpuspectral_tpu_torch.parallel.dryrun import spawn_ranks, value_and_grad
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.utils import RenderConfig

import torch_mh_worker as W
from test_torch_gradients import _assert_close
from torch_common import CORNELL_XML, REPO, assert_mega_gates

N_RANKS = 4
RANK_TIMEOUT_S = 120.0
GANG_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """{rank: npz} of one 4-rank gloo gang."""
    out = tmp_path_factory.mktemp("gang")
    spawn_ranks([sys.executable, REPO / "tests/torch_mh_worker.py", out, RANK_TIMEOUT_S],
                N_RANKS, "cpu", GANG_TIMEOUT_S)
    return {i: dict(np.load(out / f"rank{i}.npz")) for i in range(N_RANKS)}


@pytest.fixture(scope="module")
def scene():
    return load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]


@pytest.fixture(scope="module")
def one_rank(scene):
    """The wavefront render and gradient step on a one-rank gloo group in
    this process, and the megakernel render of a config no kernel covers."""
    import torch.distributed as dist

    launch.initialize(device="cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = pdist.make_mesh(1, spp_shards=1)
        cfg = RenderConfig(**W.WAVEFRONT)
        img = pdist.render_image_sharded(scene, cfg, mesh)
        loss, grads = pdist.grad_step_sharded(scene, cfg, mesh, np.zeros((8, 16, 3), np.float32))
        # power light pick without a BVH: neither megakernel covers it
        cfg_w = cfg.replace(light_sampling="power")
        fallback = pdist.render_image_sharded_fast(scene, cfg_w, mesh)
        wavefront = pdist.render_image_sharded(scene, cfg_w, mesh)
        gathered = launch.gather_image(img)
    finally:
        dist.destroy_process_group()
    return dict(img=img, loss=loss, grads=grads, fallback=fallback, wavefront=wavefront,
                gathered=gathered)


@pytest.fixture(scope="module")
def jax_ref(cornell_scene):
    """JAX render_image_sharded / grad_step_sharded, and the _fast pair on
    the brute-force kernels in interpret mode, on a 4-device (2, 2) mesh of
    this process's virtual CPU devices."""
    from gpuspectral_tpu.parallel.dist import (grad_step_sharded, grad_step_sharded_fast,
                                               make_mesh, render_image_sharded,
                                               render_image_sharded_fast)
    from gpuspectral_tpu.utils import RenderConfig as JaxConfig

    cfg = JaxConfig(**W.WAVEFRONT)
    mesh = make_mesh(N_RANKS, spp_shards=W.SPP_SHARDS)
    img = np.asarray(render_image_sharded(cornell_scene, cfg, mesh))
    loss, grads = grad_step_sharded(cornell_scene, cfg, mesh, np.zeros((8, 16, 3), np.float32))
    img_f, rays_f = render_image_sharded_fast(cornell_scene, JaxConfig(**W.FAST_BRUTE), mesh,
                                              interpret=True)
    step_f = grad_step_sharded_fast(cornell_scene, JaxConfig(**W.GRAD_BRUTE), mesh,
                                    W.targets()[1], interpret=True, optimize_emission=True)
    return dict(img=img, loss=float(loss), grads=np.asarray(grads),
                fast_brute=np.asarray(img_f), fast_brute_rays=float(rays_f),
                gfast_brute=[np.asarray(x) for x in step_f])


def test_gang_mesh_and_replicated_image(gang):
    for rank, res in gang.items():
        assert int(res["world"]) == N_RANKS
        assert tuple(res["mesh"]) == (N_RANKS // W.SPP_SHARDS, W.SPP_SHARDS)
        # every rank holds the whole image
        np.testing.assert_array_equal(res["img"], gang[0]["img"])


def test_gather_image_on_coordinator_only(gang, one_rank):
    assert not gang[0]["gathered_none"]
    np.testing.assert_array_equal(gang[0]["gathered"], gang[0]["img"])
    for rank in range(1, N_RANKS):
        assert gang[rank]["gathered_none"], rank
    np.testing.assert_array_equal(one_rank["gathered"], one_rank["img"].numpy())


def test_sharded_render_matches_jax(gang, jax_ref):
    assert_mega_gates(jax_ref["img"], gang[0]["img"])


def test_sharded_grad_matches_jax(gang, jax_ref):
    np.testing.assert_allclose(float(gang[0]["loss"]), jax_ref["loss"], rtol=1e-4)
    _assert_close(gang[0]["grads"], jax_ref["grads"])


def test_fast_render_matches_jax(gang, jax_ref):
    """render_image_sharded_fast on the brute-force kernel: the gang's K1
    plain versions against JAX's K1 in interpret mode on the same mesh."""
    assert_mega_gates(jax_ref["fast_brute"], gang[0]["fast_brute"], jax_ref["fast_brute_rays"],
                      gang[0]["fast_brute_rays"])


def test_fast_grad_matches_jax(gang, jax_ref, scene):
    """grad_step_sharded_fast on the brute-force kernel with the emission
    gradients: the gang's K5 plain versions against JAX's K5 in interpret
    mode on the same mesh (emission gradients on emissive triangles, as
    tests/test_torch_mega_grad.py compares them)."""
    loss, g_bp, g_te, g_le = jax_ref["gfast_brute"]
    res = gang[0]
    np.testing.assert_allclose(float(res["gfast_brute_loss"]), float(loss), rtol=1e-4)
    emissive = scene.tri_light_idx.numpy() >= 0
    _assert_close(res["gfast_brute"], g_bp)
    _assert_close(res["gfast_brute_te"][emissive], g_te[emissive])
    _assert_close(res["gfast_brute_le"], g_le)


def test_sharded_render_matches_unsharded(gang, scene):
    ref = render_image(scene, RenderConfig(**W.WAVEFRONT), 0).numpy()
    np.testing.assert_allclose(gang[0]["img"], ref, rtol=0, atol=1e-5)


def test_sharded_grad_matches_unsharded(gang, scene):
    loss, g = tgc._loss_and_grad(scene, RenderConfig(**W.WAVEFRONT), scene.bsdf_params,
                                 np.zeros((8, 16, 3), np.float32))
    np.testing.assert_allclose(float(gang[0]["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(gang[0]["grads"], g.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("tag", ["bvh", "brute", "padded"])
def test_fast_render_matches_unsharded(gang, scene, tag):
    """Each rank's K4 / K1 plain version on its rows at its local spp; the
    same sample set as the unsharded megakernel, added in another order."""
    kw = dict(bvh=W.FAST_BVH, brute=W.FAST_BRUTE, padded=W.PADDED)[tag]
    cfg = RenderConfig(**kw)
    if tag == "bvh":
        assert mega_bvh.mega_bvh_eligible(scene, cfg)
        ref, rays = mega_bvh.render_mega_bvh(scene, cfg, 0)
    else:
        assert mega.mega_eligible(scene, cfg)
        ref, rays = mega.render_mega(scene, cfg, 0)
    got = gang[0][f"fast_{tag}"]
    assert np.isfinite(got).all() and got.shape == (cfg.height, cfg.width, 3)
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-5)
    assert float(gang[0][f"fast_{tag}_rays"]) == rays


@pytest.mark.parametrize("tag", ["bvh", "brute"])
def test_fast_grad_matches_fused_single(gang, scene, tag):
    t_bvh, t_brute = W.targets()
    if tag == "bvh":
        cfg, target = RenderConfig(**W.FAST_BVH), t_bvh
        assert mg.mega_bvh_grad_eligible(scene, cfg) and not mg.mega_grad_eligible(scene, cfg)
    else:
        cfg, target = RenderConfig(**W.GRAD_BRUTE), t_brute
        assert mg.mega_grad_eligible(scene, cfg)
    loss, *grads = value_and_grad(mg.render_mega_bvh_diff if tag == "bvh" else mg.render_mega_diff,
                                  scene, cfg, target)
    loss, grads = float(loss), [g.numpy() for g in grads]
    res = gang[0]
    np.testing.assert_allclose(float(res[f"gfast_{tag}_loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(res[f"gfast_{tag}"], grads[0], rtol=1e-4, atol=1e-7)
    if tag == "brute":
        assert np.abs(grads[2]).max() > 0
        np.testing.assert_allclose(res["gfast_brute_te"], grads[1], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(res["gfast_brute_le"], grads[2], rtol=1e-4, atol=1e-7)


def test_one_rank_matches_four(gang, one_rank):
    """1 rank vs 4 ranks agree (determinism + the all-reduce accounting)."""
    np.testing.assert_allclose(one_rank["img"].numpy(), gang[0]["img"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(one_rank["loss"]), float(gang[0]["loss"]), rtol=1e-4)
    np.testing.assert_allclose(one_rank["grads"].numpy(), gang[0]["grads"], rtol=2e-3,
                               atol=1e-6)


def test_fast_dispatches_to_the_wavefront(one_rank):
    """No megakernel covers the config: the wavefront's image, 0.0 rays."""
    img, rays = one_rank["fallback"]
    assert rays == 0.0
    torch.testing.assert_close(img, one_rank["wavefront"], rtol=0, atol=0)


@pytest.mark.parametrize("bvh", [False, True], ids=["k5", "k6"])
def test_render_blocks_diff_matches_render_mega_diff(scene, bvh):
    """render_blocks_diff over two of a frame's pixel rows: the per-lane
    sums of those rows of the fused render, and the gradients of a
    cotangent on those rows equal render_mega_diff's under the same
    cotangent on the image (divided by spp)."""
    cfg = RenderConfig(**(W.FAST_BVH if bvh else W.GRAD_BRUTE)).replace(width=32, height=20)
    n_pixels = cfg.width * cfg.height
    rows = torch.tensor([1, 4])
    pix = mega.pix_rows(cfg, "cpu")[rows]
    g_rows = torch.as_tensor(
        np.random.default_rng(3).uniform(-1, 1, (2, mega.LANES, 3)).astype(np.float32))

    def grads(f):
        p = [x.clone().requires_grad_(True)
             for x in (scene.bsdf_params, scene.tri_emission, scene.light_emission)]
        return torch.autograd.grad(
            f(scene.replace(bsdf_params=p[0], tri_emission=p[1], light_emission=p[2])), p)

    g_blocks = grads(lambda sc: (mg.render_blocks_diff(sc, cfg, pix, 0, bvh) * g_rows).sum())
    g_img = torch.zeros((mega.pix_rows(cfg, "cpu").numel(), 3))
    g_img.view(-1, mega.LANES, 3)[rows] = g_rows
    diff = mg.render_mega_bvh_diff if bvh else mg.render_mega_diff
    g_image = grads(lambda sc: (diff(sc, cfg, 0) * g_img[:n_pixels].reshape(
        cfg.height, cfg.width, 3)).sum() * cfg.spp)
    rad = mg.render_blocks_diff(scene, cfg, pix, 0, bvh).detach()
    ref = (mega_bvh.render_mega_bvh(scene, cfg, 0) if bvh else mega.render_mega(scene, cfg, 0))[0]
    flat = pix.reshape(-1).long()
    np.testing.assert_allclose(rad.reshape(-1, 3).numpy() / cfg.spp,
                               ref.reshape(-1, 3)[flat].numpy(), rtol=0, atol=1e-6)
    for got, want in zip(g_blocks, g_image):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)
    assert float(torch.abs(g_blocks[0]).max()) > 0


def test_render_blocks_diff_matches_jax(cornell_scene, scene):
    """render_blocks_diff on the brute-force kernel against JAX's in
    interpret mode on the same 16 pixel rows, one (SUB, LANES) block of
    JAX's (a 32x32 frame's 8 rows, then the same rows backwards): the
    per-lane sums, and the gradients of a cotangent on them."""
    import jax
    import jax.numpy as jnp

    from gpuspectral_tpu.integrator import mega_grad as jmg
    from gpuspectral_tpu.utils import RenderConfig as JaxConfig

    cfg = RenderConfig(**W.GRAD_BRUTE)
    frame = mega.pix_rows(cfg, "cpu")
    pix = torch.cat([frame, frame.flip(0)])
    g = np.random.default_rng(5).uniform(-1, 1, (*pix.shape, 3)).astype(np.float32)

    def jax_blocks(bp, te, le):
        sc = cornell_scene.replace(bsdf_params=bp, tri_emission=te, light_emission=le)
        return jmg.render_blocks_diff(sc, JaxConfig(**W.GRAD_BRUTE),
                                      jnp.asarray(pix.numpy()).reshape(1, *pix.shape), 0,
                                      False, interpret=True)

    rad_ref, vjp = jax.vjp(jax_blocks, cornell_scene.bsdf_params, cornell_scene.tri_emission,
                           cornell_scene.light_emission)
    g_ref = [np.asarray(x) for x in vjp(jnp.asarray(g).reshape(1, *g.shape))]
    p = [x.clone().requires_grad_(True)
         for x in (scene.bsdf_params, scene.tri_emission, scene.light_emission)]
    rad = mg.render_blocks_diff(
        scene.replace(bsdf_params=p[0], tri_emission=p[1], light_emission=p[2]), cfg, pix, 0,
        False)
    got = torch.autograd.grad((rad * torch.as_tensor(g)).sum(), p)
    assert_mega_gates(np.asarray(rad_ref).reshape(-1, 3) / cfg.spp,
                      rad.detach().reshape(-1, 3).numpy() / cfg.spp)
    emissive = scene.tri_light_idx.numpy() >= 0
    _assert_close(got[0].numpy(), g_ref[0])
    _assert_close(got[1].numpy()[emissive], g_ref[1][emissive])
    _assert_close(got[2].numpy(), g_ref[2])


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, initialize() and dryrun_multichip() raise instead of
    quietly running on the CPU; the CPU is asked for by name."""
    import torch.distributed as dist

    from gpuspectral_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for name in ("GPUSPECTRAL_FAKE_HOSTS", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch.initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="1 cards asked, 0 present"):
        dryrun_multichip(1)


def test_fake_hosts_keep_the_callers_device(monkeypatch):
    """The GPUSPECTRAL_FAKE_HOSTS simulation that elastic.supervise sets
    gives the ranks, not the device: the default still wants a card and
    raises without one; device "cpu" makes a gloo group of those ranks."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GPUSPECTRAL_FAKE_HOSTS", "1")
    monkeypatch.setenv("GPUSPECTRAL_FAKE_HOST_ID", "0")
    monkeypatch.setenv("GPUSPECTRAL_COORDINATOR", f"127.0.0.1:{launch.free_port()}")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch.initialize()
    assert not dist.is_initialized()
    dev = launch.initialize(device="cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        assert dev == torch.device("cpu") and launch.local_device() == dev
        assert (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == ("gloo", 1, 0)
    finally:
        dist.destroy_process_group()
