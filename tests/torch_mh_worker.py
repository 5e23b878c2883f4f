"""Worker process for tests/test_torch_dist.py: one rank of a gloo gang.

Invoked with GPUSPECTRAL_FAKE_HOSTS / GPUSPECTRAL_FAKE_HOST_ID /
GPUSPECTRAL_COORDINATOR set (parallel/launch.initialize reads them); runs
every sharded function of gpuspectral_tpu_torch.parallel once on the
(tiles, spp) mesh and writes its results to argv[1] (a directory), one npz
a rank: rank 0 holds the images, losses and gradients, every rank whether
gather_image gave it the image.  argv[2]: seconds after which every
collective fails."""

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np
import torch

torch.set_num_threads(1)  # the gang's ranks share the host's cores

import torch.distributed as dist

from gpuspectral_tpu_torch.parallel import dist as pdist
from gpuspectral_tpu_torch.parallel import launch
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.utils import RenderConfig

# the configurations of tests/test_multihost.py
WAVEFRONT = dict(width=16, height=8, spp=4, max_depth=2, ray_batch=128)
FAST_BVH = dict(width=32, height=32, spp=4, max_depth=3, ray_batch=1024, use_bvh=True,
                jitter=False, light_sampling="power", mis_mode="exact")
FAST_BRUTE = dict(width=32, height=32, spp=2, max_depth=3, ray_batch=1024, use_bvh=False,
                  jitter=False)
GRAD_BRUTE = dict(FAST_BRUTE, spp=4)
# 3 pixel rows of 128 lanes over 2 tiles: one pad row
PADDED = dict(width=24, height=16, spp=2, max_depth=3, jitter=False)
SPP_SHARDS = 2


def targets():
    return (np.random.default_rng(7).uniform(0.0, 1.0, (32, 32, 3)).astype(np.float32),
            np.random.default_rng(8).uniform(0.0, 1.0, (32, 32, 3)).astype(np.float32))


def run(mesh, scene) -> dict:
    """Every sharded function once; the results as numpy."""
    out = {}
    cfg = RenderConfig(**WAVEFRONT)
    img = pdist.render_image_sharded(scene, cfg, mesh)
    out["gathered"] = launch.gather_image(img)
    out["img"] = img.numpy()
    loss, grads = pdist.grad_step_sharded(scene, cfg, mesh, np.zeros((8, 16, 3), np.float32))
    out["loss"], out["grads"] = loss.numpy(), grads.numpy()
    for tag, kw in (("bvh", FAST_BVH), ("brute", FAST_BRUTE), ("padded", PADDED)):
        img_f, rays = pdist.render_image_sharded_fast(scene, RenderConfig(**kw), mesh)
        out[f"fast_{tag}"], out[f"fast_{tag}_rays"] = img_f.numpy(), np.float64(rays)
    t_bvh, t_brute = targets()
    loss, g = pdist.grad_step_sharded_fast(scene, RenderConfig(**FAST_BVH), mesh, t_bvh)
    out["gfast_bvh_loss"], out["gfast_bvh"] = loss.numpy(), g.numpy()
    loss, g, g_te, g_le = pdist.grad_step_sharded_fast(
        scene, RenderConfig(**GRAD_BRUTE), mesh, t_brute, optimize_emission=True)
    out["gfast_brute_loss"], out["gfast_brute"] = loss.numpy(), g.numpy()
    out["gfast_brute_te"], out["gfast_brute_le"] = g_te.numpy(), g_le.numpy()
    return out


def main() -> int:
    out_dir, timeout_s = sys.argv[1], float(sys.argv[2])
    launch.initialize(device="cpu", timeout_s=timeout_s)  # GPUSPECTRAL_FAKE_HOSTS: gloo ranks
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = launch.pod_mesh(spp_shards=SPP_SHARDS)
        scene, _ = load_mitsuba_scene(str(REPO / "scenes/cornell/scene.xml"), device="cpu")
        out = run(mesh, scene)
        gathered = out.pop("gathered")
        keep = out if rank == 0 else dict(img=out["img"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), world=world,
                 mesh=np.asarray(mesh.shape), gathered_none=gathered is None,
                 gathered=np.zeros(0) if gathered is None else gathered, **keep)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
