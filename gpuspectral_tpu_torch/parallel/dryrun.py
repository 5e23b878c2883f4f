"""Multi-device dry run: the port's twin of the JAX package's
`__graft_entry__.dryrun_multichip` (__graft_entry__.py:36-80).

    python -m gpuspectral_tpu_torch.parallel.dryrun N [--size S] [--device cuda|cpu]

builds an N-rank (tiles x spp) mesh and runs one of each distributed step
on Cornell: the sharded wavefront render, the sharded megakernel render
(K4 per rank), the sharded wavefront gradient step and the sharded fused
gradient step (K6 per rank).  Ranks are processes: NCCL ranks, one a card
(cuda:0 .. cuda:N-1), or gloo ranks on the CPU (device "cpu", the
GPUSPECTRAL_FAKE_HOSTS simulation of parallel/launch.py).  `size` (the
film's side, 256 by default) exists so that a CPU test can run it small.

Also the checks that other harnesses share: `spawn_ranks` (a gang of rank
processes with a deadline), `value_and_grad`, and `check_render` /
`check_grad`, which hold the sharded megakernel paths to the unsharded
ones at one set of tolerances.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE = os.path.join(REPO, "scenes", "cornell", "scene.xml")


def _run_rank(n_devices: int, size: int) -> str:
    """One rank's share of the dry run, inside an initialized group."""
    from ..scene import load_mitsuba_scene
    from ..utils.config import RenderConfig
    from . import launch
    from .dist import (grad_step_sharded, grad_step_sharded_fast, make_mesh,
                       render_image_sharded, render_image_sharded_fast)

    spp_shards = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, spp_shards=spp_shards)
    tiles = mesh.shape[0]
    scene, _ = load_mitsuba_scene(SCENE, device=launch.local_device())
    # inverse-render step shapes: depth 8, 2 spp a shard, tile-sharded pixels
    cfg = RenderConfig(width=size, height=size, spp=2 * spp_shards, max_depth=8,
                       ray_batch=(size * size) // tiles)

    def check(name, x, shape):
        if tuple(x.shape) != tuple(shape) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"dryrun_multichip: {name} bad: {tuple(x.shape)}")

    img = render_image_sharded(scene, cfg, mesh, timestamp0=0)
    check("image", img, (size, size, 3))
    # the megakernel sharded path: the same mesh runs K4 per rank
    cfg_f = cfg.replace(use_bvh=True, light_sampling="power", mis_mode="exact")
    img_f, nrays_f = render_image_sharded_fast(scene, cfg_f, mesh, timestamp0=0)
    check("megakernel image", img_f, (size, size, 3))
    if not nrays_f > 0:
        raise AssertionError(f"dryrun_multichip: {nrays_f} rays traced")
    loss, grads = grad_step_sharded(scene, cfg, mesh, img, timestamp0=1)
    check("gradient", grads, scene.bsdf_params.shape)
    # the fused sharded gradient step: K6 per rank, one all-reduce
    g = min(64, size)
    cfg_g = cfg_f.replace(width=g, height=g, max_depth=3, ray_batch=(g * g) // tiles)
    img_g, _ = render_image_sharded_fast(scene, cfg_g, mesh, timestamp0=0)
    loss_f, grads_f = grad_step_sharded_fast(scene, cfg_g, mesh, img_g, timestamp0=1)
    check("fused gradient", grads_f, scene.bsdf_params.shape)
    return (f"dryrun_multichip ok: mesh=(tiles {tiles}, spp {spp_shards}) img={tuple(img.shape)} "
            f"loss={float(loss):.6f} grad_norm={float(torch.linalg.norm(grads)):.6f} "
            f"fused_grad_loss={float(loss_f):.6f} "
            f"fused_grad_norm={float(torch.linalg.norm(grads_f)):.6f}")


def value_and_grad(diff, scene, cfg, target):
    """(loss, d_bsdf_params, d_tri_emission, d_light_emission) of the MSE
    of diff(scene, cfg, 0) (integrator.mega_grad.render_mega_diff or
    render_mega_bvh_diff) against target: the unsharded counterpart of
    grad_step_sharded_fast."""
    p = [x.clone().requires_grad_(True)
         for x in (scene.bsdf_params, scene.tri_emission, scene.light_emission)]
    img = diff(scene.replace(bsdf_params=p[0], tri_emission=p[1], light_emission=p[2]), cfg, 0)
    loss = torch.mean((img - torch.as_tensor(target, device=img.device)) ** 2)
    loss.backward()
    return loss.detach(), *(x.grad for x in p)


def check_render(tag: str, got, ref, split: bool) -> float:
    """render_image_sharded_fast's (image, rays) against the unsharded
    render's: rays equal; images equal when each lane's samples are summed
    in one launch, and within rtol 1e-5 + atol 1e-5 when they are split
    over spp shards (the per-lane sums re-associated in float32).  Returns
    the largest difference; raises AssertionError otherwise."""
    (img_s, rays_s), (img_u, rays_u) = got, ref
    err = float((img_s - img_u).abs().max())
    close = (torch.allclose(img_s, img_u, rtol=1e-5, atol=1e-5) if split
             else torch.equal(img_s, img_u))
    if not close or rays_s != rays_u:
        raise AssertionError(f"{tag}: image differs by {err}, rays {rays_s} vs {rays_u}")
    return err


def check_grad(tag: str, got, ref) -> float:
    """grad_step_sharded_fast's (loss, gradients...) against value_and_grad's:
    loss within rtol 1e-5, gradients finite and within rtol 1e-4, atol
    1e-7.  Returns the largest gradient difference; raises AssertionError
    otherwise."""
    (loss_s, *g_s), (loss_u, *g_u) = got, ref
    if not np.isclose(float(loss_s), float(loss_u), rtol=1e-5, atol=0):
        raise AssertionError(f"{tag}: loss {float(loss_s)} vs {float(loss_u)}")
    errs = []
    for a, b in zip(g_s, g_u):
        err = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or not torch.allclose(a, b, rtol=1e-4, atol=1e-7):
            raise AssertionError(f"{tag}: gradients differ by {err}")
        errs.append(err)
    return max(errs)


def spawn_ranks(argv: list, n: int, device="cuda", timeout_s: float = 900.0) -> list:
    """Start n rank processes of argv with a rendezvous on a free localhost
    port: NCCL ranks (torchrun's variables, LOCAL_RANK i for cuda:i), or
    for device "cpu" gloo ranks (the GPUSPECTRAL_FAKE_HOSTS simulation of
    parallel/launch.py).  Each rank's output goes to a file of its own.
    Waits at most timeout_s and kills any rank still running; returns each
    rank's output, or raises RuntimeError with the first failed rank's
    tail."""
    from .launch import free_port

    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(n):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
            if torch.device(device).type == "cpu":
                env.update(GPUSPECTRAL_FAKE_HOSTS=str(n), GPUSPECTRAL_FAKE_HOST_ID=str(rank),
                           GPUSPECTRAL_COORDINATOR=f"127.0.0.1:{port}")
            else:
                env.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            log = tempfile.TemporaryFile()
            logs.append(log)
            procs.append(subprocess.Popen([str(a) for a in argv], env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.time() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of {argv[1:]} failed or ran past {timeout_s} s:\n"
                           + outs[bad[0]][-3000:])
    return outs


def dryrun_multichip(n_devices: int, size: int = 256, device="cuda",
                     timeout_s: float = 900.0) -> str:
    """Run the dry run on n_devices ranks and return its summary line.

    Inside an initialized process group of n_devices ranks, this rank runs
    its share.  Otherwise it starts n_devices rank processes of this module
    (spawn_ranks: NCCL on cuda:0 .. cuda:n-1, or gloo on the CPU for device
    "cpu"), every rank's group timing out its collectives after timeout_s
    and a rank still running after timeout_s killed."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                             f"{dist.get_world_size()} ranks")
        return _run_rank(n_devices, size)
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} cards asked, "
                           f"{torch.cuda.device_count()} present")
    outs = spawn_ranks([sys.executable, "-m", "gpuspectral_tpu_torch.parallel.dryrun",
                        n_devices, "--size", size, "--device", dev.type,
                        "--timeout", timeout_s], n_devices, dev.type, timeout_s)
    return outs[0].strip().splitlines()[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)
    if "WORLD_SIZE" not in os.environ and "GPUSPECTRAL_FAKE_HOSTS" not in os.environ:
        print(dryrun_multichip(args.n_devices, args.size, args.device, args.timeout))
        return 0
    from . import launch

    if args.device == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    launch.initialize(device=args.device, timeout_s=args.timeout)
    try:
        line = _run_rank(args.n_devices, args.size)
    finally:
        dist.destroy_process_group()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
