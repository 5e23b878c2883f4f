"""Benchmark harness: Mrays/s of steady-state renders on the card.

Mrays/s counts the rays actually traced (closest-hit plus shadow rays, as
the integrators count them), not a W*H*spp*depth bound.  Each timed
iteration is bracketed by torch.cuda.synchronize(), so it covers the whole
frame on the device.  A benchmark measures the card: on a CPU device it
raises rather than report a CPU time under a device metric.
"""

from __future__ import annotations

import statistics
import time

import torch


def run_benchmark(args, *, return_image: bool = False):
    """Render args.scene at the args' config (warmup + timed iterations) and
    return the same keys as gpuspectral_tpu.utils.bench.run_benchmark.

    With return_image, return (result, image) instead: the (H, W, 3) image
    of the last timed frame, rendered at timestamp 100 + args.iters - 1."""
    from ..cli.main import _build
    from ..integrator import render_image_stats_auto

    scene, cfg = _build(args)
    dev = scene.device
    if dev.type != "cuda":
        raise RuntimeError(f"run_benchmark measures a CUDA device; the scene is on {dev}")
    warmup = getattr(args, "warmup", 1)
    iters = getattr(args, "iters", 3)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    render_image_stats_auto(scene, cfg, 0)
    torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0  # first frame: kernel build + launch
    for i in range(max(0, warmup - 1)):
        render_image_stats_auto(scene, cfg, i + 1)

    times = []
    for i in range(iters):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        img, nrays = render_image_stats_auto(scene, cfg, 100 + i)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    seconds = statistics.median(times)
    total_rays = float(nrays)
    n_paths = cfg.width * cfg.height * cfg.spp
    result = {
        "scene": args.scene,
        "width": cfg.width,
        "height": cfg.height,
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "compile_seconds": round(compile_s, 2),
        "seconds_per_frame": seconds,
        "rays_traced": total_rays,
        "mrays_per_s": total_rays / seconds / 1e6,
        "mpaths_per_s": n_paths / seconds / 1e6,
        "backend": "cuda",
        "device": torch.cuda.get_device_name(dev),
    }
    return (result, img) if return_image else result


def load_scene(scene_path: str, device):
    """A Mitsuba XML scene, or builtin:<name> (scene/zoo.py:BUILTIN)."""
    from ..scene import SceneBuilder, load_mitsuba_scene
    from ..scene.zoo import BUILTIN

    if scene_path.startswith("builtin:"):
        return BUILTIN[scene_path[len("builtin:"):]](SceneBuilder()).build(device)
    return load_mitsuba_scene(scene_path, device=device)[0]


def run_grad_benchmark(scene_path: str, size: int = 512, spp: int = 64, depth: int = 5,
                       ray_batch: int = 65536, steps: int = 2, use_bvh: bool = False,
                       return_grad: bool = False, bvh_kernel: str = "ftb"):
    """Gradient-step throughput (grad-steps/s; gpuspectral_tpu/utils/bench.py:
    run_grad_benchmark): one value-and-grad of the MSE against a fixed
    target (zeros) w.r.t. bsdf_params, through K5 (`render_mega_diff`) when
    mega_grad_eligible, else K6 (`render_mega_bvh_diff`) when
    mega_bvh_grad_eligible, else the differentiable wavefront
    (diff/gradcheck.render_mean: ray_batch lanes per batch, each batch
    checkpointed: grad_remat "sample"), on the BVH kernels that `bvh_kernel`
    names when use_bvh.  The first step (kernel build included) is
    compile_seconds; each of `steps` timed steps, at timestamps 1.., runs
    between torch.cuda.synchronize() calls, and seconds_per_step is their
    median.

    With return_grad, return (result, gradient of the last step, its
    timestamp)."""
    from ..diff.gradcheck import render_mean
    from ..integrator.mega_grad import (mega_bvh_grad_eligible, mega_grad_eligible,
                                        render_mega_bvh_diff, render_mega_diff)
    from .config import RenderConfig

    if not torch.cuda.is_available():
        raise RuntimeError("run_grad_benchmark measures a CUDA device; there is none")
    dev = torch.device("cuda")
    scene = load_scene(scene_path, dev)
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=depth, ray_batch=ray_batch,
                       grad_remat="sample", use_bvh=use_bvh, bvh_kernel=bvh_kernel)
    n_pixels = size * size
    target = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
    if mega_grad_eligible(scene, cfg):
        render_diff, kernel = render_mega_diff, "mega"
    elif mega_bvh_grad_eligible(scene, cfg):
        render_diff, kernel = render_mega_bvh_diff, "mega_bvh"
    else:
        render_diff, kernel = None, "wavefront"

    def grad_step(ts):
        p = scene.bsdf_params.detach().clone().requires_grad_(True)
        sc = scene.replace(bsdf_params=p)
        if render_diff is not None:
            img = render_diff(sc, cfg, ts).reshape(n_pixels, 3)
        else:
            img = render_mean(sc, cfg, ts, differentiable=True)
        loss = torch.mean((img - target) ** 2)
        return loss.detach(), torch.autograd.grad(loss, p)[0]

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, g = grad_step(0)
    torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, g = grad_step(i + 1)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    result = {
        "seconds_per_step": dt,
        "grad_steps_per_s": 1.0 / dt,
        "mpaths_per_s_fwd_bwd": n_pixels * spp / dt / 1e6,
        "compile_seconds": round(compile_s, 2),
        "size": size, "spp": spp, "max_depth": depth,
        "kernel": kernel,
        "peak_hbm_gb": round(torch.cuda.max_memory_allocated(dev) / 2**30, 3),
        "backend": "cuda",
        "device": torch.cuda.get_device_name(dev),
    }
    return (result, g, steps) if return_grad else result
