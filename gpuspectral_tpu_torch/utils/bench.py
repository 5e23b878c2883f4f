"""Benchmark harness: Mrays/s of steady-state renders on the card.

Mrays/s counts the rays actually traced (closest-hit plus shadow rays, as
the integrators count them), not a W*H*spp*depth bound.  Each timed
iteration is bracketed by torch.cuda.synchronize(), so it covers the whole
frame on the device.  A benchmark measures the card: on a CPU device it
raises rather than report a CPU time under a device metric.
"""

from __future__ import annotations

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
    seconds = sorted(times)[len(times) // 2]
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
