"""Frames issued back to back, each ending with its image in host memory.

Traffic parameters ("job"): width, height, spp, max_depth; "check_pixels"
pixels and "check_frames" frames of the window are compared with the
reference.  The timed path is the port's integrator.render_image_stats_auto
(the megakernel K1 or K4, whichever covers the configuration).

Frame i of a run renders the samples of timestamp base + (i + 1) * spp, a
frame of its own, as progressive frames do; base, the sampled pixels and
the checked frames are drawn from the seed.  One warm-up frame (timestamp
base) is part of the set-up.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..harness import compare, port, profile, roofline
from ..harness.runner import Run
from ..reference import scenes, tracer


class PortFrames:
    """The system under test: the port's scene and its frame call."""

    def __init__(self, cell, root, device):
        self.cfg = port.render_config(cell.config.get("render", {}), cell.traffic["job"])
        t = time.perf_counter()
        self.scene = port.load_scene(cell.config["scene"], root, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.scene_load_s = time.perf_counter() - t

    def frame(self, ts):
        from gpuspectral_tpu_torch.integrator import render_image_stats_auto

        return render_image_stats_auto(self.scene, self.cfg, ts)

    def close(self):
        del self.scene


def ref_config(cell) -> tracer.RefConfig:
    job, render = cell.traffic["job"], cell.config.get("render", {})
    keep = {k: render[k] for k in ("light_sampling", "mis_mode", "nee", "jitter") if k in render}
    return tracer.RefConfig(width=job["width"], height=job["height"], spp=job["spp"],
                            max_depth=job["max_depth"], **keep,
                            **cell.config.get("reference", {}))


def draws(seed: int, width: int, height: int, check_pixels: int):
    """(base timestamp, sampled pixel ids, generator) of a seed.  The
    pixels are stratified: the frame cut into check_pixels square blocks,
    one pixel drawn in each, so that their mean estimates the frame's."""
    g = np.random.default_rng(seed)
    base = int(g.integers(0, 1 << 31))
    side = int(round((width * height / check_pixels) ** 0.5))
    if side < 1 or width % side or height % side:
        raise ValueError(f"{check_pixels} pixels do not tile a {width}x{height} frame")
    by, bx = np.meshgrid(np.arange(height // side), np.arange(width // side), indexing="ij")
    oy, ox = g.integers(0, side, size=(2,) + by.shape)
    pix = np.sort(((by * side + oy) * width + bx * side + ox).ravel())
    return base, pix, g


def window(program, cfg, base, pix, seconds, traced, span="bench.frame"):
    """Frames back to back for `seconds`, each copied into one pinned host
    frame buffer (a renderer writing its frames out): each frame's wall
    time, rays, and its sampled pixels."""
    spp, n_pixels = cfg.spp, cfg.width * cfg.height
    pinned = torch.cuda.is_available()
    buf = torch.empty((n_pixels, 3), dtype=torch.float32, pin_memory=pinned)
    pix = torch.as_tensor(pix)
    times, rays, samples, stamps = [], [], [], []
    prof = {}
    with profile.traced(traced, span, prof):
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = base + (i + 1) * spp
            t = time.perf_counter()
            with torch.profiler.record_function(span):
                img, nrays = program.frame(ts)
                buf.copy_(img.reshape(-1, 3))
            t1 = time.perf_counter()
            times.append(t1 - t)
            rays.append(float(nrays))
            samples.append(buf[pix])
            stamps.append(ts)
            i += 1
            if t1 - t0 >= seconds:
                break
    return dict(times=times, rays=rays, samples=samples, stamps=stamps,
                window_s=t1 - t0, n_pixels=n_pixels, trace=prof["trace"])


def reference_frames(cell, root, device, pix, stamps, tally=None, state_dtype=None):
    """The reference's mean radiance (F, P, 3) and rays per pixel (F,) of
    the sampled pixels at each timestamp."""
    rc = ref_config(cell)
    rs = scenes.scene_from_spec(cell.config["scene"], root, device)
    pixels = torch.as_tensor(pix, device=device)
    rads, rays = [], []
    for k, ts in enumerate(stamps):
        rad, r = tracer.render_pixels(rs, rc, pixels, ts, tally=tally if k == 0 else None,
                                      state_dtype=state_dtype)
        rads.append((rad / rc.spp).cpu())
        rays.append(float(r.double().mean()))
    return torch.stack(rads), rays, rs


def brute_counts(tally, rays_per_frame, n_pixels, rs) -> dict:
    """The roofline inputs of a brute-force fused kernel (K1) a frame."""
    flops = roofline.fused_flops(tally.woop_tests * roofline.WOOP_FLOPS, tally.hits,
                                 tally.closest + tally.shadow, rays_per_frame)
    n_bytes = n_pixels * roofline.LANE_BYTES + rs.num_tris * (12 + 32) * 4 + rs.num_lights * 48
    return dict(flops=flops, bytes=n_bytes)


def run(cell, seed, seconds, traced, device, t_start, program=None, root=None) -> Run:
    from ..harness.manifest import ROOT

    root = root or ROOT
    out = Run(cell=cell, seed=seed, traced=traced)
    if program is None:
        if torch.device(device).type == "cuda":
            port.build_kernels()
        program = PortFrames(cell, root, device)
    out.scene_load_s = getattr(program, "scene_load_s", None)
    cfg = program.cfg
    base, pix, g = draws(seed, cfg.width, cfg.height, cell.traffic["check_pixels"])
    img, _ = program.frame(base)  # warm-up: the cell's one shape
    img.cpu()
    out.setup_s = time.time() - t_start
    w = window(program, cfg, base, pix, seconds, traced)
    out.window_s, out.unit_s = w["window_s"], w["times"]
    out.unit_work = [float(cfg.width * cfg.height * cfg.spp)] * len(w["times"])
    out.attempted = len(w["times"])
    out.trace = w["trace"]
    if torch.device(device).type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    program.close()
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    n_check = min(cell.traffic["check_frames"], len(w["stamps"]))
    which = sorted(g.choice(len(w["stamps"]), size=n_check, replace=False).tolist())
    tally = tracer.Tally(stride=cell.traffic.get("count_stride", 0)) if traced else None
    ref, ref_rays, rs = reference_frames(cell, root, device, pix, [w["stamps"][k] for k in which],
                                         tally)
    prog = torch.stack([w["samples"][k] for k in which])
    prog_rays = [w["rays"][k] / w["n_pixels"] for k in which]
    numbers = compare.image_numbers(prog, ref, prog_rays, ref_rays)
    out.checks = compare.judge(numbers, cell.limits)
    out.extra["numbers"] = numbers
    if tally is not None:
        mean_rays = float(np.mean(w["rays"]))
        out.counts["brute"] = brute_counts(tally, mean_rays, w["n_pixels"], rs)
        if tally.rays:
            from ..reference import bvh_count

            out.counts["bvh"] = bvh_count.frame_counts(rs, tally, mean_rays, w["n_pixels"])
    return out
