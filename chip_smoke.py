"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from gpuspectral_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's main
path at full size: the Cornell box at 512x512, 64 spp, depth 50 through
utils.bench.run_benchmark -> integrator.render_image_stats_auto -> the
megakernel (K1), then the wavefront dispatch of render_image_stats_auto
(a config the megakernel does not cover) on the brute-force kernels (K2).

Phases:
  k2    closest_cuda / any_cuda vs closest_ref / any_ref: random rays against
        the Cornell, zoo and a 2048-triangle random-soup table;
        prim equal except exact-t ties, t within 1e-5 relative, occ equal
  k1    Cornell and zoo at 64x64: render_image_stats_auto (K1) vs the torch
        wavefront path_tracer.render_image_stats (on K2), gates of
        tests/test_mega.py: emission-only equal on >= 99.9% of pixels;
        full (depth 4, NEE, 2 spp) <= 2% of pixels off by > 1e-3, mean
        within 2e-3, ray counts within 1%
  main  the headline run_benchmark, with K1's launch count from that run
        alone; K1 vs its plain version on 16 pixel rows of the headline
        frame at its config and timestamp (<= 2% of pixels off by > 1e-3,
        <= 1% off by > 1e-4, mean within 1e-4, rays within 1%; the headline
        image equals K1 on those rows exactly); the wavefront dispatch at
        512x512, 1 spp, power light pick, with K2's launch counts from that
        run alone; K2 vs closest_ref / any_ref on 1M rays

Every failed check raises.  Output: the card's name and power limit, one
line of JSON with the per-kernel results, and as the last line
{"ok": true, "device": {...}}.  Exits nonzero with no result when there is
no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "scenes", "cornell", "scene.xml")
HEADLINE = dict(size=512, spp=64, depth=50)
# K1 vs its plain version on SUB_ROWS pixel rows (of 128 lanes) of the headline
# frame.  On those rows, dropping Russian roulette's 1/q in the plain version
# puts 8.8% of pixels off by > 1e-4 (1.6% by > 1e-3, the mean off by 2.5e-5),
# so the tests/test_mega.py gates alone would pass it; SUB_FINE_GATE fails it.
SUB_ROWS = 16
SUB_MEAN_GATE = 1e-4
SUB_FINE_GATE = 0.01  # share of pixels off by > 1e-4
K2_RAYS = dict(parity=65536, timing=1 << 20)
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warmup)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_rays(n, lo, hi, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 0.5, size=n)).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.5, 1e30, rng.uniform(0.5, 8.0, size=n)).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (o, d.astype(np.float32), t_min, t_max)]


def soup_woop_t(n_tris, seed, dev):
    from gpuspectral_tpu_torch.ops.woop import woop_transform

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, size=(n_tris, 1, 3))
    tris = (centers + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32)
    return torch.as_tensor(woop_transform(tris).T.copy(), device=dev)


def check_k2(name, woop_t, rays):
    from gpuspectral_tpu_torch.ops import cuda_isect as ci

    t, prim = ci.closest_cuda(*rays[:2], woop_t, *rays[2:])
    t_ref, prim_ref = ci.closest_ref(*rays[:2], woop_t, *rays[2:])
    occ = ci.any_cuda(*rays[:2], woop_t, *rays[2:])
    occ_ref = ci.any_ref(*rays[:2], woop_t, *rays[2:])
    torch.cuda.synchronize()
    diff = prim != prim_ref
    tie = diff & (t == t_ref)
    n_bad_prim = int((diff & ~tie).sum())
    hit = prim_ref >= 0
    rel = ((t - t_ref).abs() / t_ref.abs().clamp(min=1e-30))[hit]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    max_abs = float((t - t_ref).abs()[hit].max()) if hit.any() else 0.0
    n_occ = int((occ != occ_ref).sum())
    log(f"  K2 {name}: rays={rays[0].shape[0]} tris={woop_t.shape[1]} hits={int(hit.sum())} "
        f"occluded={int(occ_ref.sum())} prim_mismatch={n_bad_prim} exact_t_ties={int(tie.sum())} "
        f"t_max_rel={max_rel:.3g} occ_mismatch={n_occ}")
    if n_bad_prim or max_rel > 1e-5 or n_occ or bool((t[~hit] != 1e30).any()):
        raise AssertionError(f"K2 disagrees with its plain version on {name}")
    return max_abs, float((occ.int() - occ_ref.int()).abs().max())


def phase_k2(dev, scenes):
    log("phase K2: closest_cuda / any_cuda vs closest_ref / any_ref")
    errs = []
    for i, (name, scene) in enumerate(scenes.items()):
        rays = random_rays(K2_RAYS["parity"], -1.2, 2.2, 10 + i, dev)
        errs.append(check_k2(name, scene.tri_woop_t, rays))
    rays = random_rays(K2_RAYS["parity"], -2.5, 2.5, 3, dev)
    errs.append(check_k2("soup2048", soup_woop_t(2048, 7, dev), rays))
    return [max(e) for e in zip(*errs)]


def compare_images(tag, got, ref, rays_got, rays_ref, emission_only, mean_gate=2e-3,
                   fine_gate=1.0):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise AssertionError(f"{tag}: non-finite pixels")
    d = np.abs(got - ref).max(-1)
    rays_rel = abs(rays_got - rays_ref) / max(rays_ref, 1.0)
    if emission_only:
        frac = float(np.mean(d > 0))
        log(f"  {tag} emission-only: exact={frac == 0.0} pixels_differing={frac:.5f} "
            f"rays {rays_got:.0f} vs {rays_ref:.0f}")
        ok = frac <= 0.001 and rays_rel < 0.01
    else:
        frac = float(np.mean(d > 1e-3))
        fine = float(np.mean(d > 1e-4))
        dmean = abs(float(got.mean()) - float(ref.mean()))
        log(f"  {tag} full: pixels_off_1e-3={frac:.5f} pixels_off_1e-4={fine:.5f} "
            f"mean {got.mean():.6f} vs {ref.mean():.6f} (|d|={dmean:.2e}) "
            f"rays {rays_got:.0f} vs {rays_ref:.0f} (rel {rays_rel:.2e})")
        ok = frac <= 0.02 and fine <= fine_gate and dmean < mean_gate and rays_rel < 0.01
    if not ok:
        raise AssertionError(f"{tag}: K1 vs wavefront outside the gates")
    return float(d.max())


def reset_counts():
    from gpuspectral_tpu_torch.integrator import mega
    from gpuspectral_tpu_torch.ops import cuda_isect

    mega.render_mega_rows.launches = 0
    cuda_isect.closest_cuda.launches = 0
    cuda_isect.any_cuda.launches = 0


def counts():
    from gpuspectral_tpu_torch.integrator import mega
    from gpuspectral_tpu_torch.ops import cuda_isect

    return dict(k1=mega.render_mega_rows.launches, k2a=cuda_isect.closest_cuda.launches,
                k2b=cuda_isect.any_cuda.launches)


def phase_k1(scenes):
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase K1: megakernel vs the torch wavefront on the card")
    for name, scene in scenes.items():
        for kw, emission_only in ((dict(max_depth=0, nee=False, spp=1), True),
                                  (dict(max_depth=4, nee=True, spp=2), False)):
            cfg = RenderConfig(width=64, height=64, ray_batch=4096, **kw)
            reset_counts()
            got, rays_got = render_image_stats_auto(scene, cfg, 0)
            c1 = counts()
            ref, rays_ref = render_image_stats(scene, cfg, 0)
            c2 = counts()
            torch.cuda.synchronize()
            if c1["k1"] < 1 or c2["k2a"] <= c1["k2a"] or (kw["nee"] and c2["k2b"] <= c1["k2b"]):
                raise AssertionError(f"{name}: launch counters did not advance: {c1} {c2}")
            compare_images(f"{name}", got, ref, rays_got, rays_ref, emission_only)


def phase_main(dev):
    from gpuspectral_tpu_torch.integrator import mega, render_image_stats_auto
    from gpuspectral_tpu_torch.ops import cuda_isect as ci
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig
    from gpuspectral_tpu_torch.utils.bench import run_benchmark

    hs, spp, depth = HEADLINE["size"], HEADLINE["spp"], HEADLINE["depth"]
    log(f"phase main: Cornell {hs}x{hs}, {spp} spp, depth {depth} through run_benchmark (K1)")
    args = argparse.Namespace(
        scene=CORNELL, size=f"{hs}x{hs}", spp=spp, depth=depth, no_nee=False, jitter=False,
        ray_batch=65536, bvh=None, bvh_kernel="ftb", light_block=None, packet_size=1024,
        intersector="auto", light_sampling="uniform", mis="reference", device=str(dev),
        warmup=1, iters=3,
    )
    reset_counts()
    result, img = run_benchmark(args, return_image=True)
    head_launches = counts()
    log("  headline: " + json.dumps(result))
    log(f"  launches in the headline run_benchmark: {head_launches}")
    frames = max(1, args.warmup) + args.iters
    if head_launches != dict(k1=frames, k2a=0, k2b=0):
        raise AssertionError(f"headline run: want K1 launched {frames} times and K2 never")
    a = img.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all() or a.mean() <= 0.0:
        raise AssertionError(f"headline image bad: shape {a.shape}, mean {a.mean()}")

    # K1 vs its plain version (the torch wavefront) on SUB_ROWS pixel rows of
    # the headline frame, at its config and timestamp: Russian roulette,
    # late-sample regeneration and the full width all run here.  The same
    # rows of the headline image must equal K1's output exactly.
    scene, _ = load_mitsuba_scene(CORNELL, device=dev)
    cfg = RenderConfig(width=hs, height=hs, spp=spp, max_depth=depth)
    ts = 100 + args.iters - 1
    n_rows = hs * hs // mega.LANES
    sub = torch.linspace(0, n_rows - 1, min(SUB_ROWS, n_rows), device=dev).round().to(torch.int32)
    pix = (sub[:, None] * mega.LANES
           + torch.arange(mega.LANES, dtype=torch.int32, device=dev)).contiguous()
    out_k1 = mega.render_mega_rows(scene, cfg, pix, ts)
    k1_ms = cuda_ms(lambda: mega.render_mega_rows(scene, cfg, pix, ts))
    t0 = time.perf_counter()
    out_ref = mega.render_mega_rows_ref(scene, cfg, pix, ts)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    got = torch.stack(out_k1[:3], -1).reshape(-1, 3) / spp
    ref = torch.stack(out_ref[:3], -1).reshape(-1, 3) / spp
    if not torch.equal(img.reshape(-1, 3)[pix.reshape(-1).long()], got):
        raise AssertionError("headline image rows differ from K1 on the same rows")
    rays_k1 = float(out_k1[3].double().sum())
    rays_ref = float(out_ref[3].double().sum())
    k1_err = compare_images(f"K1 vs plain, {pix.shape[0]} rows of the headline frame (ts {ts})",
                            got, ref, rays_k1, rays_ref, emission_only=False,
                            mean_gate=SUB_MEAN_GATE, fine_gate=SUB_FINE_GATE)
    log(f"  K1 {k1_ms:.3f} ms vs plain {ref_ms:.3f} ms on those rows "
        f"({rays_k1 / k1_ms / 1e3:.2f} vs {rays_ref / ref_ms / 1e3:.2f} Mrays/s)")
    # K1 alone over the whole headline frame: its share of the frame's wall time
    k1_head_ms = cuda_ms(lambda: mega.render_mega(scene, cfg, ts))
    frame_ms = result["seconds_per_frame"] * 1e3
    log(f"  K1 over the headline frame: {k1_head_ms:.3f} ms of a {frame_ms:.3f} ms frame "
        f"(share {k1_head_ms / frame_ms:.3f})")

    # the wavefront dispatch of render_image_stats_auto on K2: power light
    # sampling, which K1 does not cover, at the headline size and 1 spp
    cfg_w = cfg.replace(spp=1, ray_batch=65536, light_sampling="power")
    reset_counts()
    t0 = time.perf_counter()
    img_w, rays_w = render_image_stats_auto(scene, cfg_w, 0)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    wave_launches = counts()
    log(f"  wavefront dispatch {hs}x{hs}@1spp d{depth}, power light pick: {wave_s:.3f} s, "
        f"rays {rays_w:.0f}, {rays_w / wave_s / 1e6:.3f} Mrays/s; launches {wave_launches}")
    if wave_launches["k1"] != 0 or wave_launches["k2a"] < 1 or wave_launches["k2b"] < 1:
        raise AssertionError("wavefront dispatch: want K2 launched and K1 not")
    a = img_w.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all():
        raise AssertionError(f"wavefront image bad: shape {a.shape}")
    # two estimators of one image: K1 at 64 spp, the power-sampled wavefront at 1
    m_k1, m_w = float(img.mean()), float(a.mean())
    log(f"  image means: K1@{spp}spp {m_k1:.5f}, wavefront@1spp {m_w:.5f}")
    if abs(m_k1 - m_w) > 0.05 * m_k1:
        raise AssertionError("K1 and wavefront images disagree in mean by > 5%")

    # K2 vs closest_ref / any_ref on 1M rays against the Cornell table
    rays = random_rays(K2_RAYS["timing"], -1.2, 2.2, 99, dev)
    woop_t = scene.tri_woop_t
    k2_err = check_k2(f"cornell {rays[0].shape[0]} rays", woop_t, rays)
    k2a_ms = cuda_ms(lambda: ci.closest_cuda(*rays[:2], woop_t, *rays[2:]), reps=10)
    k2a_ref = cuda_ms(lambda: ci.closest_ref(*rays[:2], woop_t, *rays[2:]))
    k2b_ms = cuda_ms(lambda: ci.any_cuda(*rays[:2], woop_t, *rays[2:]), reps=10)
    k2b_ref = cuda_ms(lambda: ci.any_ref(*rays[:2], woop_t, *rays[2:]))
    log(f"  K2 closest {k2a_ms:.3f} ms vs closest_ref {k2a_ref:.3f} ms; "
        f"any {k2b_ms:.3f} ms vs any_ref {k2b_ref:.3f} ms "
        f"({rays[0].shape[0]} rays, {scene.num_tris} tris)")
    head = f"headline run_benchmark ({hs}x{hs}, {spp} spp, d{depth})"
    wave = f"wavefront dispatch ({hs}x{hs}, 1 spp, d{depth}, power light pick)"
    return dict(
        k1=dict(launches=head_launches["k1"], launched_by=head, max_abs_err=k1_err,
                ms=k1_ms, plain_ms=ref_ms, headline_frame_ms=k1_head_ms),
        k2a=dict(launches=wave_launches["k2a"], launched_by=wave, max_abs_err=k2_err[0],
                 ms=k2a_ms, plain_ms=k2a_ref),
        k2b=dict(launches=wave_launches["k2b"], launched_by=wave, max_abs_err=k2_err[1],
                 ms=k2b_ms, plain_ms=k2b_ref),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gpuspectral_tpu_torch import _build
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import build_zoo

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (built now: {info['built_now']}) "
        f"-> {info['path']}")
    for kern, line in info["ptxas"].items():
        log(f"  ptxas {kern}: {line}")

    scenes = {"cornell": load_mitsuba_scene(CORNELL, device=dev)[0], "zoo": build_zoo(dev)}
    k2_err = phase_k2(dev, scenes)
    phase_k1(scenes)
    m = phase_main(dev)
    m["k2a"]["max_abs_err"] = max(m["k2a"]["max_abs_err"], k2_err[0])
    m["k2b"]["max_abs_err"] = max(m["k2b"]["max_abs_err"], k2_err[1])
    specs = [
        ("K1 megakernel render_mega_rows", "gpuspectral_tpu_torch/csrc/mega.cu",
         "gpuspectral_tpu/integrator/mega.py:1452", "k1"),
        ("K2a closest_cuda", "gpuspectral_tpu_torch/csrc/isect.cu",
         "gpuspectral_tpu/ops/pallas_isect.py:138", "k2a"),
        ("K2b any_cuda", "gpuspectral_tpu_torch/csrc/isect.cu",
         "gpuspectral_tpu/ops/pallas_isect.py:171", "k2b"),
    ]
    kernels = []
    for kname, src, rep, key in specs:
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=rep, **m[key]))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
