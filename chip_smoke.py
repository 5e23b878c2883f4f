"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from gpuspectral_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's two
main paths at full size through utils.bench.run_benchmark ->
integrator.render_image_stats_auto:
  * the Cornell box at 512x512, 64 spp, depth 50 -> the megakernel (K1),
    then the wavefront dispatch (a config K1 does not cover) on the
    brute-force kernels (K2);
  * the sphere field (scene/zoo.py, 147,460 triangles, a textured floor and
    a 32x64 sky) at 512x512, 64 spp, depth 50 -> the fused-BVH megakernel
    (K4), then the wavefront dispatch on the BVH kernels (K3).

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
  k3    ftb_closest / ftb_any vs ftb_closest_ref / ftb_any_ref on 65,536
        random rays over the sphere field, Cornell, the zoo, a
        2048-triangle soup and a slot-mode build: t, prim, u, v, attrs and
        occ equal, ties included; K3 timed on 1M and 65,536 rays beside K2
        on the same rays and the plain version on 65,536
  env   K1 and K4 on Cornell under a constant emitter and a 32x64 sky, at
        64x64, vs the wavefront: every pixel within 2e-5 (the gate of
        tests/test_envmap.py:246-335), rays within 1%
  k4    K4 vs the wavefront on K3 (textures by the same per-corner blend)
        at 64x64 on Cornell, the zoo and a small sphere field: emission
        only equal on >= 99.9% of pixels; full (depth 4, NEE, 2 spp) and
        power light pick with exact MIS under the tests/test_mega.py gates,
        the latter with <= 0.8% of pixels off by > 1e-4
  bvh_main       the sphere-field run_benchmark, with K4's launch count
        from that run alone (K1, K2, K3 never); K4 vs its plain version on
        8 pixel rows of the last frame at its timestamp (the gates of
        main; full spp when the plain leg takes under 60 s, else fewer
        spp at the same timestamp); those rows of the image equal K4's
  bvh_wavefront  the same scene with intersector "pallas" at 512x512,
        1 spp: K3 launched and K4 / K1 not, image mean within 5% of K4's

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
K3_RAYS = dict(parity=65536, timing=1 << 20)
SPHERE_FIELD = "builtin:sphere_field"
K4_ROWS = 8  # pixel rows of the sphere-field frame K4 is held to its plain version on
PLAIN_BUDGET_S = 60.0  # longest plain-version leg of bvh_main before spp is cut
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


def _wrappers():
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.integrator import mega, mega_bvh
    from gpuspectral_tpu_torch.ops import cuda_isect

    return dict(k1=mega.render_mega_rows, k2a=cuda_isect.closest_cuda,
                k2b=cuda_isect.any_cuda, k3a=ftb.ftb_closest, k3b=ftb.ftb_any,
                k4=mega_bvh.render_mega_bvh_rows)


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


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
    if head_launches != dict(k1=frames, k2a=0, k2b=0, k3a=0, k3b=0, k4=0):
        raise AssertionError(f"headline run: want K1 launched {frames} times and no other kernel")
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


def field_rays(n, scene, seed, dev):
    """Random rays with origins in the scene's bounding box."""
    lo = float(scene.bvh_node_min[0].min()) - 0.5
    hi = float(scene.bvh_node_max[0].max()) + 0.5
    return random_rays(n, lo, hi, seed, dev)


def check_k3(name, scene, rays):
    from gpuspectral_tpu_torch.bvh import ftb

    o, d, lo, hi = rays
    t, prim, u, v, attrs = ftb.ftb_closest(scene, o, d, t_max=hi)
    occ = ftb.ftb_any(scene, o, d, lo, hi)
    t_r, prim_r, u_r, v_r, attrs_r = ftb.ftb_closest_ref(scene, o, d, t_max=hi)
    occ_r = ftb.ftb_any_ref(scene, o, d, lo, hi)
    torch.cuda.synchronize()
    bad = {k: int((a != b).sum()) for k, a, b in (
        ("t", t, t_r), ("prim", prim, prim_r), ("u", u, u_r), ("v", v, v_r),
        ("attrs", attrs, attrs_r), ("occ", occ, occ_r))}
    hit = prim_r >= 0
    log(f"  K3 {name}: rays={o.shape[0]} slots={scene.tri_woop_t.shape[1]} "
        f"nodes={scene.bvh_dfs_bounds.shape[1]} hits={int(hit.sum())} "
        f"occluded={int(occ_r.sum())} mismatches={bad}")
    if any(bad.values()):
        raise AssertionError(f"K3 disagrees with its plain version on {name}")
    return float((t - t_r).abs()[hit].max()) if hit.any() else 0.0


def soup_scene(n_tris, seed, dev):
    from gpuspectral_tpu_torch.bsdf.table import diffuse
    from gpuspectral_tpu_torch.scene.data import SceneBuilder

    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-2.0, 2.0, size=(n_tris, 1, 3))
            + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32)
    b = SceneBuilder()
    b.add_object(tris, tris, None, np.eye(4, dtype=np.float32), b.add_bsdf(diffuse((0.5,) * 3)))
    return b.build(dev)


def phase_k3(dev, scenes, field):
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.bvh.tables import sah
    from gpuspectral_tpu_torch.ops import cuda_isect as ci
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene

    log("phase K3: ftb_closest / ftb_any vs ftb_closest_ref / ftb_any_ref")
    old = sah.SLOT_DENSE_THRESHOLD
    sah.SLOT_DENSE_THRESHOLD = 8
    try:
        slot = load_mitsuba_scene(CORNELL, device=dev)[0]
    finally:
        sah.SLOT_DENSE_THRESHOLD = old
    cases = dict(sphere_field=field, **scenes, soup2048=soup_scene(2048, 7, dev), slot_mode=slot)
    err = 0.0
    for i, (name, scene) in enumerate(cases.items()):
        err = max(err, check_k3(name, scene, field_rays(K3_RAYS["parity"], scene, 20 + i, dev)))

    # timing on the sphere field: K3 at 1M and 65,536 rays, K2 over the
    # same table and rays, the plain version at 65,536
    times = {}
    for n in (K3_RAYS["timing"], K3_RAYS["parity"]):
        o, d, lo, hi = field_rays(n, field, 99, dev)
        w = field.tri_woop_t
        times[n] = dict(
            k3a=cuda_ms(lambda: ftb.ftb_closest(field, o, d, t_max=hi), reps=5),
            k3b=cuda_ms(lambda: ftb.ftb_any(field, o, d, lo, hi), reps=5),
            k2a=cuda_ms(lambda: ci.closest_cuda(o, d, w, torch.zeros_like(lo), hi), reps=1),
            k2b=cuda_ms(lambda: ci.any_cuda(o, d, w, lo, hi), reps=1))
        if n == K3_RAYS["parity"]:
            times[n]["k3a_plain"] = cuda_ms(lambda: ftb.ftb_closest_ref(field, o, d, t_max=hi),
                                            reps=1)
            times[n]["k3b_plain"] = cuda_ms(lambda: ftb.ftb_any_ref(field, o, d, lo, hi), reps=1)
        log(f"  sphere field, {n} rays: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times[n].items()))
    return err, times


def wavefront_rows(scene, cfg, pix, ts):
    """The torch wavefront on K3 over K4's pixel rows, shading textures by
    K4's per-corner blend (no light-pick sharing or ray sorting)."""
    from gpuspectral_tpu_torch.integrator import path_tracer

    wcfg = cfg.replace(intersector="pallas", light_block=0, sort_rays=False)
    rad, rays, _ = path_tracer.trace_wavefront(scene, wcfg, pix.reshape(-1), ts,
                                               tex_mode="corners")
    return rad / cfg.spp, float(rays.double().sum())


def phase_env(dev):
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto
    from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import _sky
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase env: K1 and K4 with an environment emitter vs the wavefront")
    err = dict(k1=0.0, k4=0.0)
    for env_name, image in (("constant", np.full((1, 1, 3), 0.8, np.float32)),
                            ("sky32x64", _sky(32, 64))):
        b = load_mitsuba_scene(CORNELL, build=False)
        b.set_envmap(image)
        scene = b.build(dev)
        for key, use_bvh in (("k1", False), ("k4", True)):
            cfg = RenderConfig(width=64, height=64, spp=2, max_depth=3, ray_batch=4096,
                               use_bvh=use_bvh)
            reset_counts()
            got, rays_got = render_image_stats_auto(scene, cfg, 0)
            c = counts()
            ref, rays_ref = render_image_stats(scene, cfg, 0)
            torch.cuda.synchronize()
            if c[key] != 1:
                raise AssertionError(f"env {env_name}: {key} not launched: {c}")
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            dpx = np.abs(g - r).max(-1)
            rays_rel = abs(rays_got - rays_ref) / max(rays_ref, 1.0)
            log(f"  {key.upper()} cornell+{env_name}: pixels_off_2e-5={float(np.mean(dpx > 2e-5)):.5f} "
                f"max {dpx.max():.3g} mean {g.mean():.6f} vs {r.mean():.6f} "
                f"rays {rays_got:.0f} vs {rays_ref:.0f}")
            if not (np.isfinite(g).all() and np.allclose(g, r, atol=2e-5) and rays_rel < 0.01):
                raise AssertionError(f"env {env_name}: {key} vs wavefront outside the gates")
            err[key] = max(err[key], float(dpx.max()))
    return err


def phase_k4(dev, scenes):
    from gpuspectral_tpu_torch.integrator import mega_bvh
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field
    from gpuspectral_tpu_torch.utils import RenderConfig

    log("phase K4: fused-BVH megakernel vs the wavefront on K3")
    cases = dict(scenes, sphere_field_small=build_sphere_field(dev, n_side=2, segs=16, rings=8))
    pix = torch.arange(64 * 64, dtype=torch.int32, device=dev).reshape(-1, 128)
    err = 0.0
    for name, scene in cases.items():
        for tag, kw in (("emission-only", dict(max_depth=0, nee=False, spp=1)),
                        ("full", dict(max_depth=4, spp=2)),
                        ("power+exact", dict(max_depth=4, spp=2, light_sampling="power",
                                             mis_mode="exact"))):
            cfg = RenderConfig(width=64, height=64, use_bvh=True, **kw)
            reset_counts()
            out = mega_bvh.render_mega_bvh_rows(scene, cfg, pix, 0)
            ref, rays_ref = wavefront_rows(scene, cfg, pix, 0)
            c = counts()
            torch.cuda.synchronize()
            if c["k4"] != 1 or c["k3a"] < 1:
                raise AssertionError(f"{name} {tag}: launch counts {c}")
            got = torch.stack(out[:3], -1).reshape(-1, 3) / cfg.spp
            rays_got = float(out[3].double().sum())
            if tag == "power+exact":
                d = (got - ref).abs().amax(-1)
                frac = float((d > 1e-4).double().mean())
                log(f"  {name} power+exact: pixels_off_1e-4={frac:.5f}")
                if frac > 0.008:
                    raise AssertionError(f"{name} power+exact: K4 vs wavefront outside the gates")
            err = max(err, compare_images(f"{name} {tag}", got.reshape(64, 64, 3),
                                          ref.reshape(64, 64, 3), rays_got, rays_ref,
                                          emission_only=tag == "emission-only"))
    return err


def phase_bvh_main(dev):
    from gpuspectral_tpu_torch.cli.main import _build
    from gpuspectral_tpu_torch.integrator import mega_bvh
    from gpuspectral_tpu_torch.utils.bench import run_benchmark

    hs, spp, depth = HEADLINE["size"], HEADLINE["spp"], HEADLINE["depth"]
    log(f"phase bvh_main: sphere field {hs}x{hs}, {spp} spp, depth {depth} through "
        "run_benchmark (K4)")
    args = argparse.Namespace(
        scene=SPHERE_FIELD, size=f"{hs}x{hs}", spp=spp, depth=depth, no_nee=False, jitter=False,
        ray_batch=65536, bvh=None, bvh_kernel="ftb", light_block=None, packet_size=1024,
        intersector="auto", light_sampling="uniform", mis="reference", device=str(dev),
        warmup=1, iters=3,
    )
    reset_counts()
    result, img = run_benchmark(args, return_image=True)
    launches = counts()
    log("  headline: " + json.dumps(result))
    log(f"  launches in the sphere-field run_benchmark: {launches}")
    frames = max(1, args.warmup) + args.iters
    if launches != dict(k1=0, k2a=0, k2b=0, k3a=0, k3b=0, k4=frames):
        raise AssertionError(f"sphere-field run: want K4 launched {frames} times and no other")
    a = img.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all() or a.mean() <= 0.0:
        raise AssertionError(f"sphere-field image bad: shape {a.shape}, mean {a.mean()}")

    scene, cfg = _build(args)
    log(f"  scene: {scene.num_tris} triangles, {scene.padded_tris} slots, "
        f"{scene.bvh_dfs_bounds.shape[1]} preorder nodes, {scene.bvh_bins} bins of "
        f"{scene.bvh_bin_slots}, textured={scene.has_textures}, "
        f"envmap {tuple(scene.envmap.shape[:2])}")
    ts = 100 + args.iters - 1
    n_rows = hs * hs // mega_bvh.LANES
    sub = torch.linspace(0, n_rows - 1, K4_ROWS, device=dev).round().to(torch.int32)
    pix = (sub[:, None] * mega_bvh.LANES
           + torch.arange(mega_bvh.LANES, dtype=torch.int32, device=dev)).contiguous()
    full = mega_bvh.render_mega_bvh_rows(scene, cfg, pix, ts)
    got_full = torch.stack(full[:3], -1).reshape(-1, 3) / spp
    if not torch.equal(img.reshape(-1, 3)[pix.reshape(-1).long()], got_full):
        raise AssertionError("sphere-field image rows differ from K4 on the same rows")

    # the plain leg: time it at 4 spp, run it at full spp when that fits
    # PLAIN_BUDGET_S, else at the most spp (a power of two) that does
    t0 = time.perf_counter()
    ref4 = mega_bvh.render_mega_bvh_rows_ref(scene, cfg.replace(spp=4), pix, ts)
    torch.cuda.synchronize()
    dt4 = time.perf_counter() - t0
    spp_cmp = 4
    while spp_cmp < spp and dt4 * (2 * spp_cmp) / 4 < PLAIN_BUDGET_S:
        spp_cmp *= 2
    log(f"  plain version at 4 spp on {K4_ROWS} rows: {dt4:.2f} s; comparing at {spp_cmp} spp")
    cfg_cmp = cfg.replace(spp=spp_cmp)
    t0 = time.perf_counter()
    ref = ref4 if spp_cmp == 4 else mega_bvh.render_mega_bvh_rows_ref(scene, cfg_cmp, pix, ts)
    torch.cuda.synchronize()
    ref_ms = (dt4 if spp_cmp == 4 else time.perf_counter() - t0) * 1e3
    out = mega_bvh.render_mega_bvh_rows(scene, cfg_cmp, pix, ts)
    k4_ms = cuda_ms(lambda: mega_bvh.render_mega_bvh_rows(scene, cfg_cmp, pix, ts), reps=2)
    got = torch.stack(out[:3], -1).reshape(-1, 3) / spp_cmp
    refi = torch.stack(ref[:3], -1).reshape(-1, 3) / spp_cmp
    rays_k4, rays_ref = float(out[3].double().sum()), float(ref[3].double().sum())
    k4_err = compare_images(
        f"K4 vs plain, {K4_ROWS} rows of the sphere-field frame (ts {ts}, {spp_cmp} spp)",
        got, refi, rays_k4, rays_ref, emission_only=False, mean_gate=SUB_MEAN_GATE,
        fine_gate=SUB_FINE_GATE)
    log(f"  K4 {k4_ms:.3f} ms vs plain {ref_ms:.3f} ms on those rows at {spp_cmp} spp "
        f"({rays_k4 / k4_ms / 1e3:.3f} vs {rays_ref / ref_ms / 1e3:.3f} Mrays/s)")
    k4_head_ms = cuda_ms(lambda: mega_bvh.render_mega_bvh(scene, cfg, ts), reps=1)
    frame_ms = result["seconds_per_frame"] * 1e3
    log(f"  K4 over the sphere-field frame: {k4_head_ms:.3f} ms of a {frame_ms:.3f} ms frame "
        f"(share {k4_head_ms / frame_ms:.3f})")
    head = f"sphere-field run_benchmark ({hs}x{hs}, {spp} spp, d{depth})"
    return dict(launches=launches["k4"], launched_by=head, max_abs_err=k4_err, ms=k4_ms,
                plain_ms=ref_ms, spp_compared=spp_cmp, headline_frame_ms=k4_head_ms,
                mrays_per_s=result["mrays_per_s"]), scene, cfg, float(img.mean())


def phase_bvh_wavefront(scene, cfg, k4_mean):
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto

    hs = cfg.width
    log(f"phase bvh_wavefront: sphere field {hs}x{hs}, 1 spp, d{cfg.max_depth}, "
        "intersector pallas (wavefront on K3)")
    cfg_w = cfg.replace(spp=1, intersector="pallas")
    reset_counts()
    t0 = time.perf_counter()
    img, rays = render_image_stats_auto(scene, cfg_w, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = counts()
    log(f"  {dt:.3f} s, rays {rays:.0f}, {rays / dt / 1e6:.3f} Mrays/s; launches {c}")
    if c["k3a"] < 1 or c["k3b"] < 1 or c["k4"] != 0 or c["k1"] != 0:
        raise AssertionError("sphere-field wavefront: want K3 launched and K4 / K1 not")
    a = img.cpu().numpy()
    if a.shape != (hs, hs, 3) or not np.isfinite(a).all():
        raise AssertionError(f"wavefront image bad: shape {a.shape}")
    log(f"  image means: K4@{cfg.spp}spp {k4_mean:.5f}, wavefront@1spp {a.mean():.5f}")
    if abs(k4_mean - float(a.mean())) > 0.05 * k4_mean:
        raise AssertionError("K4 and wavefront images disagree in mean by > 5%")
    return c, f"sphere-field wavefront dispatch ({hs}x{hs}, 1 spp, d{cfg.max_depth})"


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

    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    t0 = time.perf_counter()
    field = build_sphere_field(dev)
    log(f"sphere field build: {time.perf_counter() - t0:.2f} s, {field.num_tris} triangles")
    k3_err, k3_times = phase_k3(dev, scenes, field)
    del field
    env_err = phase_env(dev)
    k4_err = phase_k4(dev, scenes)
    m["k1"]["max_abs_err"] = max(m["k1"]["max_abs_err"], env_err["k1"])
    m["k4"], scene, cfg, k4_mean = phase_bvh_main(dev)
    m["k4"]["max_abs_err"] = max(m["k4"]["max_abs_err"], k4_err, env_err["k4"])
    wave_c, wave = phase_bvh_wavefront(scene, cfg, k4_mean)
    small, big = k3_times[K3_RAYS["parity"]], k3_times[K3_RAYS["timing"]]
    for key in ("k3a", "k3b"):
        m[key] = dict(launches=wave_c[key], launched_by=wave, max_abs_err=k3_err,
                      ms=small[key], plain_ms=small[key + "_plain"], rays=K3_RAYS["parity"],
                      ms_1m_rays=big[key], k2_ms=small["k2" + key[2]],
                      k2_ms_1m_rays=big["k2" + key[2]])
    specs = [
        ("K1 megakernel render_mega_rows", "gpuspectral_tpu_torch/csrc/mega.cu",
         "gpuspectral_tpu/integrator/mega.py:1452", "k1"),
        ("K2a closest_cuda", "gpuspectral_tpu_torch/csrc/isect.cu",
         "gpuspectral_tpu/ops/pallas_isect.py:138", "k2a"),
        ("K2b any_cuda", "gpuspectral_tpu_torch/csrc/isect.cu",
         "gpuspectral_tpu/ops/pallas_isect.py:171", "k2b"),
        ("K3a ftb_closest", "gpuspectral_tpu_torch/csrc/bvh.cu",
         "gpuspectral_tpu/bvh/ftb.py:334", "k3a"),
        ("K3b ftb_any", "gpuspectral_tpu_torch/csrc/bvh.cu",
         "gpuspectral_tpu/bvh/ftb.py:370", "k3b"),
        ("K4 fused-BVH megakernel render_mega_bvh_rows", "gpuspectral_tpu_torch/csrc/mega_bvh.cu",
         "gpuspectral_tpu/integrator/mega_bvh.py:1009", "k4"),
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
