"""Hold the port's sharded megakernel paths on N ranks to the unsharded
ones on one card, and time both.

    torchrun --nproc-per-node N tools/torch_dist_check.py [--spp-shards S]
    python3 tools/torch_dist_check.py --ranks N --device cpu --size 32 --spp 4 --small

Every rank joins the group (parallel/launch.initialize: NCCL, one rank a
card, from torchrun's variables; with --ranks the script starts its N
ranks itself through parallel/dryrun.spawn_ranks, gloo ranks of the
GPUSPECTRAL_FAKE_HOSTS simulation for --device cpu), builds the same
scenes and runs, on a (N/S, S) mesh:

  k1  render_image_sharded_fast on Cornell, size^2 @ spp, d50 (K1 a rank)
  k4  the same on the sphere field (K4 a rank)
  k5  grad_step_sharded_fast on Cornell, size^2 @ spp, d5 (K5 a rank)
  k6  the same on the sphere field without its sky (K6 a rank)

against render_mega / render_mega_bvh and value_and_grad through
render_mega_diff / render_mega_bvh_diff on rank 0's device, held by
parallel/dryrun.check_render / check_grad (images equal when S is 1 and
within rtol 1e-5 + atol 1e-5 when the samples are split: a bright pixel of
the sphere field's sky moved by 1.3e-5).  Times:
the sharded call's wall on rank 0 between barriers (each rank
synchronized), the median of --reps after a warmup, the unsharded call
alone on rank 0's device the same way, and for k1 / k4 each rank's own
kernel launch on its rows alone (band_ms, rank order: the tiles are bands
of pixel rows whose work differs).  --small takes a small sphere field
(CPU runs).  Rank 0 prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpuspectral_tpu_torch.integrator import mega, mega_bvh, mega_grad  # noqa: E402
from gpuspectral_tpu_torch.parallel import dist as pdist, launch  # noqa: E402
from gpuspectral_tpu_torch.parallel.dryrun import (  # noqa: E402
    check_grad, check_render, spawn_ranks, value_and_grad)
from gpuspectral_tpu_torch.scene import load_mitsuba_scene  # noqa: E402
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field  # noqa: E402
from gpuspectral_tpu_torch.utils import RenderConfig  # noqa: E402

CORNELL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes",
                       "cornell", "scene.xml")
SMALL_FIELD = dict(n_side=2, segs=16, rings=8)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, reps, collective=True):
    """Median wall seconds of fn on rank 0 after a warmup; every rank calls
    it when collective, between barriers."""
    out = []
    for i in range(reps + 1):
        if collective:
            dist.barrier()
        t0 = time.perf_counter()
        fn()
        sync(dev)
        if collective:
            dist.barrier()
        if i:
            out.append(time.perf_counter() - t0)
    return statistics.median(out)


def band_times(key, scene, cfg, mesh, dev, reps):
    """Each rank's own K1 / K4 launch on its tile's rows at its local spp,
    alone (no collective), in rank order on every rank."""
    tiles, spp_shards, ti, si = pdist._axes(mesh)
    pix, _ = pdist._padded_rows(cfg, tiles, dev)
    per = pix.shape[0] // tiles
    local = cfg.replace(spp=cfg.spp // spp_shards)
    rows = mega.render_mega_rows if key == "k1" else mega_bvh.render_mega_bvh_rows
    ms = timed(lambda: rows(scene, local, pix[ti * per:(ti + 1) * per], si * local.spp), dev,
               reps, collective=False) * 1e3
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, ms)
    return out


def run(args):
    dev = launch.local_device()
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = pdist.make_mesh(n, args.spp_shards)
    field_kw = SMALL_FIELD if args.small else {}
    scenes = dict(cornell=load_mitsuba_scene(CORNELL, device=dev)[0],
                  field=build_sphere_field(dev, **field_kw),
                  noenv=build_sphere_field(dev, sky_hw=None, **field_kw))
    base = dict(width=args.size, height=args.size, spp=args.spp)
    cases = dict(
        k1=("cornell", dict(base, max_depth=50), mega.render_mega, None),
        k4=("field", dict(base, max_depth=50, use_bvh=True), mega_bvh.render_mega_bvh, None),
        k5=("cornell", dict(base, max_depth=5), None, mega_grad.render_mega_diff),
        k6=("noenv", dict(base, max_depth=5, use_bvh=True), None, mega_grad.render_mega_bvh_diff),
    )
    split = args.spp_shards > 1
    result = dict(ranks=n, mesh=list(mesh.shape), device=str(dev), size=args.size, spp=args.spp)
    for key, (name, kw, render, diff) in cases.items():
        scene, cfg = scenes[name], RenderConfig(**kw)
        if render is not None:
            img_s, rays_s = pdist.render_image_sharded_fast(scene, cfg, mesh)
            ms = timed(lambda: pdist.render_image_sharded_fast(scene, cfg, mesh), dev, args.reps)
            row = dict(ms_sharded=ms * 1e3, rays=rays_s, band_ms=band_times(key, scene, cfg, mesh,
                                                                           dev, args.reps))
            if rank == 0:
                img_u, rays_u = render(scene, cfg, 0)
                row.update(checked(lambda: check_render(key, (img_s, rays_s), (img_u, rays_u),
                                                        split)),
                           max_abs_err=float((img_s - img_u).abs().max()),
                           ms_unsharded=timed(lambda: render(scene, cfg, 0), dev, args.reps,
                                              collective=False) * 1e3)
        else:
            target = torch.as_tensor(np.random.default_rng(8).uniform(
                0.0, 1.0, (cfg.height, cfg.width, 3)).astype(np.float32), device=dev)
            got = pdist.grad_step_sharded_fast(scene, cfg, mesh, target, optimize_emission=True)
            ms = timed(lambda: pdist.grad_step_sharded_fast(scene, cfg, mesh, target), dev,
                       args.reps)
            row = dict(ms_sharded=ms * 1e3, loss=float(got[0]))
            if rank == 0:
                ref = value_and_grad(diff, scene, cfg, target)
                row.update(checked(lambda: check_grad(key, got, ref)),
                           loss_unsharded=float(ref[0]),
                           max_abs_err=max(float((a - b).abs().max())
                                           for a, b in zip(got[1:], ref[1:])),
                           ms_unsharded=timed(lambda: value_and_grad(diff, scene, cfg, target),
                                              dev, args.reps, collective=False) * 1e3)
        if rank == 0:
            row["speedup"] = row["ms_unsharded"] / row["ms_sharded"]
        result[key] = row
        dist.barrier()
    return result


def checked(check) -> dict:
    """{"ok": True} when check() passes, else ok False and its message: the
    other ranks go on to the next case instead of waiting on rank 0."""
    try:
        check()
    except AssertionError as e:
        return dict(ok=False, error=str(e))
    return dict(ok=True)


def spawn(args) -> int:
    """--ranks N: start N ranks of this script (gloo ranks on the CPU for
    --device cpu, else NCCL ranks on cuda:0 .. cuda:N-1) and print rank 0's
    output."""
    argv = list(sys.argv[1:])
    i = argv.index("--ranks")
    del argv[i:i + 2]
    outs = spawn_ranks([sys.executable, os.path.abspath(__file__)] + argv, args.ranks, args.device,
                       args.timeout)
    print(outs[0], end="", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp-shards", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="a small sphere field (CPU runs)")
    ap.add_argument("--ranks", type=int, default=0, help="start this many ranks itself")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.ranks:
        return spawn(args)
    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    launch.initialize(device=args.device, timeout_s=args.timeout)
    rank = dist.get_rank()
    try:
        result = run(args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(result), flush=True)
        bad = [k for k in ("k1", "k4", "k5", "k6") if not result[k]["ok"]]
        if bad:
            print(f"torch_dist_check: {bad} differ from the unsharded calls", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
