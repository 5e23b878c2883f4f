"""Command-line entry points (port of gpuspectral_tpu/cli/main.py: the
`render`, `benchmark`, `gradcheck`, `view` and `invert` commands, with the
reference's flags).

  python -m gpuspectral_tpu_torch.cli.main render <scene.xml> [-o out.png] [--size WxH] ...
  python -m gpuspectral_tpu_torch.cli.main benchmark <scene.xml> [...]
  python -m gpuspectral_tpu_torch.cli.main gradcheck <scene.xml> [--spp N] [--size WxH]
  python -m gpuspectral_tpu_torch.cli.main view <scene.xml> [--frames N] [--every K] [--preview p.png] [--ansi]
  python -m gpuspectral_tpu_torch.cli.main invert <scene.xml> [--target img.exr] [--steps N]

Scene XML film/sampler/integrator settings are honored by default.  A scene
argument of the form builtin:<name> renders a scene built in code
(scene/zoo.py:BUILTIN: "sphere_field", "sphere_field_noenv", "one_weekend").  `--device`
picks where the scene lives (default: cuda); the benchmark measures only a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="Mitsuba XML scene file, or builtin:<name> (scene/zoo.py)")
    p.add_argument("-o", "--output", default="out.png", help="output image (.png/.pfm/.exr)")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel (default: scene XML)")
    p.add_argument("--size", default=None, help="WxH (default: scene XML film)")
    p.add_argument("--depth", type=int, default=None, help="max path depth (default: 50)")
    p.add_argument("--no-nee", action="store_true", help="disable next-event estimation")
    p.add_argument("--jitter", action="store_true", help="subpixel jitter antialiasing")
    p.add_argument("--tonemap", action="store_true", help="ACES filmic tonemap for PNG")
    p.add_argument("--seed", type=int, default=0, help="base timestamp / frame seed")
    p.add_argument("--ray-batch", type=int, default=65536)
    p.add_argument(
        "--bvh", action=argparse.BooleanOptionalAction, default=None,
        help="BVH traversal (default: auto — on above 2048 triangles)",
    )
    p.add_argument("--bvh-kernel", default="ftb", choices=["ftb", "binned", "cluster", "dfs"],
                   help="BVH kernel of the wavefront: ftb (K3), binned (K7a / K7b), "
                        "cluster (K7c-e) or dfs (K7f / K7g)")
    p.add_argument("--light-block", type=int, default=None,
                   help="share one NEE light pick per N-lane block of the wavefront "
                        "(0 disables; default 0 for brute-force scenes)")
    p.add_argument("--packet-size", type=int, default=1024)
    p.add_argument("--metrics", default=None, help="append JSONL metrics to this file")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler chrome trace into this directory")
    p.add_argument(
        "--intersector", default="auto", choices=["auto", "mega", "mega_bvh", "pallas", "woop", "mt"],
        help="auto: a megakernel for CUDA scenes when eligible (mega: brute force, "
             "mega_bvh: BVH), else the wavefront; woop / mt force the plain torch Woop / "
             "Moller-Trumbore scans, or with a BVH the packet traversal (K7h on the card, "
             "its plain torch version on the CPU)",
    )
    p.add_argument("--light-sampling", default="uniform", choices=["uniform", "power"],
                   help="NEE light pick: uniform (reference) or power-proportional")
    p.add_argument("--mis", default="reference", choices=["reference", "exact"],
                   help="emitter-hit MIS weight: the reference's directWeight "
                        "approximation or the exact light pdf")
    p.add_argument("--device", default="cuda", help="torch device of the scene (cuda or cpu)")


class CliError(RuntimeError):
    pass


def _check_device(args):
    device = getattr(args, "device", "cuda")
    if str(device).startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise CliError("no CUDA device: pass --device cpu to run with the plain versions")
    return device


def _build(args):
    import os

    from ..integrator.mega import MEGA_MAX_TRIS
    from ..scene import SceneBuilder, load_mitsuba_scene
    from ..scene.zoo import BUILTIN
    from ..utils import RenderConfig

    builtin = args.scene[len("builtin:"):] if args.scene.startswith("builtin:") else None
    if builtin is not None and builtin not in BUILTIN:
        raise CliError(f"unknown builtin scene {builtin!r} (have: {', '.join(BUILTIN)})")
    if builtin is None and not os.path.exists(args.scene):
        raise CliError(f"scene file not found: {args.scene}")
    device = _check_device(args)
    if builtin is not None:
        builder = BUILTIN[builtin](SceneBuilder())
        scene = builder.build(device)
    else:
        scene, builder = load_mitsuba_scene(args.scene, device=device)
    width, height = builder.film_width, builder.film_height
    if args.size:
        try:
            width, height = (int(x) for x in args.size.lower().split("x"))
        except ValueError:
            raise CliError(f"--size expects WxH (e.g. 512x512), got: {args.size}")
    use_bvh = getattr(args, "bvh", None)
    if use_bvh is None:
        use_bvh = scene.num_tris > MEGA_MAX_TRIS
    light_block = getattr(args, "light_block", None)
    if light_block is None:
        light_block = 256 if use_bvh else 0
    cfg = RenderConfig(
        width=width,
        height=height,
        spp=args.spp if args.spp is not None else builder.film_spp,
        max_depth=args.depth if args.depth is not None else 50,
        nee=not args.no_nee,
        jitter=args.jitter,
        ray_batch=args.ray_batch,
        use_bvh=use_bvh,
        bvh_kernel=getattr(args, "bvh_kernel", "ftb"),
        packet_size=getattr(args, "packet_size", 1024),
        intersector=getattr(args, "intersector", "auto"),
        sort_rays=use_bvh,
        light_block=light_block,
        light_sampling=getattr(args, "light_sampling", "uniform"),
        mis_mode=getattr(args, "mis", "reference"),
    )
    return scene, cfg


def _write(path: str, img, tonemap: bool) -> None:
    from ..io.image import write_exr, write_pfm, write_png

    if path.endswith(".pfm"):
        write_pfm(path, img)
    elif path.endswith(".exr"):
        write_exr(path, img)
    else:
        write_png(path, img, tonemap=tonemap)


def _log_spans(log) -> None:
    """The command's spans and counters (utils/profiling.snapshot) as the
    metrics file's last line, event "spans"; closes the log."""
    from ..utils import profiling

    log.log(event="spans", spans=profiling.snapshot())
    log.close()


def cmd_render(args) -> int:
    from ..integrator import render_image_auto
    from ..utils import profiling
    from ..utils.metrics import MetricsLogger

    profiling.reset()
    scene, cfg = _build(args)
    print(
        f"rendering {args.scene}: {cfg.width}x{cfg.height} @ {cfg.spp} spp, "
        f"depth {cfg.max_depth}, nee={cfg.nee}, tris={scene.num_tris}, "
        f"lights={scene.num_lights}, device={scene.device}",
        file=sys.stderr,
    )
    t0 = time.time()
    with profiling.trace(args.profile):
        img = render_image_auto(scene, cfg, timestamp0=args.seed)
        img = img.cpu().numpy()
    dt = time.time() - t0
    log = MetricsLogger(args.metrics)
    log.log(event="render", scene=args.scene, width=cfg.width, height=cfg.height, spp=cfg.spp,
            seconds=dt, device=str(scene.device))
    _log_spans(log)
    print(f"done in {dt:.2f}s on {scene.device} (incl. kernel build)", file=sys.stderr)
    _write(args.output, img, args.tonemap)
    print(args.output)
    return 0


def cmd_benchmark(args) -> int:
    from ..utils.bench import run_benchmark

    try:
        result = run_benchmark(args)
    except RuntimeError as e:
        raise CliError(str(e))
    print(json.dumps(result))
    return 0


def _ansi_preview(img, max_rows: int = 40) -> str:
    """Render an (H,W,3) linear image as 24-bit ANSI half-block art — the
    headless stand-in for the reference's swapchain window
    (engine/Window.cpp:20-25)."""
    import numpy as np

    from ..io.image import tonemap_aces

    h = img.shape[0]
    rows = min(max_rows * 2, h)
    step = max(1, h // rows)
    small = img[::step, ::step][:rows]
    srgb = np.clip(tonemap_aces(np.asarray(small)), 0.0, 1.0) ** (1 / 2.2)
    q = (srgb * 255).astype(np.uint8)
    lines = []
    for y in range(0, q.shape[0] - 1, 2):
        top, bot = q[y], q[y + 1]
        line = "".join(
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        )
        lines.append(line + "\x1b[0m")
    return "\n".join(lines)


def cmd_view(args) -> int:
    """Progressive viewer: the reference's Window::run frame loop
    (engine/Window.cpp:20-25) headless — 1 spp/frame folded into the running
    mean on the scene's device, preview written every K frames (PNG and/or
    ANSI terminal art)."""
    from ..engine import Engine

    scene, cfg = _build(args)
    eng = Engine(".", device=scene.device)
    eng.init(cfg.width, cfg.height, spp=1, max_depth=cfg.max_depth, nee=cfg.nee,
             use_bvh=cfg.use_bvh, intersector=cfg.intersector, sort_rays=cfg.sort_rays)
    eng.scene = scene

    every = max(1, args.every)

    def on_frame(i, img):
        if i % every:
            return
        if args.preview:
            _write(args.preview, img, True)
        if args.ansi:
            sys.stdout.write("\x1b[H\x1b[2J" + _ansi_preview(img) + "\n")
        print(f"frame {i}/{args.frames} (1 spp/frame running mean)", file=sys.stderr)

    t0 = time.time()
    eng.run(args.frames, on_frame=on_frame)
    print(f"{args.frames} frames in {time.time() - t0:.1f}s on {scene.device}", file=sys.stderr)
    if args.output:
        eng.save(args.output, tonemap=args.tonemap)
        print(args.output)
    return 0


def cmd_gradcheck(args) -> int:
    import os

    from ..diff.gradcheck import run_gradcheck

    if not os.path.exists(args.scene):
        raise CliError(f"scene file not found: {args.scene}")
    ok, report = run_gradcheck(args.scene, spp=args.spp or 64, size=args.size,
                               device=_check_device(args))
    print(json.dumps(report))
    return 0 if ok else 1


def cmd_invert(args) -> int:
    import numpy as np

    from ..diff.invert import _render, invert, optimizable_mask
    from ..utils import profiling
    from ..utils.metrics import MetricsLogger

    profiling.reset()
    scene, cfg = _build(args)
    if cfg.width > 128 or args.spp is None:
        cfg = cfg.replace(width=min(cfg.width, 128), height=min(cfg.height, 128),
                          spp=args.spp or 8, max_depth=min(cfg.max_depth, 5))
    log = MetricsLogger(args.metrics)
    mask = optimizable_mask(scene.bsdf_kind.cpu().numpy())
    if args.target:
        if args.target.endswith(".exr"):
            from ..io.exr import read_exr

            target = read_exr(args.target)
        else:
            from ..io.image import read_pfm

            target = read_pfm(args.target)
        init = None
    else:
        # self-target demo: render the truth, perturb the optimizable entries
        target = _render(scene, cfg, cfg.spp, 0).cpu().numpy()
        p0 = scene.bsdf_params.cpu().numpy().copy()
        rs = np.random.default_rng(0)
        p0[mask] = np.clip(p0[mask] + rs.uniform(-0.25, 0.25, size=mask.sum()), 0.02, 1.0)
        init = p0
        print(f"self-target: perturbed {mask.sum()} parameters", file=sys.stderr)
    params, history = invert(scene, target, cfg, steps=args.steps, lr=args.lr, init_params=init,
                             metrics=log, checkpoint_dir=args.checkpoint_dir)
    _log_spans(log)
    truth = scene.bsdf_params.cpu().numpy()
    param_err = (float(np.abs(params.cpu().numpy() - truth)[mask].mean())
                 if args.target is None else None)
    print(json.dumps(dict(loss_first=history[0], loss_last=history[-1], steps=len(history),
                          mean_param_error=param_err)))
    return 0


def parser() -> argparse.ArgumentParser:
    """The command line's parser: `parser().parse_args([...])` gives the
    arguments that _build and utils.bench.run_benchmark take."""
    parser = argparse.ArgumentParser(prog="gpuspectral_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="render a scene to an image")
    _add_render_args(p_render)
    p_render.set_defaults(fn=cmd_render)

    p_bench = sub.add_parser("benchmark", help="measure Mrays/s on a scene (CUDA only)")
    _add_render_args(p_bench)
    p_bench.add_argument("--warmup", type=int, default=1)
    p_bench.add_argument("--iters", type=int, default=3)
    p_bench.set_defaults(fn=cmd_benchmark)

    p_grad = sub.add_parser("gradcheck", help="check path-replay grads vs finite differences")
    _add_render_args(p_grad)
    p_grad.set_defaults(fn=cmd_gradcheck)

    p_view = sub.add_parser("view", help="progressive viewer (headless frame loop)")
    _add_render_args(p_view)
    p_view.add_argument("--frames", type=int, default=64, help="progressive 1-spp frames")
    p_view.add_argument("--every", type=int, default=4, help="preview every K frames")
    p_view.add_argument("--preview", default=None, help="PNG refreshed every K frames")
    p_view.add_argument("--ansi", action="store_true", help="24-bit ANSI preview in terminal")
    p_view.set_defaults(fn=cmd_view)

    p_inv = sub.add_parser("invert", help="inverse rendering: recover BSDF params")
    _add_render_args(p_inv)
    p_inv.add_argument("--target", default=None,
                       help="target image (.exr/.pfm); default: self-target demo "
                            "(render truth, perturb, recover)")
    p_inv.add_argument("--steps", type=int, default=100)
    p_inv.add_argument("--lr", type=float, default=0.02)
    p_inv.add_argument("--checkpoint-dir", default=None)
    p_inv.set_defaults(fn=cmd_invert)
    return parser


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
