"""Time K4 and K6 (gpuspectral_tpu_torch/csrc/mega_bvh.cu) and K3
(csrc/bvh.cu) at each step of the design of their BVH walk (csrc/bvh.cuh),
on the sphere field.

    PYTHONPATH=. python3 tools/torch_mega_bvh_variants.py variants [variant ...]
    PYTHONPATH=ROOT python3 tools/torch_mega_bvh_variants.py ab

`variants` builds copies of bvh.cuh, bvh.cu and mega_bvh.cu with the
Woop loop's unroll factor (kWoopUnroll, bvh.cuh) and the launch shape
(kThreads, K3's kWarpsPerSm) of bvh.cu and mega_bvh.cu set per variant,
one change each from the shipped walk (child pairs down to single
clusters, the nearer child first for the closest hit and the left for
the any hit, while-while, a cluster's Woop loop unrolled by 4, the stack
in a local array; 16 warps an SM):

  unroll1, unroll2, unroll8   the Woop loop unrolled by 1, 2 or 8
  k3_warps32       K3 at 32 warps an SM (at most 64 registers a thread)
  threads256       256 threads a CTA (K4 / K6 at 2 CTAs an SM)

The study's earlier steps (the preorder walk on 128-bit rows, child pairs
with leaves of 1-8 clusters over 32-byte cluster rows, the top of the
tree staged in shared memory, the stack in shared memory, a prefetched
cluster row) are variants of this tool at commit 276c7be; speculative
traversal (a lane puts a leaf off and goes on down until every lane of
its warp has one) at commit 8685d23; the left child first for the
closest hit, the nearer first for the any hit, and one walk step a loop
turn (a warp tests one lane's leaf while the others wait) at commit
4ca68e2.

Each variant goes to build/mega_bvh_variants/<name>/ (one nvcc per variant,
all started together, with the flags of gpuspectral_tpu_torch/_build.py;
ptxas's registers, spills and shared memory printed).  Each variant's K3
closest and any hit on chip_smoke.py's 65,536 random rays and the 262,144
primary rays of the 512x512 frame, its K4 frame and its K6 planes must
equal the tree's own kernels output for output (chip_smoke.py holds those
to the plain versions; the tree's K3 is held to the plain version here
too, on the random rays).  Then every variant and the tree's own build are
timed with CUDA events, in order and again in reverse order: K4 over the
sphere-field frame (the CLI's `benchmark builtin:sphere_field --size
512x512 --spp 64 --depth 50` config), K6 over the grad_bvh frame
(builtin:sphere_field_noenv, 512x512 @ 64 spp, d5: what one step of
run_grad_benchmark launches), K3a / K3b on both ray sets.  One JSON line.
About 3 minutes of command for eight variants, less for these five.

`ab` times the port on PYTHONPATH (the tree's own build): the same K4 and
K6 frames and K3 rays, and run_grad_benchmark's grad_bvh step (2 steps),
and prints checksums of the K4 image and the K6 planes, which no walk
changes (two trees print the same ones).  To compare two trees on one
card, unpack the parent with `git archive` into build/ and run this from
the change's tree in one call, in the order parent, change, change, parent
(about 1 minute of command each).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch_variants as tv

BASE = dict(kWoopUnroll="4", kThreads="128", kWarpsPerSm="16")
VARIANTS = dict(
    unroll1=dict(kWoopUnroll="1"),
    unroll2=dict(kWoopUnroll="2"),
    unroll8=dict(kWoopUnroll="8"),
    k3_warps32=dict(kWarpsPerSm="32"),
    threads256=dict(kThreads="256"),
)
ENTRY_POINTS = ("gst_bvh_closest", "gst_bvh_any", "gst_mega_bvh", "gst_mega_bvh_grad")
K4_ARGS = ["benchmark", "builtin:sphere_field", "--size", "512x512", "--spp", "64",
           "--depth", "50"]
K6 = dict(scene="builtin:sphere_field_noenv", size=512, spp=64, depth=5)
TS = 101


def frames(dev):
    """(K4's scene and config, K6's scene, config and pixel rows, the two
    ray sets of chip_smoke.py)."""
    from gpuspectral_tpu_torch.cli import main as cli
    from gpuspectral_tpu_torch.integrator import mega_grad as mg
    from gpuspectral_tpu_torch.utils import RenderConfig
    from gpuspectral_tpu_torch.utils.bench import load_scene

    scene, cfg = cli._build(cli.parser().parse_args(K4_ARGS))
    scene6 = load_scene(K6["scene"], dev)
    cfg6 = RenderConfig(width=K6["size"], height=K6["size"], spp=K6["spp"],
                        max_depth=K6["depth"], use_bvh=True)
    rays = dict(random=tv.chip_smoke.field_rays(tv.chip_smoke.K3_RAYS["parity"], scene, 20, dev),
                primary=tv.chip_smoke.primary_rays(scene, 512, dev))
    return scene, cfg, scene6, cfg6, mg.pix_rows(cfg6, dev), rays


def calls(scene, cfg, scene6, cfg6, pix6, rays):
    """{name: a no-argument call} of the timed work."""
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.integrator import mega_bvh, mega_grad as mg

    out = dict(k4_frame=lambda: mega_bvh.render_mega_bvh(scene, cfg, TS),
               k6_frame=lambda: mg.render_mega_bvh_fwdgrad_rows(scene6, cfg6, pix6, TS))
    for tag, (o, d, lo, hi) in rays.items():
        out[f"k3a_{tag}"] = lambda o=o, d=d, hi=hi: ftb.ftb_closest(scene, o, d, t_max=hi)
        out[f"k3b_{tag}"] = lambda o=o, d=d, lo=lo, hi=hi: ftb.ftb_any(scene, o, d, lo, hi)
    return out


REPS = dict(k4_frame=1, k6_frame=1, k3a_random=5, k3b_random=5, k3a_primary=5, k3b_primary=5)


def main_variants(names) -> int:
    from gpuspectral_tpu_torch.bvh import ftb

    names = names or list(VARIANTS)
    dev = torch.device("cuda")
    smi = tv.card()
    print(smi, flush=True)
    libs = tv.build("mega_bvh_variants", {
        name: tv.variant_sources(("bvh.cuh", "bvh.cu", "mega_bvh.cu"),
                                 dict(BASE, **VARIANTS[name])) for name in names},
        ENTRY_POINTS, show=lambda kern: "count" not in kern)
    scene, cfg, scene6, cfg6, pix6, rays = frames(dev)
    work = calls(scene, cfg, scene6, cfg6, pix6, rays)
    o, d, lo, hi = rays["random"]
    plain = ftb.ftb_closest_ref(scene, o, d, t_max=hi)[:4], ftb.ftb_any_ref(scene, o, d, lo, hi)
    ref = tv.results(work)
    if not (tv.same(ref["k3a_random"][:4], plain[0]) and tv.same(ref["k3b_random"], [plain[1]])):
        raise AssertionError("the tree's K3 differs from its plain version on random rays")
    tv.check_builds(libs, work, ref)
    times = tv.time_in_turns(dict(libs, tree=None), work, REPS)
    print(json.dumps(dict(card=smi, rays={k: v[0].shape[0] for k, v in rays.items()},
                          k4_frame=" ".join(K4_ARGS), k6_frame=K6, ms=times)), flush=True)
    return 0


def main_ab() -> int:
    from gpuspectral_tpu_torch import _build
    from gpuspectral_tpu_torch.utils.bench import run_grad_benchmark

    dev = torch.device("cuda")
    smi = tv.card()
    _build.load()
    root = str(pathlib.Path(_build.__file__).resolve().parents[1])
    scene, cfg, scene6, cfg6, pix6, rays = frames(dev)
    work = calls(scene, cfg, scene6, cfg6, pix6, rays)
    got = tv.results(work)
    ms = {name: tv.chip_smoke.cuda_ms(fn, reps=REPS[name]) for name, fn in work.items()}
    step = run_grad_benchmark(K6["scene"], size=K6["size"], spp=K6["spp"], depth=K6["depth"],
                              steps=2, use_bvh=True)
    k4 = got["k4_frame"]
    print(json.dumps(dict(
        root=root, card=smi, ms=ms, grad_bvh_seconds_per_step=step["seconds_per_step"],
        k4_image=tv.checksum(k4[0]), k4_rays=k4[1], k4_mean=float(k4[0].double().mean()),
        k6_planes=tv.checksum(*got["k6_frame"]),
        k3=tv.checksum(*got["k3a_random"][:4], *got["k3b_random"], *got["k3a_primary"][:4],
                    *got["k3b_primary"]),
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items()
               if "mega_bvh" in k or "bvh_closest" in k or "bvh_any" in k})), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_mega_bvh_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    mode = sys.argv[1] if len(sys.argv) > 1 else "variants"
    sys.exit(main_ab() if mode == "ab" else main_variants(sys.argv[2:]))
