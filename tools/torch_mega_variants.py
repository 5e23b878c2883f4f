"""Time K1 (gpuspectral_tpu_torch/csrc/mega.cu) and K5 (csrc/mega_grad.cu),
the brute-force megakernels, at each step of the design of their
intersector (csrc/brute.cuh) and lane schedule (csrc/bounce.cuh), on the
Cornell box.

    PYTHONPATH=. python3 tools/torch_mega_variants.py variants [variant ...]
    PYTHONPATH=ROOT python3 tools/torch_mega_variants.py ab

`variants` builds copies of brute.cuh, mega.cu and mega_grad.cu with their
constants set per variant, one change each from the shipped design (the
Woop rows as three float4 a triangle in shared memory, the loop unrolled by
4, the grid resident and each thread taking its next pixel lane from a
counter, K5's partials in shared memory, K5's registers capped at 128, K1's
not capped):

  unroll1, unroll2, unroll8   the loop unrolled by 1, 2 or 8 (kBruteUnroll)
  ctas4            K1's registers capped at 128 too (kCtasPerSm 4)
  grad_nocap       K5's registers not capped (kGradCtasPerSm 1; ~148, 3
                   CTAs an SM)

Two probes time a share of the kernels, not a design: closest_x2 and
any_x2 run each closest-hit (any-hit) loop twice (a memory clobber between
the runs, the first run's result compared with the second's, so that
neither is folded away); the same outputs, so the time they add is about
what that loop costs the frame.

The decided variants build from this tool at commit 75e263c (the (12, n)
scalar rows, the rows in the constant bank, the pre-test before the divide
in two forms, the count of the warp tests the pre-test skips, and the caps
for 5 or 6 CTAs an SM, which spill), 291bede (the any hit leaving after a
whole unrolled turn, by turns of 4 and of 2) and e03242e (static: one CTA a
128 lanes, a thread one lane, the earlier schedule; globalparts: K5's
partials added in device memory).

Each variant goes to build/mega_variants/<name>/ (one nvcc per variant, all
started together, with the flags of gpuspectral_tpu_torch/_build.py;
ptxas's registers, spills and shared memory printed).  Each variant's K1
over the headline frame and the grad frame and its K5 over the grad frame
must equal the tree's own kernels output for output; then every variant and
the tree's own build are timed with CUDA events, in order and again in
reverse order: K1 over the headline frame (Cornell 512x512 @ 64 spp, d50,
one launch over the whole frame, as utils.bench.run_benchmark makes it),
K1 and K5 over the grad frame (512x512 @ 64 spp, d5: what one step of
run_grad_benchmark launches) and K5 over the grad_1024 frame (1024x1024 @
256 spp, d5).  One JSON line.

`ab` times the port on PYTHONPATH (the tree's own build): the same four
launches, run_grad_benchmark's grad step (2 steps), K4 over the sphere
field's frame and K6 over the grad_bvh frame (tools/torch_mega_bvh_variants.py's
frames), and prints checksums of K1's headline image and its ray count,
K5's image and partial planes on the grad frame, K4's image and K6's
planes, which the redesign does not change (two trees print the same ones),
with the kernels' ptxas lines.  To compare two trees on one card, unpack
the parent with `git archive` into build/ and run this from the change's
tree in one call, in the order parent, change, change, parent (about 1
minute of command each).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch_variants as tv

SOURCES = ("brute.cuh", "mega.cu", "mega_grad.cu")
BASE = dict(kBruteUnroll="4", kCtasPerSm="1", kGradCtasPerSm="4")
VARIANTS = dict(
    unroll1=dict(kBruteUnroll="1"),
    unroll2=dict(kBruteUnroll="2"),
    unroll8=dict(kBruteUnroll="8"),
    ctas4=dict(kCtasPerSm="4"),
    grad_nocap=dict(kGradCtasPerSm="1"),
)
# the probes: {name: (anchor, replacement)} in brute.cuh, each running a
# loop twice, the first run's result kept live by a comparison with the
# second's (always equal)
_PROBES = dict(
    closest_x2=("  __device__ void closest(", """\
  __device__ void closest(V3 o, V3 d, float& best_t, int& prim, float& bu,
                          float& bv) const {
    float t1, u1, v1;
    int p1;
    closest_once(o, d, t1, p1, u1, v1);
    asm volatile("" ::: "memory");
    closest_once(o, d, best_t, prim, bu, bv);
    if (p1 != prim) prim = -2;
  }

  __device__ void closest_once("""),
    any_x2=("  __device__ bool any(", """\
  __device__ bool any(V3 o, V3 d, float t_lo, float t_hi) const {
    const bool first = any_once(o, d, t_lo, t_hi);
    asm volatile("" ::: "memory");
    return any_once(o, d, t_lo, t_hi) & first;
  }

  __device__ bool any_once("""),
)
ENTRY_POINTS = ("gst_mega", "gst_mega_grad")
HEAD = dict(size=512, spp=64, depth=50)  # bench.py's cornell row
GRAD = dict(size=512, spp=64, depth=5)  # its grad row
GRAD_1024 = dict(size=1024, spp=256, depth=5)  # its grad_1024 row
TS = 101
REPS = dict(k1_head=3, k1_grad=3, k5_grad=3, k5_1024=1)


def probe_sources(name) -> dict:
    files = tv.variant_sources(SOURCES, BASE)
    anchor, text = _PROBES[name]
    if files["brute.cuh"].count(anchor) != 1:
        raise RuntimeError(f"brute.cuh: the anchor of {name} moved")
    files["brute.cuh"] = files["brute.cuh"].replace(anchor, text)
    return files


def frames(dev):
    """The Cornell scene, and (config, pixel rows) of the headline, grad and
    grad_1024 frames."""
    from gpuspectral_tpu_torch.integrator import mega
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig

    scene = load_mitsuba_scene(tv.chip_smoke.CORNELL, device=dev)[0]
    out = {}
    for key, f in (("head", HEAD), ("grad", GRAD), ("1024", GRAD_1024)):
        cfg = RenderConfig(width=f["size"], height=f["size"], spp=f["spp"], max_depth=f["depth"])
        out[key] = (cfg, mega.pix_rows(cfg, dev))
    return scene, out


def calls(scene, fr):
    """{name: a no-argument call} of the timed work."""
    from gpuspectral_tpu_torch.integrator import mega, mega_grad as mg

    def k1(key):
        return lambda: mega.render_mega_rows(scene, fr[key][0], fr[key][1], TS)

    def k5(key):
        return lambda: mg.render_mega_fwdgrad_rows(scene, fr[key][0], fr[key][1], TS)

    return dict(k1_head=k1("head"), k1_grad=k1("grad"), k5_grad=k5("grad"), k5_1024=k5("1024"))


def main_variants(names) -> int:
    names = names or [*VARIANTS, *_PROBES]
    dev = torch.device("cuda")
    smi = tv.card()
    print(smi, flush=True)
    libs = tv.build("mega_variants", {
        name: probe_sources(name) if name in _PROBES
        else tv.variant_sources(SOURCES, dict(BASE, **VARIANTS[name])) for name in names},
        ENTRY_POINTS, show=lambda kern: "mega" in kern)
    scene, fr = frames(dev)
    work = calls(scene, fr)
    checked = {k: work[k] for k in ("k1_head", "k1_grad", "k5_grad")}
    tv.check_builds(libs, checked, tv.results(checked))
    times = tv.time_in_turns(dict(libs, tree=None), work, REPS)
    print(json.dumps(dict(card=smi, frames=dict(head=HEAD, grad=GRAD, grad_1024=GRAD_1024),
                          ms=times)), flush=True)
    return 0


def main_ab() -> int:
    import torch_mega_bvh_variants as bv
    from gpuspectral_tpu_torch import _build
    from gpuspectral_tpu_torch.utils.bench import run_grad_benchmark

    dev = torch.device("cuda")
    smi = tv.card()
    _build.load()
    root = str(pathlib.Path(_build.__file__).resolve().parents[1])
    scene, fr = frames(dev)
    work = calls(scene, fr)
    scene4, cfg4, scene6, cfg6, pix6, rays = bv.frames(dev)
    bvh = bv.calls(scene4, cfg4, scene6, cfg6, pix6, rays)
    work.update(k4_frame=bvh["k4_frame"], k6_frame=bvh["k6_frame"])
    got = tv.results(work)
    reps = dict(REPS, k4_frame=1, k6_frame=1)
    ms = {name: tv.chip_smoke.cuda_ms(fn, reps=reps[name]) for name, fn in work.items()}
    step = run_grad_benchmark(tv.chip_smoke.CORNELL, size=GRAD["size"], spp=GRAD["spp"],
                              depth=GRAD["depth"], steps=2)
    k1, k5, k4 = got["k1_head"], got["k5_grad"], got["k4_frame"]
    print(json.dumps(dict(
        root=root, card=smi, ms=ms, k5_over_k1_grad=ms["k5_grad"] / ms["k1_grad"],
        grad_seconds_per_step=step["seconds_per_step"],
        k1_image=tv.checksum(*k1[:3]), k1_rays=int(k1[3].double().sum()),
        k1_mean=float(torch.stack(k1[:3]).double().mean()),
        k1_grad_frame=tv.checksum(*got["k1_grad"]),
        k5_image=tv.checksum(*k5[:4]), k5_planes=tv.checksum(k5[4]),
        k5_1024=tv.checksum(*got["k5_1024"]),
        k4_image=tv.checksum(k4[0]), k4_rays=k4[1], k6_planes=tv.checksum(*got["k6_frame"]),
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items() if "mega" in k})),
        flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_mega_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    mode = sys.argv[1] if len(sys.argv) > 1 else "variants"
    sys.exit(main_ab() if mode == "ab" else main_variants(sys.argv[2:]))
