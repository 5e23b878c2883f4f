"""Time K2 (gpuspectral_tpu_torch/csrc/isect.cu, the brute-force closest and
any hit) at each step of its design, and compare two trees' K2.

    PYTHONPATH=. python3 tools/torch_isect_variants.py variants [variant ...]
    PYTHONPATH=ROOT python3 tools/torch_isect_variants.py ab

`variants` builds copies of isect.cu and brute.cuh with their constants
set per variant, one change each from the shipped design (a thread a ray,
256 a CTA; the table staged 256 triangles at a time as three float4 a
triangle; the loop unrolled by 4; a dead lane, or for the any hit a lane
no longer searching, skipping the tests):

  base              the shipped design, built by this tool like the others:
                    a second reading of the tree's own build
  threads128        128 rays a CTA (kThreads)
  chunk128, chunk1024, chunk2048
                    128, 1,024 or 2,048 triangles staged at a time (kChunk;
                    2,048 stages the soup's table whole, 96 KB a CTA)
  unroll1, unroll2, unroll8
                    the loop unrolled by 1, 2 or 8 (brute.cuh's
                    kBruteUnroll, which K1 and K5 share)
  noskip            a probe, not a design: a dead lane runs the tests (the
                    CTA's skip still there)

Each goes to build/isect_variants/<name>/ (one nvcc per variant, all
started together, with the flags of gpuspectral_tpu_torch/_build.py;
ptxas's registers, spills and shared memory printed).  Every variant's K2a
and K2b must equal the tree's own kernels output for output (t, prim,
occ) on every ray set below; then the tree's own build and every variant
are timed with chip_smoke.device_ms (the card's time, queued behind a
sleeping kernel), in order and again in reverse order.  The tree is also
timed testing the whole table (`n_rows` = T; the calls' `*_whole` keys):
what the cut to the scene's tri_rows buys.  One JSON line.

The ray sets: 1M random rays in the Cornell box (chip_smoke.py's timed
rays) and 65,536 of them, those with ~5% of the lanes live and scattered
(chip_smoke.sparse_lanes), 65,536 random rays against the zoo and against
a 2048-triangle random soup; the checks add the 65,536 with NaN and
inactive lanes (chip_smoke.odd_lanes).  The scenes' tables are cut at
their tri_rows, as the wavefront calls K2.  And the frame: every K2 launch
of one Cornell 512x512, 1 spp, d50, power-pick frame (chip_smoke.py's
wavefront dispatch; tools/torch_wavefront_ab.py cornell), its inputs
copied as the tree's build ran them; each launch is timed on its own and
`k2a_frame` / `k2b_frame` are the sums.  The line's `frame` counts, for
each kernel, its launches, lanes, live lanes (t_max > t_min), 32-lane
warps, warps with a live lane and 256-lane CTAs with a live lane.

`ab` times K2 of the port on PYTHONPATH (the tree's own build) on the same
sets, the odd lanes too, and prints checksums of each set's t, prim and
occ, which the redesign does not change (two trees print the same ones),
with K2's ptxas lines.  A tree whose scenes have no tri_rows (before the
cut) is called with the whole table.  To compare two trees on one card,
unpack the parent with `git archive` into build/ and run this from the
change's tree in one call, in the order parent, change, change, parent.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch_variants as tv

SOURCES = ("isect.cu", "brute.cuh")
BASE = dict(kThreads="256", kChunk="256", kBruteUnroll="4")
VARIANTS = dict(
    base={},
    threads128=dict(kThreads="128"),
    chunk128=dict(kChunk="128"),
    chunk1024=dict(kChunk="1024"),
    chunk2048=dict(kChunk="2048"),
    unroll1=dict(kBruteUnroll="1"),
    unroll2=dict(kBruteUnroll="2"),
    unroll8=dict(kBruteUnroll="8"),
)
# the probe: (anchor, replacement) pairs in isect.cu
_PROBES = dict(noskip=(("      if (!ray.live) continue;\n", ""),
                       ("    if (searching && rows.any(", "    if ((searching || !ray.live) && rows.any(")))
ENTRY_POINTS = ("gst_closest", "gst_any")
REPS = 20


def probe_sources(name) -> dict:
    files = tv.variant_sources(SOURCES, BASE)
    for anchor, text in _PROBES[name]:
        if files["isect.cu"].count(anchor) != 1:
            raise RuntimeError(f"isect.cu: the anchor of {name} moved")
        files["isect.cu"] = files["isect.cu"].replace(anchor, text)
    return files


def ray_sets(dev, odd=False):
    """{set: (table, n_rows or None, rays)}."""
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.scene.zoo import build_zoo

    cs = tv.chip_smoke
    cornell = load_mitsuba_scene(cs.CORNELL, device=dev)[0]
    zoo = build_zoo(dev)
    rows = [getattr(s, "tri_rows", None) for s in (cornell, zoo)]
    rays = cs.random_rays(cs.K2_RAYS["timing"], -1.2, 2.2, 99, dev)
    sub = [x[:cs.K2_RAYS["parity"]] for x in rays]
    out = dict(cornell_1m=(cornell.tri_woop_t, rows[0], rays),
               cornell=(cornell.tri_woop_t, rows[0], sub),
               cornell_sparse=(cornell.tri_woop_t, rows[0], cs.sparse_lanes(sub)),
               zoo=(zoo.tri_woop_t, rows[1], cs.random_rays(cs.K2_RAYS["parity"], -1.2, 2.2, 11,
                                                             dev)),
               soup2048=(cs.soup_woop_t(2048, 7, dev), None,
                         cs.random_rays(cs.K2_RAYS["parity"], -2.5, 2.5, 3, dev)))
    if odd:
        out["cornell_odd"] = (cornell.tri_woop_t, rows[0], cs.odd_lanes(sub))
    return out


def frame_launches(dev):
    """[(kernel, wrapper, args)]: every K2 launch of one Cornell 512x512,
    1 spp, d50, power-pick frame (render_image_stats_auto, timestamp 100),
    its tensor arguments copied as the wrapper got them."""
    from gpuspectral_tpu_torch.integrator import render_image_stats_auto
    from gpuspectral_tpu_torch.ops import cuda_isect as ci
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig

    scene = load_mitsuba_scene(tv.chip_smoke.CORNELL, device=dev)[0]
    cfg = RenderConfig(width=512, height=512, spp=1, max_depth=50, ray_batch=65536,
                       light_sampling="power")
    got, real = [], dict(k2a="closest_cuda", k2b="any_cuda")

    def tap(kernel, name, fn):
        def call(*args):
            got.append((kernel, name, [a.clone() if isinstance(a, torch.Tensor) else a
                                       for a in args]))
            return fn(*args)
        return call

    fns = {name: getattr(ci, name) for name in real.values()}
    for kernel, name in real.items():
        setattr(ci, name, tap(kernel, name, fns[name]))
    try:
        render_image_stats_auto(scene, cfg, 100)
    finally:
        for name, fn in fns.items():
            setattr(ci, name, fn)
    torch.cuda.synchronize()
    return got


def frame_calls(launches) -> dict:
    """{k2a_frame_NNN / k2b_frame_NNN: a no-argument call}, one a launch."""
    from gpuspectral_tpu_torch.ops import cuda_isect as ci

    return {f"{kernel}_frame_{i:03d}": (lambda name=name, args=args: getattr(ci, name)(*args))
            for i, (kernel, name, args) in enumerate(launches)}


def frame_counts(launches) -> dict:
    """{kernel: counts of its launches' lanes, warps and CTAs}."""
    out = {}
    for kernel, _, args in launches:
        lo, hi = args[3], args[4]
        live = torch.zeros(-(-hi.shape[0] // 256) * 256, dtype=torch.bool, device=hi.device)
        live[:hi.shape[0]] = hi > lo
        c = out.setdefault(kernel, dict(launches=0, lanes=0, live_lanes=0, warps=0,
                                        live_warps=0, live_ctas=0))
        c["launches"] += 1
        c["lanes"] += hi.shape[0]
        c["live_lanes"] += int(live.sum())
        c["warps"] += -(-hi.shape[0] // 32)
        c["live_warps"] += int(live.view(-1, 32).any(1).sum())
        c["live_ctas"] += int(live.view(-1, 256).any(1).sum())
    return out


def frame_sums(times: dict) -> dict:
    """times with each build's per-launch frame times summed into
    k2a_frame / k2b_frame."""
    out = {}
    for build, calls_ms in times.items():
        row = {k: v for k, v in calls_ms.items() if "_frame_" not in k}
        for kernel in ("k2a", "k2b"):
            per = [v for k, v in calls_ms.items() if k.startswith(f"{kernel}_frame_")]
            row[f"{kernel}_frame"] = [sum(p[i] for p in per) for i in range(len(per[0]))]
        out[build] = row
    return out


def calls(sets, whole=False):
    """{name: a no-argument call}: K2a and K2b on each set (`whole`: on the
    whole table as well)."""
    from gpuspectral_tpu_torch.ops import cuda_isect as ci

    out = {}
    for name, (w, n_rows, (o, d, lo, hi)) in sets.items():
        zero = torch.zeros_like(hi)
        cuts = {"": n_rows}
        if whole and n_rows is not None:
            cuts["_whole"] = None
        for tag, n in cuts.items():
            kw = {} if n is None else dict(n_rows=n)
            out[f"k2a_{name}{tag}"] = (lambda o=o, d=d, w=w, zero=zero, hi=hi, kw=kw:
                                       ci.closest_cuda(o, d, w, zero, hi, **kw))
            out[f"k2b_{name}{tag}"] = (lambda o=o, d=d, w=w, lo=lo, hi=hi, kw=kw:
                                       ci.any_cuda(o, d, w, lo, hi, **kw))
    return out


def main_variants(names) -> int:
    names = names or [*VARIANTS, *_PROBES]
    dev = torch.device("cuda")
    smi = tv.card()
    print(smi, flush=True)
    libs = tv.build("isect_variants", {
        name: probe_sources(name) if name in _PROBES
        else tv.variant_sources(SOURCES, dict(BASE, **VARIANTS[name])) for name in names},
        ENTRY_POINTS)
    launches = frame_launches(dev)
    frame = frame_calls(launches)
    checked = dict(calls(ray_sets(dev, odd=True)), **frame)
    tv.check_builds(libs, checked, tv.results(checked))
    sets = ray_sets(dev)
    times = tv.time_in_turns(dict(tree=None, **libs), dict(calls(sets), **frame), REPS,
                             timer=tv.chip_smoke.device_ms)
    whole = {k: fn for k, fn in calls(sets, whole=True).items() if k.endswith("_whole")}
    times["tree"].update(tv.time_in_turns(dict(tree=None), whole, REPS,
                                          timer=tv.chip_smoke.device_ms)["tree"])
    print(json.dumps(dict(card=smi, frame=frame_counts(launches), ms=frame_sums(times))),
          flush=True)
    return 0


def main_ab() -> int:
    from gpuspectral_tpu_torch import _build

    dev = torch.device("cuda")
    smi = tv.card()
    _build.load()
    root = str(pathlib.Path(_build.__file__).resolve().parents[1])
    sets = ray_sets(dev, odd=True)
    work = calls(sets)
    got = tv.results(work)
    ms = {name: tv.chip_smoke.device_ms(fn, reps=REPS) for name, fn in work.items()}
    print(json.dumps(dict(
        root=root, card=smi, ms=ms,
        rows={name: n for name, (_, n, _) in sets.items()},
        checksums={name: tv.checksum(*out) for name, out in got.items()},
        hits={name: int((out[1] >= 0).sum()) if name.startswith("k2a") else int(out[0].sum())
              for name, out in got.items()},
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items() if "_isect_cu_" in k})),
        flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_isect_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    mode = sys.argv[1] if len(sys.argv) > 1 else "variants"
    sys.exit(main_ab() if mode == "ab" else main_variants(sys.argv[2:]))
