"""Time K7c, K7d and K7e, the cluster sweep's kernels (gpuspectral_tpu_torch/
csrc/cluster.cu), on the sphere field, with checksums of their outputs, and
K7c at variants of its design.

    PYTHONPATH=ROOT python3 tools/torch_cluster_variants.py ab
    PYTHONPATH=. python3 tools/torch_cluster_variants.py votes [variant ...]

The rays: chip_smoke.py's 65,536 random rays, the 262,144 primary rays of
the 512x512 frame and (K7c only) the random rays with ~5% of the lanes
live, scattered (chip_smoke.sparse_lanes, as in the wavefront's late
bounces).  Every call is given the supernode tables and the attribute rows
built once, as the wavefront gives them.

`ab` times the port on PYTHONPATH (the tree's own build): K7c on the
closest-hit segments of the three sets, K7d and K7e on the random and
primary rays on K7c's votes.  It prints checksums of the outputs, which no
design of the kernels changes (two trees print the same ones), and ptxas's
lines of the cluster kernels.  To compare two trees on one card, unpack the
parent with `git archive` into build/ and run this from the change's tree
in one call, in the order parent, change, change, parent.

`votes` builds copies of cluster.cu, one change each from the shipped K7c
(8 warps a CTA, 256 supernodes a CTA, the live rays of a warp of more than
8 culled as one bundle, the boxes staged in shared memory, the kept
supernodes tested two at a time against the lanes' rays):

  nocull      no bundle cull: a warp keeps every supernode
  warps4      4 warps a CTA, each taking two warps of rays in turn
  range1024   no split: a CTA takes all of a block's supernodes
  range128    128 supernodes a CTA
  direct0     every warp with a live ray culls by its bundle
  direct2     a warp of more than 2 live rays culls by its bundle
  unroll1     the kept supernodes tested one at a time

Each goes to build/cluster_variants/<name>/ (one nvcc a variant, all
started together, with the flags of gpuspectral_tpu_torch/_build.py;
ptxas's registers and spills of cluster_votes_kernel printed).  The tree's
K7c is held to its plain version on the three sets and each variant's votes
to the tree's; then every variant and the tree's own build are timed, in
order and again in reverse order.  One JSON line.  Needs a CUDA device and
nvcc.

Times are chip_smoke.device_ms: the card's own time a call, the calls
queued behind a sleeping kernel, so that the wrappers' host time (~0.1 ms a
call, more than K7c takes on most rays) is not in them.

K7c's decided variants build from this tool's `votes` at 81e6d2d: the
bundle of the block's live rays in place of the warp's (`blockcull`) and
the boxes read with __ldg from the (3, Sp) tables in place of shared
memory (`ldg`).  K7d / K7e's build from it at earlier commits: 1, 2 or 8
warps a CTA and the Woop loop not unrolled (`variants`) at 88dd764, the
sweep without the gate on leaf clusters (`nogate`) at 21f0d59.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch_variants as tv

REPS = 20
CONSTS = dict(nocull=dict(kCull="false"), warps4=dict(kVoteWarps="4"),
              range1024=dict(kRange="1024"), range128=dict(kRange="128"),
              direct0=dict(kDirect="0"), direct2=dict(kDirect="2"))
# unroll1: the kept supernodes tested one at a time against the lanes' rays
_PAIRS = """        for (unsigned m = kept; m;) {
          const int b0 = __ffs(m) - 1;
          m &= m - 1;
          const int b1 = m ? __ffs(m) - 1 : b0;
          m &= m - 1;
          const gst::Box x0 = boxes(s0 + b0), x1 = boxes(s0 + b1);
          hit |= (unsigned)gst::vote_passes(x0, ray.o, ray.inv, ray.lo, ray.hi) << b0 |
                 (unsigned)gst::vote_passes(x1, ray.o, ray.inv, ray.lo, ray.hi) << b1;
        }"""
_SINGLES = """        for (unsigned m = kept; m; m &= m - 1) {
          const int b = __ffs(m) - 1;
          hit |= (unsigned)gst::vote_passes(boxes(s0 + b), ray.o, ray.inv, ray.lo, ray.hi) << b;
        }"""


def variants() -> dict:
    """{name: {file name: text}} of every variant of K7c."""
    from gpuspectral_tpu_torch import _build

    out = {name: tv.variant_sources(("cluster.cu",), consts) for name, consts in CONSTS.items()}
    text = (_build._CSRC / "cluster.cu").read_text()
    if text.count(_PAIRS) != 1:
        raise RuntimeError("csrc/cluster.cu: K7c's loop over kept supernodes not found")
    out["unroll1"] = {"cluster.cu": text.replace(_PAIRS, _SINGLES)}
    return out


def rays(field, dev):
    """{name: (o, d, t_min, t_max)}: the random, primary and sparse rays."""
    cs = tv.chip_smoke
    random = cs.field_rays(cs.K3_RAYS["parity"], field, 20, dev)
    return dict(random=random, primary=cs.primary_rays(field, 512, dev),
                sparse=cs.sparse_lanes(random))


def vote_calls(field, sn, sets):
    """{name: a no-argument call}: K7c on the closest-hit segment (0, t_max)
    of each set of rays."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs

    return {f"k7c_{tag}": (lambda o=o, d=d, hi=hi: cs.cluster_votes(
                field, o, d, torch.zeros_like(hi), hi, supernodes=sn))
            for tag, (o, d, _, hi) in sets.items()}


def calls(dev):
    """{name: a no-argument call} of the timed work: K7c on the three sets,
    K7d and K7e on the random and the primary rays, on K7c's votes."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    field = build_sphere_field(dev)
    sn, attr = cs.scene_supernodes(field), ftb.attr_table(field)
    sets = rays(field, dev)
    work = vote_calls(field, sn, sets)
    for tag in ("random", "primary"):
        o, d, lo, hi = sets[tag]
        votes = cs.cluster_votes(field, o, d, torch.zeros_like(hi), hi, supernodes=sn)
        votes_any = cs.cluster_votes(field, o, d, lo, hi, supernodes=sn)
        work[f"k7d_{tag}"] = (lambda o=o, d=d, hi=hi, v=votes: cs.cluster_closest(
            field, o, d, t_max=hi, attr=attr, votes=v, supernodes=sn))
        work[f"k7e_{tag}"] = (lambda o=o, d=d, lo=lo, hi=hi, v=votes_any: cs.cluster_any(
            field, o, d, lo, hi, votes=v, supernodes=sn))
    return work


def main_ab() -> int:
    from gpuspectral_tpu_torch import _build

    dev = torch.device("cuda")
    smi = tv.card()
    _build.load()
    root = str(pathlib.Path(_build.__file__).resolve().parents[1])
    work = calls(dev)
    got = tv.results(work)
    ms = {name: tv.chip_smoke.device_ms(fn, reps=REPS) for name, fn in work.items()}
    print(json.dumps(dict(
        root=root, card=smi, ms=ms, outputs={k: tv.checksum(*v) for k, v in got.items()},
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items() if "cluster" in k})),
        flush=True)
    return 0


def main_votes(names) -> int:
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    every = variants()
    names = names or list(every)
    dev = torch.device("cuda")
    smi = tv.card()
    print(smi, flush=True)
    libs = tv.build("cluster_variants", {n: every[n] for n in names}, ("gst_cluster_votes",),
                    show=lambda kern: "cluster_votes" in kern)
    field = build_sphere_field(dev)
    sn = cs.scene_supernodes(field)
    sets = rays(field, dev)
    work = vote_calls(field, sn, sets)
    ref = tv.results(work)
    for tag, (o, d, _, hi) in sets.items():
        plain = cs.cluster_votes_ref(field, o, d, torch.zeros_like(hi), hi, supernodes=sn)
        if not torch.equal(ref[f"k7c_{tag}"][0], plain):
            raise AssertionError(f"the tree's K7c differs from its plain version on {tag} rays")
    tv.check_builds(libs, work, ref)  # raises on a difference
    times = tv.time_in_turns(dict(libs, tree=None), work, REPS, tv.chip_smoke.device_ms)
    print(json.dumps(dict(card=smi, rays={k: v[0].shape[0] for k, v in sets.items()},
                          ms=times)), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_cluster_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("ab", "votes") or (mode == "ab" and sys.argv[2:]):
        print("usage: torch_cluster_variants.py ab | votes [variant ...]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main_ab() if mode == "ab" else main_votes(sys.argv[2:]))
