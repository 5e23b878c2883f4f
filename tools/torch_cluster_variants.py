"""Time K7d and K7e, the cluster sweep's kernels (gpuspectral_tpu_torch/
csrc/cluster.cu), on the sphere field, with checksums of their outputs.

    PYTHONPATH=ROOT python3 tools/torch_cluster_variants.py ab

`ab` times the port on PYTHONPATH (the tree's own build): K7d and K7e on
chip_smoke.py's 65,536 random rays and the 262,144 primary rays of the
512x512 frame, on K7c's votes, each call given the supernode tables and
the attribute rows built once, as the wavefront gives them.  It prints
checksums of their outputs, which no design of the sweep changes (two
trees print the same ones).  To compare two trees on one card, unpack the
parent with `git archive` into build/ and run this from the change's tree
in one call, in the order parent, change, change, parent.  One JSON line.
Needs a CUDA device and nvcc.

The sweep's decided variants build from this tool at earlier commits: 1, 2
or 8 warps a CTA and the Woop loop not unrolled (`variants`) at 88dd764,
the sweep without the gate on leaf clusters (`nogate`) at 21f0d59.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch_variants as tv

REPS = 5


def calls(dev):
    """{name: a no-argument call} of the timed work: K7d and K7e on the
    random and the primary rays, on K7c's votes."""
    from gpuspectral_tpu_torch.bvh import cluster_sweep as cs
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    field = build_sphere_field(dev)
    sn, attr = cs.scene_supernodes(field), ftb.attr_table(field)
    rays = dict(random=tv.chip_smoke.field_rays(tv.chip_smoke.K3_RAYS["parity"], field, 20, dev),
                primary=tv.chip_smoke.primary_rays(field, 512, dev))
    work = {}
    for tag, (o, d, lo, hi) in rays.items():
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
    ms = {name: tv.chip_smoke.cuda_ms(fn, reps=REPS) for name, fn in work.items()}
    print(json.dumps(dict(
        root=root, card=smi, ms=ms, outputs={k: tv.checksum(*v) for k, v in got.items()},
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items() if "cluster" in k})),
        flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_cluster_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:] != ["ab"]:
        print("usage: torch_cluster_variants.py ab", file=sys.stderr)
        sys.exit(2)
    sys.exit(main_ab())
