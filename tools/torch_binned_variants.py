"""Time K7a and K7b, the binned sweep's kernels (gpuspectral_tpu_torch/
csrc/binned.cu), on the sphere field, with checksums of their outputs.

    PYTHONPATH=ROOT python3 tools/torch_binned_variants.py ab

The timed work: K7a and K7b on chip_smoke.py's 65,536 random rays and the
262,144 primary rays of the 512x512 frame, each call given the attribute
rows built once and the scene's bin rows, as the wavefront gives them.

`ab` times the port on PYTHONPATH (the tree's own build) and prints
checksums of the outputs, which no design of the kernels changes (two
trees print the same ones), and ptxas's lines of the binned kernels.  To
compare two trees on one card, unpack the parent with `git archive` into
build/ and run this from the change's tree in one call, in the order
parent, change, change, parent.  Needs a CUDA device and nvcc.

The decided variants of the design build from this tool's `variants` at
commit 3f246ab: the bin rows staged in shared memory by each CTA
(`staged`), a fresh vote at every leaf in place of the cached one
(`vote_every_leaf`) and K7b's walk near child first (`any_near`), each
held output for output to the kernels of that tree and timed in turns.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch_variants as tv

REPS = 5


def calls(dev):
    """{name: a no-argument call} of the timed work."""
    from gpuspectral_tpu_torch.bvh import binned as bn
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    field = build_sphere_field(dev)
    attr = ftb.attr_table(field)
    rays = dict(random=tv.chip_smoke.field_rays(tv.chip_smoke.K3_RAYS["parity"], field, 20, dev),
                primary=tv.chip_smoke.primary_rays(field, 512, dev))
    work = {}
    for tag, (o, d, lo, hi) in rays.items():
        work[f"k7a_{tag}"] = (lambda o=o, d=d, hi=hi: bn.binned_closest(field, o, d, t_max=hi,
                                                                         attr=attr))
        work[f"k7b_{tag}"] = (lambda o=o, d=d, lo=lo, hi=hi: bn.binned_any(field, o, d, lo, hi))
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
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items() if "binned" in k})),
        flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_binned_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:] != ["ab"]:
        print("usage: torch_binned_variants.py ab", file=sys.stderr)
        sys.exit(2)
    sys.exit(main_ab())
