"""The block sweep of K7a / K7b (gpuspectral_tpu_torch/csrc/binned.cu) at
several block sizes, beside the kernels' own times.

    PYTHONPATH=. python3 tools/torch_dfs_block.py binned [32 64 128 256]

K7a / K7b walk K3's BVH one thread a ray, so no CTA block is left to
vary in the kernels.  What hangs on the block is the TPU
kernel's block sweep, one of the two counts of their bound: for each size
B the script counts the tests per ray that the block sweep makes at B
(binned.binned_tests: box and Woop tests, the bins a block visits) on the
sphere field (builtin:sphere_field, 147,460 triangles) over 65,536 random
rays and the 262,144 primary rays of the 512x512 frame, chip_smoke.py's
rays, and prints them beside the times of the tree's K7a / K7b on those
rays (CUDA events), the kernels held to their plain versions first.  One
JSON line per (size, rays).  Needs a CUDA device and nvcc.

K7f / K7g's block is a warp (csrc/dfs.cu); their variants are
tools/torch_dfs_variants.py's.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import torch
import torch_variants as tv

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gpuspectral_tpu_torch.bvh import binned as bn  # noqa: E402
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_dfs_block: no CUDA device", file=sys.stderr)
        return 1
    if not argv or argv[0] != "binned":
        print("usage: torch_dfs_block.py binned [block ...]", file=sys.stderr)
        return 2
    blocks = [int(x) for x in argv[1:]] or [32, 64, 128, 256]
    dev = torch.device("cuda")
    field = build_sphere_field(dev)
    rays = dict(random=chip_smoke.field_rays(chip_smoke.K3_RAYS["parity"], field, 20, dev),
                primary=chip_smoke.primary_rays(field, chip_smoke.HEADLINE["size"], dev))
    smi = tv.card()
    for tag, (o, d, lo, hi) in rays.items():
        got = (*bn.binned_closest(field, o, d, t_max=hi), bn.binned_any(field, o, d, lo, hi))
        ref = (*bn.binned_closest_ref(field, o, d, t_max=hi),
               bn.binned_any_ref(field, o, d, lo, hi))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError("K7a / K7b differ from their plain versions")
        times = dict(
            k7a_ms=chip_smoke.cuda_ms(lambda: bn.binned_closest(field, o, d, t_max=hi), reps=5),
            k7b_ms=chip_smoke.cuda_ms(lambda: bn.binned_any(field, o, d, lo, hi), reps=5))
        for block in blocks:
            tests = {}
            for key, any_hit, t_min in (("closest", False, torch.zeros_like(hi)),
                                        ("any", True, lo)):
                boxes, woops, visits, _ = bn.binned_tests(field, o, d, t_min, hi, any_hit, block)
                tests[key] = dict(box_per_ray=float(boxes.double().mean()),
                                  woop_per_ray=float(woops.double().mean()),
                                  visits_per_ray=float(visits.double().mean()))
            print(json.dumps(dict(family="binned", block=block, rays=tag, n_rays=o.shape[0],
                                  card=smi, **times, tests=tests)), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
