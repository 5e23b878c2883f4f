"""K7h on the sphere field with and without its empty clusters' boxes.

    PYTHONPATH=. python3 tools/torch_traverse_empty.py

The sphere field's BVH (bvh/build.py) pads its 9,225 leaf clusters to a
power of two, 16,384, and gives each empty cluster the inverted box
(+inf, -inf).  Such a box passes every slab test of the packet traversal
(t_enter = -inf, t_exit = +inf), so a packet enters every empty leaf under
a node it enters and tests its 16 zero rows, which never hit.  This script
times K7h (csrc/traverse.cu) on the tree as built and on a copy whose
inverted boxes are NaN (kernels.nan_empty: a NaN box fails every slab
test), on chip_smoke.py's 65,536 random rays and the 262,144 primary rays of the 512x512 frame, in
turns (built, NaN, NaN, built), holds the two trees' results equal, and
prints the slab and Moller-Trumbore tests per ray of each
(kernels.traverse_tests).  It changes nothing in the package: it measures
what skipping empty subtrees would save.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import json
import subprocess

import torch

import chip_smoke as cs
from gpuspectral_tpu_torch.bvh import kernels
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field


def main():
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    field = build_sphere_field(dev)
    packed, lo_box, hi_box, levels = cs.traverse_tree(field)
    trees = dict(built=(packed, lo_box, hi_box, levels),
                 nan_empty=(packed, *kernels.nan_empty(lo_box, hi_box), levels))
    out = dict(empty_nodes=int((lo_box > hi_box).any(1).sum()), nodes=lo_box.shape[0])
    for tag, rays in (("random", cs.field_rays(cs.K3_RAYS["parity"], field, 20, dev)),
                      ("primary", cs.primary_rays(field, cs.HEADLINE["size"], dev))):
        o, d, lo, hi = rays
        zero = torch.zeros_like(hi)
        res = {k: (kernels.traverse_closest(o, d, *t, zero, hi), kernels.traverse_any(o, d, *t, lo, hi))
               for k, t in trees.items()}
        same = all(torch.equal(a, b) for a, b in zip(res["built"][0], res["nan_empty"][0]))
        same = same and torch.equal(res["built"][1], res["nan_empty"][1])
        if not same:
            raise AssertionError(f"{tag}: the trees' results differ")
        row = {}
        for k in ("built", "nan_empty", "nan_empty", "built"):
            t = trees[k]
            ms = (cs.cuda_ms(lambda: kernels.traverse_closest(o, d, *t, zero, hi), reps=2),
                  cs.cuda_ms(lambda: kernels.traverse_any(o, d, *t, lo, hi), reps=2))
            row.setdefault(k, []).append(ms)
        for k, t in trees.items():
            box, mt, _ = kernels.traverse_tests(o, d, *t, zero, hi, False)
            row[k + "_tests_per_ray"] = (float(box.double().mean()), float(mt.double().mean()))
        out[tag] = row
        print(tag, json.dumps(row), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
