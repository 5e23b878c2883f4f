"""Time the block-gated BVH kernels at several CTA sizes: K7f / K7g
(gpuspectral_tpu_torch/csrc/dfs.cu) or K7a / K7b (csrc/binned.cu).

    PYTHONPATH=. python3 tools/torch_dfs_block.py [dfs|binned] [32 64 128 256]

For each size B the script builds a copy of the kernels' source with
kBlock = B (tools/torch_variants.py: one nvcc a size, all started together)
into build/dfs_block/<family>/B/, holds the kernels against their plain versions
(dfs: the walk at block=B, dfs_sweep.dfs_closest_ref / dfs_any_ref; binned:
binned.binned_closest_ref / binned_any_ref, whose result does not hang on
the block), every output equal, and times them with CUDA events on the
sphere field (builtin:sphere_field, 147,460 triangles) over 65,536 random
rays and the 262,144 primary rays of the 512x512 frame, chip_smoke.py's
rays, beside the tests per ray that the kernels make at that block size
(dfs: box and Woop tests; binned: also the bins a CTA visits).  One JSON
line per (size, rays).  Needs a CUDA device and nvcc.
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
from gpuspectral_tpu_torch.bvh import dfs_sweep as ds  # noqa: E402
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field  # noqa: E402

def _dfs(field, o, d, lo, hi, block):
    """(outputs of K7f / K7g, of their plain versions at `block`, tests per ray)."""
    got = (*ds.dfs_closest(field, o, d, t_max=hi), ds.dfs_any(field, o, d, lo, hi))
    ref = (*ds.dfs_closest_ref(field, o, d, t_max=hi, block=block),
           ds.dfs_any_ref(field, o, d, lo, hi, block=block))
    tests = {}
    for key, any_hit, t_min in (("closest", False, torch.zeros_like(hi)), ("any", True, lo)):
        _, boxes, woops = ds._walk(field, o, d, t_min, hi, any_hit, block, True)
        tests[key] = dict(box_per_ray=float(boxes.double().mean()),
                          woop_per_ray=float(woops.double().mean()))
    return got, ref, tests


def _binned(field, o, d, lo, hi, block):
    """(outputs of K7a / K7b, of their plain versions, tests per ray at `block`)."""
    got = (*bn.binned_closest(field, o, d, t_max=hi), bn.binned_any(field, o, d, lo, hi))
    ref = (*bn.binned_closest_ref(field, o, d, t_max=hi), bn.binned_any_ref(field, o, d, lo, hi))
    tests = {}
    for key, any_hit, t_min in (("closest", False, torch.zeros_like(hi)), ("any", True, lo)):
        boxes, woops, visits, _ = bn.binned_tests(field, o, d, t_min, hi, any_hit, block)
        tests[key] = dict(box_per_ray=float(boxes.double().mean()),
                          woop_per_ray=float(woops.double().mean()),
                          visits_per_ray=float(visits.double().mean()))
    return got, ref, tests


# family -> (source, kernel entry points, parity and tests, the timed calls)
FAMILIES = dict(
    dfs=("dfs.cu", ("gst_dfs_closest", "gst_dfs_any"), _dfs,
         dict(k7f_ms=lambda f, o, d, lo, hi: ds.dfs_closest(f, o, d, t_max=hi),
              k7g_ms=lambda f, o, d, lo, hi: ds.dfs_any(f, o, d, lo, hi))),
    binned=("binned.cu", ("gst_binned_closest", "gst_binned_any"), _binned,
            dict(k7a_ms=lambda f, o, d, lo, hi: bn.binned_closest(f, o, d, t_max=hi),
                 k7b_ms=lambda f, o, d, lo, hi: bn.binned_any(f, o, d, lo, hi))),
)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_dfs_block: no CUDA device", file=sys.stderr)
        return 1
    family = argv.pop(0) if argv and argv[0] in FAMILIES else "dfs"
    blocks = [int(x) for x in argv] or [32, 64, 128, 256]
    _, _, check, timed = FAMILIES[family]
    dev = torch.device("cuda")
    field = build_sphere_field(dev)
    rays = dict(random=chip_smoke.field_rays(chip_smoke.K3_RAYS["parity"], field, 20, dev),
                primary=chip_smoke.primary_rays(field, chip_smoke.HEADLINE["size"], dev))
    smi = tv.card()
    source, names = FAMILIES[family][:2]
    libs = tv.build(f"dfs_block/{family}",
                    {str(b): tv.variant_sources((source,), dict(kBlock=str(b))) for b in blocks},
                    names, show=lambda kern: False)
    for block in blocks:
        with tv.launching(libs[str(block)]):
            for tag, (o, d, lo, hi) in rays.items():
                got, ref, tests = check(field, o, d, lo, hi, block)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{family} kBlock {block}: the kernels differ from "
                                         "their plain versions")
                times = {k: chip_smoke.cuda_ms(lambda fn=fn: fn(field, o, d, lo, hi), reps=5)
                         for k, fn in timed.items()}
                print(json.dumps(dict(family=family, block=block, rays=tag, n_rays=o.shape[0],
                                      card=smi, **times, tests=tests)), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
