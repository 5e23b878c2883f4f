"""Time K7h (gpuspectral_tpu_torch/csrc/traverse.cu) at each launch shape and
walk of its design, on the sphere field.

    PYTHONPATH=. python3 tools/torch_traverse_variants.py [variant ...]

A variant sets the four constants at the top of csrc/traverse.cu:

  cta_unmerged one CTA of 1,024 threads a packet, one ray a thread, a vote
               on each node as it is reached (PR 8's walk with the empty
               subtrees skipped: a barrier per node)
  cta          the same with the children and grandchildren voted behind
               one barrier, leaf rows staged in shared memory by the
               reduction that voted on them
  cta_x2       cta at 512 threads a CTA, two rays a thread
  cluster2     a thread block cluster of 2 CTAs x 512 threads a packet, the
               votes through distributed shared memory and the cluster
               barrier
  cluster4     a cluster of 4 CTAs x 256 threads
  cluster8     a cluster of 8 CTAs x 128 threads (the shipped shape)
  cluster8_x2  a cluster of 8 CTAs x 64 threads, two rays a thread
  cluster8_unmerged     cluster8 with a vote on each node as it is reached
  cluster8_global_rows  cluster8 with the leaf rows read from global memory

Each variant's copy of the source goes to build/traverse_variants/<name>/
and is compiled by tools/torch_variants.py (the flags of
gpuspectral_tpu_torch/_build.py, one nvcc per variant, all started
together; ptxas's registers and spills printed).
On chip_smoke.py's 65,536 random rays and the 262,144 primary rays of the
512x512 frame, at the CLI's packets of 1,024, each variant's closest and
any hit must equal PR 8's walk (gst_traverse_count, which chip_smoke.py
holds to the plain version) on the tree as built, output for output; then
every variant is timed with CUDA events, in order and again in reverse
order, beside PR 8's walk on the tree as built and on the tree with its
empty subtrees' boxes NaN (kernels.nan_empty; that walk's timings include
its counters).  One JSON line per rays set.  Needs a CUDA device and nvcc.
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
from gpuspectral_tpu_torch.bvh import kernels  # noqa: E402
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field  # noqa: E402

CTA = dict(kClusterCtas="1", kRaysPerThread="1", kMergedVotes="true", kStageLeaves="true")
CLUSTER8 = dict(CTA, kClusterCtas="8")
VARIANTS = dict(
    cta_unmerged=dict(CTA, kMergedVotes="false"),
    cta=CTA,
    cta_x2=dict(CTA, kRaysPerThread="2"),
    cluster2=dict(CTA, kClusterCtas="2"),
    cluster4=dict(CTA, kClusterCtas="4"),
    cluster8=CLUSTER8,
    cluster8_x2=dict(CLUSTER8, kRaysPerThread="2"),
    cluster8_unmerged=dict(CLUSTER8, kMergedVotes="false"),
    cluster8_global_rows=dict(CLUSTER8, kStageLeaves="false"),
)
ENTRY_POINTS = ("gst_traverse_closest", "gst_traverse_any", "gst_traverse_shape")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_traverse_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    dev = torch.device("cuda")
    smi = tv.card()
    print(smi, flush=True)
    libs = tv.build("traverse_variants",
                    {name: tv.variant_sources(("traverse.cu",), VARIANTS[name]) for name in names},
                    ENTRY_POINTS, show=lambda kern: "packet_kernel" in kern)
    field = build_sphere_field(dev)
    tree = chip_smoke.traverse_tree(field)
    nodes = kernels.pack_nodes(*tree[1:3], tree[0])
    nan_tree = (tree[0], *kernels.nan_empty(*tree[1:3]), tree[3])
    for tag, (o, d, lo, hi) in (
            ("random", chip_smoke.field_rays(chip_smoke.K3_RAYS["parity"], field, 20, dev)),
            ("primary", chip_smoke.primary_rays(field, chip_smoke.HEADLINE["size"], dev))):
        zero = torch.zeros_like(hi)
        ref_c = kernels.traverse_tests(o, d, *tree, zero, hi, False)[2]
        ref_a = kernels.traverse_tests(o, d, *tree, lo, hi, True)[2]

        def closest():
            return kernels.traverse_closest(o, d, *tree, zero, hi, nodes=nodes)

        def any_hit():
            return kernels.traverse_any(o, d, *tree, lo, hi, nodes=nodes)

        calls = {}
        for name, lib in libs.items():
            with tv.launching(lib):
                got, occ = closest(), any_hit()
            if not (all(torch.equal(a, b) for a, b in zip(got, ref_c)) and torch.equal(occ, ref_a)):
                raise AssertionError(f"{name}: K7h differs from the counting walk on {tag} rays")
            calls[name] = (lib, closest, any_hit)
        for name, t in (("pr8_walk", tree), ("pr8_walk_nan_empty", nan_tree)):
            calls[name] = (
                None,
                lambda t=t: kernels.traverse_tests(o, d, *t, zero, hi, False),
                lambda t=t: kernels.traverse_tests(o, d, *t, lo, hi, True))
        times = {name: dict(closest=[], any=[]) for name in calls}
        order = list(calls)
        for name in order + order[::-1]:
            lib, c, a = calls[name]
            with tv.launching(lib):
                times[name]["closest"].append(chip_smoke.cuda_ms(c, reps=5))
                times[name]["any"].append(chip_smoke.cuda_ms(a, reps=5))
        shapes = {}
        for name, lib in libs.items():
            with tv.launching(lib):
                shapes[name] = kernels.launch_shape(1024)
        print(json.dumps(dict(rays=tag, n_rays=o.shape[0], packet=1024, card=smi,
                              ms=times, launch_shape=shapes)), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
