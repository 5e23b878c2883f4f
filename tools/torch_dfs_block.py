"""Time K7f / K7g (gpuspectral_tpu_torch/csrc/dfs.cu) at several CTA sizes.

    PYTHONPATH=. python3 tools/torch_dfs_block.py [32 64 128 256]

For each size B the script builds a copy of csrc/dfs.cu with kBlock = B
(nvcc, the flags of gpuspectral_tpu_torch/_build.py) into
build/dfs_block/B/, holds the kernels against the plain walk at block=B
(dfs_sweep.dfs_closest_ref / dfs_any_ref: every output equal), and times
them with CUDA events on the sphere field (builtin:sphere_field, 147,460
triangles) over 65,536 random rays and the 262,144 primary rays of the
512x512 frame, chip_smoke.py's rays, beside the Woop and box tests per ray
that the walk makes at that block size.  One JSON line per (size, rays).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gpuspectral_tpu_torch import _build  # noqa: E402
from gpuspectral_tpu_torch.bvh import dfs_sweep as ds  # noqa: E402
from gpuspectral_tpu_torch.scene.zoo import build_sphere_field  # noqa: E402

SOURCE_BLOCK = "constexpr int kBlock = 32;"


def build(block: int):
    """The kernel library with kBlock = block, loaded with ctypes."""
    out = ROOT / "build" / "dfs_block" / str(block)
    out.mkdir(parents=True, exist_ok=True)
    src = (_build._CSRC / "dfs.cu").read_text()
    if SOURCE_BLOCK not in src:
        raise RuntimeError(f"csrc/dfs.cu no longer declares {SOURCE_BLOCK!r}")
    (out / "dfs.cu").write_text(src.replace(SOURCE_BLOCK, f"constexpr int kBlock = {block};"))
    so = out / "libdfs.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-I", str(_build._CSRC),
                    str(out / "dfs.cu"), "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name in ("gst_dfs_closest", "gst_dfs_any"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_dfs_block: no CUDA device", file=sys.stderr)
        return 1
    blocks = [int(x) for x in argv] or [32, 64, 128, 256]
    dev = torch.device("cuda")
    field = build_sphere_field(dev)
    rays = dict(random=chip_smoke.field_rays(chip_smoke.K3_RAYS["parity"], field, 20, dev),
                primary=chip_smoke.primary_rays(field, chip_smoke.HEADLINE["size"], dev))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    real_load = _build.load
    try:
        for block in blocks:
            lib = build(block)
            _build.load = lambda lib=lib: lib  # the wrappers launch this build
            for tag, (o, d, lo, hi) in rays.items():
                got = ds.dfs_closest(field, o, d, t_max=hi)
                occ = ds.dfs_any(field, o, d, lo, hi)
                ref = ds.dfs_closest_ref(field, o, d, t_max=hi, block=block)
                occ_ref = ds.dfs_any_ref(field, o, d, lo, hi, block=block)
                equal = all(torch.equal(a, b) for a, b in zip(got, ref)) and torch.equal(occ,
                                                                                          occ_ref)
                if not equal:
                    raise AssertionError(f"kBlock {block}: K7f / K7g differ from the plain walk")
                tests = {}
                for key, any_hit, t_min in (("closest", False, torch.zeros_like(hi)),
                                            ("any", True, lo)):
                    _, boxes, woops = ds._walk(field, o, d, t_min, hi, any_hit, block, True)
                    tests[key] = dict(box_per_ray=float(boxes.double().mean()),
                                      woop_per_ray=float(woops.double().mean()))
                print(json.dumps(dict(
                    block=block, rays=tag, n_rays=o.shape[0], card=smi,
                    k7f_ms=chip_smoke.cuda_ms(lambda: ds.dfs_closest(field, o, d, t_max=hi),
                                              reps=5),
                    k7g_ms=chip_smoke.cuda_ms(lambda: ds.dfs_any(field, o, d, lo, hi), reps=5),
                    tests=tests)), flush=True)
    finally:
        _build.load = real_load
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
