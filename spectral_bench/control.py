#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place, its path state held in bfloat16 between bounces (the precision below
the float32 the configuration states), judged by the cell's limits as a
run of the port is.  A sound comparison finds it not correct.

    python3 spectral_bench/control.py --workload <cell> --seed <n> [--seconds 1]

A frame cell: the frames driver runs with the control in the port's place
and prints the run's readings.  The control renders only what the
comparison reads: the sampled pixels of each frame, and for the frame's ray
total an estimate from as many other pixels drawn from the seed.

An inverse-rendering cell: the readings of the control's first step, and
of faults planted in the reference put in the program's place (half of
the samples, the mean over the rest; the loss altered by one part in a
thousand where it is produced; the step's sign flipped; a step left out),
each against the reference.  The reference in the program's place takes
Adam's first step of its own gradient.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spectral_bench.drivers import frames  # noqa: E402
from spectral_bench.harness import compare, manifest, runner  # noqa: E402
from spectral_bench.reference import scenes, tracer  # noqa: E402


class ControlFrames:
    """Frames of the reference at a lower precision, at the pixels the
    comparison samples."""

    def __init__(self, cell, root, device, seed, state_dtype=torch.bfloat16):
        self.rc = frames.ref_config(cell)
        self.cfg = self.rc
        self.scene = scenes.scene_from_spec(cell.config["scene"], root, device)
        n = self.rc.width * self.rc.height
        w, h, k = self.rc.width, self.rc.height, cell.traffic["check_pixels"]
        _, pix, _ = frames.draws(seed, w, h, k)
        _, other, _ = frames.draws(seed + 1, w, h, k)
        self.pix = torch.as_tensor(pix, device=device)
        self.other = torch.as_tensor(other, device=device)
        self.n, self.dtype, self.device = n, state_dtype, device
        self.scene_load_s = 0.0

    def frame(self, ts):
        rad, _ = tracer.render_pixels(self.scene, self.rc, self.pix, ts, state_dtype=self.dtype)
        _, rays = tracer.render_pixels(self.scene, self.rc, self.other, ts,
                                       state_dtype=self.dtype)
        img = torch.zeros((self.n, 3), dtype=torch.float32, device=self.device)
        img[self.pix] = rad / self.rc.spp
        return img, float(rays.double().mean()) * self.n

    def close(self):
        del self.scene


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if cell.traffic["driver"] == "invert":
        return invert_readings(cell, args.seed, args.device)
    program = ControlFrames(cell, manifest.ROOT, args.device, args.seed)
    run = frames.run(cell, seed=args.seed, seconds=args.seconds, traced=False,
                     device=args.device, t_start=time.time(), program=program)
    out = dict(workload=cell.name, seed=args.seed, control="bfloat16 path state",
               correct=all(ok for *_, ok in run.checks),
               checks={n: dict(value=v, limit=lim) for n, v, lim, _ in run.checks})
    print(json.dumps(out), flush=True)
    return 0


def invert_readings(cell, seed: int, device) -> int:
    from spectral_bench.drivers import invert

    target, p0 = invert.inputs(cell, manifest.ROOT, seed, device)
    ts = int(np.random.default_rng(seed).integers(0, 1 << 31))
    lr = float(cell.traffic["lr"])
    params = p0.cpu().numpy()
    ref = invert.reference_step(cell, manifest.ROOT, device, target, params, ts)[:3]
    loss, g, step = ref
    half = dict(cell.traffic, job=dict(cell.traffic["job"], spp=cell.traffic["job"]["spp"] // 2))
    runs = dict(
        control=invert.reference_step(cell, manifest.ROOT, device, target, params, ts,
                                      state_dtype=torch.bfloat16)[:3],
        half_samples=invert.reference_step(dataclasses.replace(cell, traffic=half), manifest.ROOT,
                                           device, target, params, ts)[:3],
        loss_altered=(loss * 1.001, g, step),
        sign_flipped=(loss, g, -step),
        step_left_out=(loss, g, torch.zeros_like(step)))
    for name, (l_c, g_c, s_c) in runs.items():
        numbers = invert.numbers(l_c, [g_c], [s_c], loss, g, step, lr)
        checks = compare.judge(numbers, cell.limits)
        print(json.dumps(dict(workload=cell.name, seed=seed, control=name,
                              correct=all(ok for *_, ok in checks),
                              checks={n: dict(value=v, limit=lim) for n, v, lim, _ in checks})),
              flush=True)
    return 0


if __name__ == "__main__":
    runner.cache_env(manifest.ROOT)
    sys.exit(main())
