"""Inverse rendering: diff/invert.invert (Adam on the BSDF table through
the fused-gradient kernel K5) called in chunks of a fixed number of steps,
each chunk starting from the parameters the last one returned.

Traffic parameters: "job" (width, height, spp, max_depth), "lr",
"chunk_steps" (steps a call of invert in the window) and "first_steps"
(the set-up's first call).  The target image and the starting parameters
are made on the device from the seed (`inputs`); the port gets them as
invert takes them, in host memory.  invert builds its Adam afresh at each
call (the port's interface), so a chunk restarts the moments.

`correct`: one chunk of the window, drawn from the seed among the first
HOOKED_CHUNKS, runs with torch.optim's global step hooks on, which read
each step's gradient as Adam gets it and the parameters before and after
each step.  The reference works out that chunk's first step at the
parameters the chunk was handed: its loss, its gradient's norm, and the
descent of the program's first change along the reference's gradient
against that of Adam's first step (a signed number: a step or a gradient
with its sign flipped reads 2, a step left out 1).  A plain Adam fed the
program's own gradients follows every step of the chunk (the gradients of
steps 2 on come from the same kernel as step 1's, which the reference
checks), so Adam's moments are held to the program's updates.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..harness import port, profile, roofline
from ..harness.runner import Run
from ..reference import grad as ref_grad
from ..reference import scenes, tracer

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # torch.optim.Adam's defaults, which invert keeps
HOOKED_CHUNKS = 4  # the chunk the comparison follows is one of the window's first four


def inputs(cell, root, seed: int, device):
    """(target (H, W, 3), starting BSDF table) from the seed, handed alike
    to the port and the reference: a uniform random target image, and the
    configuration's BSDF table (as the reference reads it) with each
    diffuse row's albedo uniform in [0.1, 0.9], drawn with a torch.Generator
    on the device."""
    rs = scenes.scene_from_spec(cell.config["scene"], root, device)
    params, kinds = rs.bsdf_params, rs.bsdf_kind
    height, width = cell.traffic["job"]["height"], cell.traffic["job"]["width"]
    g = torch.Generator(device=device)
    g.manual_seed(seed & ((1 << 63) - 1))
    target = torch.rand((height, width, 3), generator=g, device=device)
    p0 = params.clone()
    rows = torch.nonzero(kinds == 0)[:, 0]
    p0[rows, 0:3] = 0.1 + 0.8 * torch.rand((rows.numel(), 3), generator=g, device=device)
    return target, p0


class PortInvert:
    """The system under test: the port's scene and its invert call."""

    def __init__(self, cell, root, device, target, p0):
        self.cfg = port.render_config(cell.config.get("render", {}), cell.traffic["job"])
        self.lr = float(cell.traffic["lr"])
        t = time.perf_counter()
        self.scene = port.load_scene(cell.config["scene"], root, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.scene_load_s = time.perf_counter() - t
        self.target_host = target.cpu().numpy()
        self.params = p0.cpu().numpy()

    def chunk(self, steps: int, timestamp0: int) -> list:
        from gpuspectral_tpu_torch.diff.invert import invert

        params, history = invert(self.scene, self.target_host, self.cfg, steps=steps,
                                 lr=self.lr, init_params=self.params, timestamp0=timestamp0)
        self.params = params.detach().cpu().numpy()
        return history

    def close(self):
        del self.scene


class StepHooks:
    """torch.optim's global hooks while on: each step's gradient as the
    optimizer gets it and the parameters after the step (copies)."""

    def __init__(self):
        self.grads, self.before, self.after = [], [], []

    def __enter__(self):
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        def pre(opt, args, kwargs):
            params = [p for g in opt.param_groups for p in g["params"]]
            self.grads.append([p.grad.detach().clone() for p in params])
            self.before.append([p.detach().clone() for p in params])

        def post(opt, args, kwargs):
            self.after.append([p.detach().clone() for g in opt.param_groups for p in g["params"]])

        self.handles = [register_optimizer_step_pre_hook(pre),
                        register_optimizer_step_post_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def reference_step(cell, root, device, target, params, ts, tally=None, state_dtype=None):
    """The reference's (loss, gradient, Adam's first step) of a step of
    invert from the BSDF table `params` at timestamp `ts`."""
    from .frames import ref_config

    rc = ref_config(cell)
    rs = scenes.scene_from_spec(cell.config["scene"], root, device)
    kinds = rs.bsdf_kind.cpu().numpy()
    mask = torch.as_tensor(ref_grad.optimizable_mask(kinds), dtype=torch.float32, device=device)
    lo, hi = (torch.as_tensor(x, device=device) for x in ref_grad.param_bounds(kinds))
    u0 = ref_grad.to_unconstrained(torch.as_tensor(params, device=device), lo, hi)
    loss, g = ref_grad.loss_and_grad(rs, rc, u0, lo, hi, mask, target, ts, tally, state_dtype)
    step = -float(cell.traffic["lr"]) * g / (g.abs() + ADAM_EPS)
    return loss, g, step, rs


def plain_adam(grads, lr: float) -> list:
    """The updates of a plain Adam (float64, torch.optim.Adam's defaults)
    fed `grads` one step after another."""
    (b1, b2), m, v, out = ADAM_BETAS, 0.0, 0.0, []
    for k, g in enumerate(grads, 1):
        g = g.double()
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        out.append(-lr * (m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k)) + ADAM_EPS))
    return out


def gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def numbers(loss: float, grads: list, updates: list, loss_ref: float, g_ref, step_ref,
            lr: float) -> dict:
    """The compared numbers of a chunk: its first loss, each step's gradient
    as Adam got it and each step's change of the parameters, against the
    reference's loss, gradient and Adam step at the chunk's start.

      loss_gap     the first loss's gap to the reference's
      grad_gap     the gap between the first gradient's norm and the reference's
      descent_gap  |1 - <first change, g_ref> / <Adam's step of g_ref, g_ref>|
      adam_gap     the worst step's |change - plain Adam's| / |plain Adam's|,
                   the plain Adam fed the program's own gradients
    """
    g_ref = g_ref.double()
    along = float((updates[0].double() * g_ref).sum()) / float((step_ref.double() * g_ref).sum())
    adam = plain_adam(grads, lr)
    return dict(
        loss_gap=gap(loss, loss_ref),
        grad_gap=gap(float(torch.linalg.norm(grads[0].double())), float(torch.linalg.norm(g_ref))),
        descent_gap=abs(1.0 - along),
        adam_gap=float(torch.stack([torch.linalg.norm(d.double() - a) / torch.linalg.norm(a)
                                    for d, a in zip(updates, adam)]).max()))  # a NaN propagates


def run(cell, seed, seconds, traced, device, t_start, program=None, root=None) -> Run:
    from ..harness.manifest import ROOT

    root = root or ROOT
    out = Run(cell=cell, seed=seed, traced=traced)
    target, p0 = inputs(cell, root, seed, device)
    if program is None:
        if torch.device(device).type == "cuda":
            port.build_kernels()
        program = PortInvert(cell, root, device, target, p0)
    out.scene_load_s = program.scene_load_s
    spp = program.cfg.spp
    draw = np.random.default_rng(seed)
    base = int(draw.integers(0, 1 << 31))
    hooked = int(draw.integers(0, HOOKED_CHUNKS))
    first, per_chunk = int(cell.traffic["first_steps"]), int(cell.traffic["chunk_steps"])
    program.chunk(first, base)
    out.setup_s = time.time() - t_start

    done = first
    times, steps = [], []
    prof = {}
    with profile.traced(traced, "bench.chunk", prof):
        t0 = time.perf_counter()
        while True:
            ts = base + done * spp
            t = time.perf_counter()
            with torch.profiler.record_function("bench.chunk"):
                if len(times) == hooked:
                    start = np.array(program.params, copy=True)
                    with StepHooks() as hooks:
                        losses = program.chunk(per_chunk, ts)
                    start_ts = ts
                else:
                    program.chunk(per_chunk, ts)
            t1 = time.perf_counter()
            times.append(t1 - t)
            steps.append(per_chunk)
            done += per_chunk
            if t1 - t0 >= seconds and len(times) > hooked:
                break
    out.window_s = t1 - t0
    out.unit_s = [dt / n for dt, n in zip(times, steps) for _ in range(n)]
    out.unit_work = [float(n) for n in steps]
    out.attempted = sum(steps)
    out.trace = prof["trace"]
    if out.trace is not None:
        out.extra["units_traced"] = sum(steps)
    if torch.device(device).type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    grads = [g[0] for g in hooks.grads]
    updates = [a[0] - b[0] for a, b in zip(hooks.after, hooks.before)]
    program.close()
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    tally = tracer.Tally() if traced else None
    loss_ref, g_ref, step_ref, rs = reference_step(cell, root, device, target, start, start_ts,
                                                   tally)
    out.extra["numbers"] = numbers(float(losses[0]), grads, updates, loss_ref, g_ref, step_ref,
                                   float(cell.traffic["lr"]))
    from ..harness import compare

    out.checks = compare.judge(out.extra["numbers"], cell.limits)
    if tally is not None:
        n_pix = cell.traffic["job"]["width"] * cell.traffic["job"]["height"]
        n_rows, n_l = rs.bsdf_kind.shape[0], rs.num_lights
        out.counts["brute"] = dict(
            flops=tally.woop_tests * roofline.WOOP_FLOPS + tally.hits * roofline.SHADE_FLOPS,
            bytes=n_pix * (roofline.LANE_BYTES + 4 * (3 * n_rows + 6 * n_l))
            + rs.num_tris * (12 + 33) * 4 + n_l * 48)
    return out
