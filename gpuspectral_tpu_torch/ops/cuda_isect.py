"""K2: the brute-force closest-hit / any-hit kernels (csrc/isect.cu).

The counterpart of gpuspectral_tpu/ops/pallas_isect.py: the same arguments
as `closest_pallas` / `any_pallas` and the same results, over the first
`n_rows` slots of the table (default: every slot).  The callers pass the
scene's `tri_rows`, past which every row is zero and never hit, so the cut
changes no result.  For CPU tensors the wrappers run the plain torch
versions, `closest_ref` / `any_ref` (ops/woop.py scans); for CUDA tensors
they launch the kernel or raise.  Each wrapper counts its kernel launches
in utils.profiling (`closest_cuda.launch`, `any_cuda.launch`).

`closest_diff` is the differentiable closest hit of the wavefront
(path_tracer.py:_brute_vjp): K2a forward, and a backward that re-evaluates
each ray's hit triangle's Woop test in plain torch (woop_eval_rows).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import woop

LANE = 128  # the Woop table's triangle count is a multiple of this


def closest_ref(origin, direction, woop_t, t_min, t_max, n_rows=None):
    """Plain torch version of closest_cuda: (t, prim)."""
    w = woop_t[:, :n_rows].t()
    if w.shape[0] == 0:
        r = origin.shape[0]
        return (torch.full((r,), woop._BIG, dtype=torch.float32, device=origin.device),
                torch.full((r,), -1, dtype=torch.int32, device=origin.device))
    t, prim, _, _ = woop.closest_scan(origin, direction, w, t_min, t_max)
    return t, prim


def any_ref(origin, direction, woop_t, t_min, t_max, n_rows=None):
    """Plain torch version of any_cuda: occluded flags."""
    return woop.any_scan(origin, direction, woop_t[:, :n_rows].t(), t_min, t_max)


def _check(origin, direction, woop_t, t_min, t_max, n_rows):
    """n_rows, checked: the slots tested (default every slot of woop_t)."""
    r = origin.shape[0]
    dev = origin.device
    for name, x, shape in (
        ("origin", origin, (r, 3)), ("direction", direction, (r, 3)),
        ("t_min", t_min, (r,)), ("t_max", t_max, (r,)),
    ):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (woop_t.device != dev or woop_t.dtype != torch.float32 or woop_t.dim() != 2
            or woop_t.shape[0] != 12 or woop_t.shape[1] % LANE or not woop_t.is_contiguous()):
        raise ValueError("woop_t: want a contiguous float32 (12, T) table, T % 128 == 0, "
                         f"on {dev}; got {woop_t.dtype} {tuple(woop_t.shape)} on {woop_t.device}")
    slots = woop_t.shape[1]
    n_rows = slots if n_rows is None else n_rows
    if not 0 <= n_rows <= slots:
        raise ValueError(f"n_rows: want 0 <= n_rows <= {slots} (the table's slots), got {n_rows}")
    return int(n_rows)


def closest_cuda(origin, direction, woop_t, t_min, t_max, n_rows=None):
    """Closest hit over the first n_rows triangles (default all) of the
    transposed (12, T) Woop table.
    Returns (t (R,) float32, 1e30 on a miss; prim (R,) int32, -1 on a miss)."""
    n_rows = _check(origin, direction, woop_t, t_min, t_max, n_rows)
    if origin.device.type == "cpu":
        return closest_ref(origin, direction, woop_t, t_min, t_max, n_rows)
    if origin.device.type != "cuda":
        raise ValueError(f"closest_cuda: unsupported device {origin.device}")
    from .. import _build

    lib = _build.load()
    r = origin.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=origin.device)
    prim = torch.empty((r,), dtype=torch.int32, device=origin.device)
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_closest(origin.data_ptr(), direction.data_ptr(), woop_t.data_ptr(),
                             woop_t.shape[1], n_rows, t_min.data_ptr(), t_max.data_ptr(), r,
                             t.data_ptr(), prim.data_ptr(), stream)
    _build.check(rc, "closest_cuda")
    profiling.count("closest_cuda.launch")
    return t, prim


def any_cuda(origin, direction, woop_t, t_min, t_max, n_rows=None):
    """Any-hit: True where one of the first n_rows triangles (default all)
    lies strictly inside (t_min, t_max)."""
    n_rows = _check(origin, direction, woop_t, t_min, t_max, n_rows)
    if origin.device.type == "cpu":
        return any_ref(origin, direction, woop_t, t_min, t_max, n_rows)
    if origin.device.type != "cuda":
        raise ValueError(f"any_cuda: unsupported device {origin.device}")
    from .. import _build

    lib = _build.load()
    r = origin.shape[0]
    occ = torch.empty((r,), dtype=torch.bool, device=origin.device)
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_any(origin.data_ptr(), direction.data_ptr(), woop_t.data_ptr(),
                         woop_t.shape[1], n_rows, t_min.data_ptr(), t_max.data_ptr(), r,
                         occ.data_ptr(), stream)
    _build.check(rc, "any_cuda")
    profiling.count("any_cuda.launch")
    return occ


def woop_eval_rows(rows, o, d):
    """Woop test of each ray against its own triangle row, rows (R, 12):
    (t, u, v), differentiable in (o, d) (bvh/dfs_sweep.py:_woop_eval_rows)."""
    ax, ay, az = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    bx, by, bz = rows[:, 9], rows[:, 10], rows[:, 11]
    opz = (o * az).sum(-1) + bz
    dpz = (d * az).sum(-1)
    live = torch.abs(dpz) > 1e-12
    t = -opz / torch.where(live, dpz, 1.0)
    p = o + t[:, None] * d
    return t, (p * ax).sum(-1) + bx, (p * ay).sum(-1) + by


def woop_vjp(o, d, prim, woop_rows, ct_t, ct_u, ct_v):
    """(d origin, d direction) of the hit (t, u, v) for cotangents ct_*:
    the vjp of woop_eval_rows at each ray's hit triangle; misses get zero."""
    hit = prim >= 0
    rows = woop_rows[torch.clamp(prim, min=0).long()]
    zero = torch.zeros_like(ct_t)
    with torch.enable_grad():
        oo = o.detach().requires_grad_(True)
        dd = d.detach().requires_grad_(True)
        t, u, v = woop_eval_rows(rows, oo, dd)
        return torch.autograd.grad(
            (t, u, v), (oo, dd),
            (torch.where(hit, ct_t, zero), torch.where(hit, ct_u, zero),
             torch.where(hit, ct_v, zero)), allow_unused=True)


class _ClosestDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, origin, direction, t_max, woop_t, woop_rows, n_rows):
        zeros = torch.zeros_like(t_max)
        t, prim = closest_cuda(origin, direction, woop_t, zeros, t_max, n_rows)
        bu, bv = woop._recover_uv(origin, direction, woop_rows, prim,
                                  torch.where(prim >= 0, t, 0.0))
        bu = torch.where(prim >= 0, bu, 0.0)
        bv = torch.where(prim >= 0, bv, 0.0)
        ctx.save_for_backward(origin, direction, prim, woop_rows)
        ctx.mark_non_differentiable(prim)
        return t, prim, bu, bv

    @staticmethod
    def backward(ctx, ct_t, _ct_prim, ct_u, ct_v):
        o, d, prim, woop_rows = ctx.saved_tensors
        do, dd = woop_vjp(o, d, prim, woop_rows, ct_t, ct_u, ct_v)
        return do, dd, None, None, None, None


def closest_diff(origin, direction, woop_t, woop_rows, t_max, n_rows=None):
    """Closest hit with exact (t, u, v) gradients w.r.t. (origin, direction)
    (path_tracer.py:_brute_closest_diff).  woop_t (12, T) is K2a's table,
    woop_rows (T, 12) the same rows for the backward; both are detached.
    n_rows as for closest_cuda.
    Returns (t, prim, u, v): t = 1e30, prim = -1 and u = v = 0 on a miss."""
    return _ClosestDiff.apply(origin, direction, t_max.detach().contiguous(),
                              woop_t.detach(), woop_rows.detach(), n_rows)
