"""Frozen copy of gpuspectral_tpu_torch/ops/rng.py for the benchmark's plain
reference (imports nothing of the port).  The original's docstring:

Counter-based PCG random numbers (port of gpuspectral_tpu/ops/rng.py).

A uniform is a pure function of (pixel_seed, bounce, channel): the same
PCG-RXS-M-XS output permutation and TEA seed mix as the reference, drawn
by counter so that draws are order-free and replay is exact.  There is no
torch.Generator on the render path.

torch has no usable uint32 arithmetic on the CPU (no +, >>, ^ or %), so a
uint32 value is carried in an int64 tensor holding [0, 2^32) and every
wrapping operation is masked with `& 0xFFFFFFFF`.  Products by a 32-bit
constant are split into 16-bit halves (`_mul32`) so no int64 intermediate
overflows.  Results are bit-equal to the JAX uint32 versions.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# Constants from the reference PCG (pt_common.glsl:87-100).
_PCG_MULT = 747796405
_PCG_INC = 2891336453
_PCG_XSH_MULT = 277803737

_INV_U32_MAX = float(1.0 / 4294967295.0)  # reference: randPcg * (1/0xffffffff)


def as_u32(x, device=None) -> torch.Tensor:
    """int64 tensor holding the uint32 value(s) of `x` (tensor or int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _mul32(a, k: int):
    """(a * k) mod 2^32 for a in [0, 2^32) and a constant k < 2^32."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg_hash(v):
    """PCG-RXS-M-XS hash of a uint32 (reference pt_common.glsl:95-100)."""
    v = as_u32(v)
    state = (_mul32(v, _PCG_MULT) + _PCG_INC) & _M32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, _PCG_XSH_MULT)
    return (word >> 22) ^ word


def tea(val0, val1, rounds: int = 4):
    """TEA seed scrambler (reference pt_common.glsl:106-120)."""
    dev = val0.device if isinstance(val0, torch.Tensor) else (
        val1.device if isinstance(val1, torch.Tensor) else None)
    v0, v1 = torch.broadcast_tensors(as_u32(val0, dev), as_u32(val1, dev))
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & _M32) ^ ((v1 + s0) & _M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & _M32))) & _M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & _M32) ^ ((v0 + s0) & _M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & _M32))) & _M32
    return v0


def pixel_seed(pixel_index, timestamp):
    """Per-pixel stream seed, matching raygen.rgen:37:
    ``pcgHash(tea(width*y + x, timestamp))``."""
    return pcg_hash(tea(pixel_index, timestamp))


def random_bits(seed, bounce, channel):
    """Counter-based uint32 draw: pure function of (seed, bounce, channel)."""
    s = as_u32(seed)
    b = as_u32(bounce, s.device)
    c = as_u32(channel, s.device)
    return pcg_hash(s ^ pcg_hash((_mul32(b, 0x9E3779B9) + c + 1) & _M32))


def uniform(seed, bounce, channel):
    """U[0,1) float32 draw (reference randUniform: bits * 1/0xffffffff)."""
    return random_bits(seed, bounce, channel).to(torch.float32) * _INV_U32_MAX
