"""Frozen copy of gpuspectral_tpu_torch/ops/math3d.py for the benchmark's plain
reference (imports nothing of the port).  The original's docstring:

Vectorized 3D math helpers (port of gpuspectral_tpu/ops/math3d.py).

Vectors are tensors whose last axis has size 3.  Dot and cross products are
written as explicit component products, in the reference's operand order,
rather than as reductions or matmuls: no TF32, and the same rounding on
every backend.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def sqrt(x):
    """Correctly rounded float32 sqrt.  torch's vectorized CPU float32 sqrt
    is not (about 1 result in 6 is off by an ulp on an AVX-512 host), and
    near cancellations such as sqrt(1 - cos^2) amplify that ulp; taken in
    float64 and rounded once it is exact, as XLA's and CUDA's sqrtf are."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def fma(a, b, c):
    """a * b + c with one rounding, as a fused multiply-add computes it
    (XLA contracts the JAX package's multiply-adds into FMAs; the CUDA
    kernels call fmaf at the same places).  The float32 product is exact in
    float64; the float64 sum rounded to float32 equals the fused result
    except in double-rounding cases (about one operation in 2^29)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def cross_fma(a, b):
    """The cross product as XLA-CPU contracts jnp.cross: each component
    a1*b2 - a2*b1 as fma(a1, b2, -(a2*b1))."""
    return torch.stack([fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                        fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                        fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))], dim=-1)


def dot_fma(x, y):
    """A 3-term dot product as XLA-CPU contracts a jitted sum of products:
    fma(x2, y2, fma(x1, y1, x0*y0))."""
    return fma(x[..., 2], y[..., 2], fma(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))


def length(v):
    return sqrt(torch.clamp(dot(v, v), min=1e-24))


def normalize(v):
    return v / torch.clamp(length(v), min=EPS)[..., None]


def safe_div(a, b, eps: float = EPS):
    """a/b with sign-preserving clamp of |b| away from zero."""
    mag = torch.clamp(torch.abs(b), min=eps)
    return a / torch.where(b < 0, -mag, mag)


def faceforward(n, i, nref):
    """GLSL faceforward: n if dot(nref, i) < 0 else -n."""
    return torch.where(dot(nref, i)[..., None] < 0.0, n, -n)


def reflect_local(wo):
    """Mirror reflection about the local z axis (shading frame)."""
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def onb_create(n):
    """Orthonormal basis from a normal (pt_common.glsl:128-143).
    Returns (tangent, binormal, normal)."""
    n = normalize(n)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zeros = torch.zeros_like(nx)
    b_a = torch.stack([-ny, nx, zeros], dim=-1)  # |n.x| > |n.z| branch
    b_b = torch.stack([zeros, -nz, ny], dim=-1)
    b = torch.where((torch.abs(nx) > torch.abs(nz))[..., None], b_a, b_b)
    b = normalize(b)
    t = cross(b, n)
    return t, b, n


def onb_world_to_local(t, b, n, v):
    """World -> shading frame (onbTransform)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def onb_local_to_world(t, b, n, v):
    """Shading frame -> world (onbUntransform)."""
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def is_finite3(v):
    return torch.all(torch.isfinite(v), dim=-1)
