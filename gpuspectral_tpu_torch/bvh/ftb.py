"""K3: BVH closest hit and any hit (csrc/bvh.cu, traversal in csrc/bvh.cuh).

The counterpart of gpuspectral_tpu/bvh/ftb.py: `ftb_closest` returns
(t, prim, u, v, attrs) and `ftb_any` the occlusion flags, with the same
`active`, `t_min` and `t_max` semantics (closest: t in (0, t_max), inactive
rays miss; any: t in (t_min, t_max), inactive rays are never occluded).
For CUDA tensors the wrappers launch the kernels (K3a, K3b) or raise, and
count their launches in utils.profiling; for CPU tensors they run the plain
versions, `ftb_closest_ref` / `ftb_any_ref`: the brute-force Woop scan over
every triangle slot that K2 is held to (ops/woop.py), chunked over slots so
that a 150k-slot scene fits in memory.  The kernel walks the scene's
child-pair rows (`walk_tables`, built once with the scene) and equals that
scan bit for bit, ties included (the lowest slot wins among exactly tied
t).

`ftb_closest_diff` is the differentiable closest hit of the BVH wavefront
(ftb.py:389-429): K3a forward (the plain version for CPU tensors), and the
backward of ops/cuda_isect.closest_diff, which re-evaluates each ray's hit
triangle's Woop test in plain torch; attrs are detached.

attrs are the fused shading rows of gpuspectral_tpu/bvh/dfs_sweep.py:
_attr_table, gathered by prim with a plain index: 9 corner normals,
geometric normal, area, packed meta (bsdf row + 4096 * (light idx + 1) +
2^23 * twofaced), and the 6 corner uvs when the scene is textured.
"""

from __future__ import annotations

import torch

from ..ops import math3d as m3
from ..ops import woop
from ..utils import profiling

_BIG = 1e30
_META_TWOFACED = float(1 << 23)
# elements per (rays x slots) intermediate of the plain scan
_REF_ELEMS = 1 << 23


def attr_table(scene) -> torch.Tensor:
    """(T, 14 | 20) fused attribute rows (dfs_sweep.py:_attr_table, row-major),
    bit for bit as the JAX package computes them outside jit: jnp.cross is
    jitted, so its components are fused multiply-adds (m3.cross_fma)."""
    t = scene.tri_pos.shape[0]
    e1 = scene.tri_pos[:, 1] - scene.tri_pos[:, 0]
    e2 = scene.tri_pos[:, 2] - scene.tri_pos[:, 0]
    cr = m3.cross_fma(e1, e2)
    crl = m3.sqrt(torch.clamp(m3.dot(cr, cr), min=1e-24))
    gn = cr / torch.clamp(crl, min=1e-12)[:, None]
    area = 0.5 * crl
    f32 = torch.float32
    meta = (scene.tri_bsdf.to(f32)
            + 4096.0 * (scene.tri_light_idx.to(f32) + 1.0)
            + _META_TWOFACED * scene.tri_twofaced.to(f32))
    cols = [scene.tri_nrm.reshape(t, 9), gn, area[:, None], meta[:, None]]
    if scene.has_textures:
        cols.append(scene.tri_uv.reshape(t, 6))
    return torch.cat(cols, dim=1)


def unpack_meta(meta_col):
    """Packed meta column -> (bsdf idx, light idx, twofaced).  The light
    field is floor(m / 4096), exact for these integers; the JAX package's
    round(m / 4096 - 0.5) rounds half to even and so misreads a meta of
    bsdf row 0 with an even light index (dfs_sweep.py:153)."""
    m = torch.round(meta_col)
    twofaced = m >= _META_TWOFACED
    m = m - torch.where(twofaced, _META_TWOFACED, 0.0)
    light = torch.floor(m / 4096.0)
    bsdf = (m - light * 4096.0).to(torch.int64)
    return bsdf, light.to(torch.int64) - 1, twofaced


def _gather_attrs(attr, prim):
    rows = attr[torch.clamp(prim, min=0).long()]
    return torch.where((prim >= 0)[:, None], rows, 0.0)


def _chunk(scene, r: int) -> int:
    return max(128, min(scene.tri_woop.shape[0], _REF_ELEMS // max(r, 1)))


def _tmax(origin, t_max, active):
    r = origin.shape[0]
    if t_max is None:
        t_max = torch.full((r,), _BIG, dtype=torch.float32, device=origin.device)
    if active is not None:
        t_max = torch.where(active, t_max, -_BIG)
    return t_max.to(torch.float32).contiguous()


def _segment(origin, t_min, t_max, active):
    """(t_min, t_max), scalars or (R,), as contiguous (R,) float32, inactive
    rays at t_max = -1e30."""
    r = origin.shape[0]
    dev = origin.device

    def full(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32, device=dev),
                                  (r,)).contiguous()

    return full(t_min), _tmax(origin, full(t_max), active)


def ftb_closest_ref(scene, origin, direction, active=None, t_max=None, attr=None):
    """Plain torch version of ftb_closest: the brute-force Woop scan."""
    t_max = _tmax(origin, t_max, active)
    zeros = torch.zeros_like(t_max)
    t, prim, u, v = woop.closest_scan(origin, direction, scene.tri_woop, zeros, t_max,
                                      _chunk(scene, origin.shape[0]))
    attr = attr_table(scene) if attr is None else attr
    return t, prim, u, v, _gather_attrs(attr, prim)


def ftb_any_ref(scene, origin, direction, t_min, t_max, active=None):
    """Plain torch version of ftb_any: the brute-force Woop scan."""
    t_min, t_max = _segment(origin, t_min, t_max, active)
    return woop.any_scan(origin, direction, scene.tri_woop, t_min, t_max,
                         _chunk(scene, origin.shape[0]))


def kernel_tables(scene):
    """(nodes, meta, clusters, woop_t, bvh_ip) for the counting walk of
    csrc/bvh.cuh (bvh_closest / bvh_any, ftb_walk_tests): the preorder
    tables, the cluster boxes (the implicit tree's leaf level, (6, C),
    inverted where a cluster is empty) and the int parameters n_nodes,
    n_clusters, n_slots, leaf_size, leaf_span."""
    c = scene.bvh_clusters
    clusters = torch.cat([scene.bvh_node_min[c - 1:], scene.bvh_node_max[c - 1:]],
                         dim=1).t().contiguous()
    leaf_span = max(2, 128 // scene.bvh_leaf_size)
    ip = torch.tensor([scene.bvh_dfs_bounds.shape[1], c, scene.tri_woop_t.shape[1],
                       scene.bvh_leaf_size, leaf_span], dtype=torch.int32)
    return (scene.bvh_dfs_bounds.contiguous(), scene.bvh_dfs_meta.contiguous(), clusters,
            scene.tri_woop_t.contiguous(), ip)


def walk_tables(scene):
    """(pairs, woop, walk_ip) for the walk of K3, K4 and K6 (csrc/bvh.cuh:
    walk_closest / walk_any): the scene's own child-pair rows (P, 16) and
    Woop rows (T, 12), packed once when the scene was made, and the host
    ints n_slots, leaf_size, root code (csrc/bvh.cuh:make_walk_tables).
    Raises ValueError unless both are contiguous float32 on a 16-byte
    boundary (_build.check_aligned)."""
    from .. import _build

    _build.check_aligned("walk_tables", **{"scene.bvh_pairs": scene.bvh_pairs,
                                           "scene.tri_woop": scene.tri_woop})
    ip = torch.tensor([scene.tri_woop.shape[0], scene.bvh_leaf_size, scene.bvh_root],
                      dtype=torch.int32)
    return scene.bvh_pairs, scene.tri_woop, ip


def _check_rays(origin, direction, *scalars):
    r = origin.shape[0]
    dev = origin.device
    for name, x, shape in (("origin", origin, (r, 3)), ("direction", direction, (r, 3)),
                           *[(f"t{i}", s, (r,)) for i, s in enumerate(scalars)]):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_scene(scene, dev):
    if scene.device != dev:
        raise ValueError(f"rays on {dev}, scene on {scene.device}")


def ftb_closest(scene, origin, direction, active=None, t_max=None, attr=None):
    """Closest hit with t in (0, t_max).  Returns (t (R,) float32, 1e30 on a
    miss; prim (R,) int32, -1 on a miss; u, v (R,) float32, 0 on a miss;
    attrs (R, A) gathered from `attr` (default attr_table(scene)))."""
    t_max = _tmax(origin, t_max, active)
    _check_rays(origin, direction, t_max)
    _check_scene(scene, origin.device)
    if origin.device.type == "cpu":
        return ftb_closest_ref(scene, origin, direction, t_max=t_max, attr=attr)
    if origin.device.type != "cuda":
        raise ValueError(f"ftb_closest: unsupported device {origin.device}")
    from .. import _build

    lib = _build.load()
    pairs, woop_rows, ip = walk_tables(scene)
    r = origin.shape[0]
    dev = origin.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_bvh_closest(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), r,
                                 pairs.data_ptr(), woop_rows.data_ptr(), ip.data_ptr(),
                                 t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                                 stream)
    _build.check(rc, "ftb_closest")
    profiling.count("ftb_closest.launch")
    attr = attr_table(scene) if attr is None else attr
    return t, prim, u, v, _gather_attrs(attr, prim)


def ftb_any(scene, origin, direction, t_min, t_max, active=None):
    """Any hit: True where a triangle lies strictly inside (t_min, t_max);
    t_min / t_max are scalars or (R,) tensors."""
    dev = origin.device
    t_min, t_max = _segment(origin, t_min, t_max, active)
    _check_rays(origin, direction, t_min, t_max)
    _check_scene(scene, dev)
    if dev.type == "cpu":
        return ftb_any_ref(scene, origin, direction, t_min, t_max)
    if dev.type != "cuda":
        raise ValueError(f"ftb_any: unsupported device {dev}")
    from .. import _build

    lib = _build.load()
    pairs, woop_rows, ip = walk_tables(scene)
    r = origin.shape[0]
    occ = torch.empty((r,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_bvh_any(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                             t_max.data_ptr(), r, pairs.data_ptr(), woop_rows.data_ptr(),
                             ip.data_ptr(), occ.data_ptr(), stream)
    _build.check(rc, "ftb_any")
    profiling.count("ftb_any.launch")
    return occ


def ftb_walk_tests(scene, origin, direction, t_min, t_max, any_hit: bool):
    """(box tests, Woop tests), each (R,) int32: what the preorder walk of
    csrc/bvh.cuh (bvh_closest / bvh_any) does for each ray, the closest-hit
    walk on (0, t_max) or, with any_hit, the any-hit walk on (t_min,
    t_max).  It is the reference count of the work of K3 and of the
    fused-BVH kernels (their least time on the card is counted from the
    fewer of its and walk_tests' operations, ray by ray) and renders
    nothing.  CUDA tensors only: the plain versions scan every slot
    and walk no tree."""
    return _walk_counts("ftb_walk_tests", "gst_bvh_count", kernel_tables, scene, origin,
                        direction, t_min, t_max, any_hit)


def walk_tests(scene, origin, direction, t_min, t_max, any_hit: bool):
    """(box tests, Woop tests), each (R,) int32, of the walk that K3, K4 and
    K6 take (walk_tables: the child pairs, near child first), counted as
    ftb_walk_tests counts the preorder walk: two box tests a pair row
    visited, one Woop test a slot of a cluster entered.  CUDA tensors
    only."""
    return _walk_counts("walk_tests", "gst_bvh_walk_count", walk_tables, scene, origin,
                        direction, t_min, t_max, any_hit)


def _walk_counts(what, entry, tables, scene, origin, direction, t_min, t_max, any_hit):
    """Launch the counting kernel `entry` on the tables(scene) it walks."""
    _check_rays(origin, direction, t_min, t_max)
    _check_scene(scene, origin.device)
    if origin.device.type != "cuda":
        raise ValueError(f"{what}: the walk runs on a CUDA device, not {origin.device}")
    from .. import _build

    lib = _build.load()
    walked = tables(scene)  # held until the launch returns: the host ints are read by it
    r = origin.shape[0]
    boxes = torch.empty((r,), dtype=torch.int32, device=origin.device)
    woops = torch.empty((r,), dtype=torch.int32, device=origin.device)
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
                                 t_max.data_ptr(), r, *(x.data_ptr() for x in walked),
                                 int(any_hit), boxes.data_ptr(), woops.data_ptr(), stream)
    _build.check(rc, what)
    return boxes, woops


class ClosestDiff(torch.autograd.Function):
    """A BVH closest hit `closest(scene, o, d, t_max=, attr=)` (K3a's
    ftb_closest or K7d's cluster_closest) forward, the backward of
    ops/cuda_isect.woop_vjp: (t, u, v) derivatives w.r.t. (o, d)."""

    @staticmethod
    def forward(ctx, closest, origin, direction, t_max, scene, attr):
        t, prim, u, v, attrs = closest(scene, origin, direction, t_max=t_max, attr=attr)
        ctx.save_for_backward(origin, direction, prim, scene.tri_woop)
        ctx.mark_non_differentiable(prim, attrs)
        return t, prim, u, v, attrs

    @staticmethod
    def backward(ctx, ct_t, _ct_prim, ct_u, ct_v, _ct_attrs):
        from ..ops.cuda_isect import woop_vjp

        o, d, prim, woop_rows = ctx.saved_tensors
        do, dd = woop_vjp(o, d, prim, woop_rows, ct_t, ct_u, ct_v)
        return None, do, dd, None, None, None


def ftb_closest_diff(scene, origin, direction, active=None, attr=None):
    """ftb_closest with exact (t, u, v) gradients w.r.t. (origin,
    direction); attrs carry none (the scene's tables are detached)."""
    t_max = _tmax(origin, None, active)
    attr = (attr_table(scene) if attr is None else attr).detach()
    return ClosestDiff.apply(ftb_closest, origin, direction, t_max, scene, attr)
