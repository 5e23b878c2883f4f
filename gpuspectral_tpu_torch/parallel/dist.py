"""Device-mesh distribution: tile x spp sharding with a replicated scene
(port of gpuspectral_tpu/parallel/dist.py).

The reference is strictly single-GPU (SURVEY.md §2.3).  The distribution
plan is the JAX package's, over torch.distributed ranks (one process a
card, parallel/launch.py):

  * a 2-D mesh (tiles, spp), a DeviceMesh with mesh_dim_names ("tiles",
    "spp"): pixels sharded on one axis, samples per pixel on the other —
    both embarrassingly parallel, so the forward pass needs ZERO
    communication; collectives appear only at the end:
      - an all-reduce over the spp group to add or average samples,
      - an all-gather over the tiles group, so every rank holds the image,
      - gradients all-reduced over the whole world in the
        inverse-rendering step,
  * the scene is built on every rank from the same file (nothing is
    broadcast).

Spp shard s renders the samples t0 + s * local_spp + i (i < local_spp), so
the union over shards is exactly the unsharded sample set.  No gradient
flows through a collective: the gradient steps differentiate a linear
surrogate through the rank's own samples only (dist.py:262-282).

Every collective runs on the tensors' device: gloo for CPU tensors, NCCL
for CUDA ones, with the process group's timeout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..integrator.path_tracer import render_sample
from ..scene.data import SceneData
from ..utils.config import RenderConfig

AXES = ("tiles", "spp")


def make_mesh(n_devices: Optional[int] = None, spp_shards: int = 1):
    """Build the (tiles, spp) DeviceMesh over the group's ranks.  The JAX
    package can take the first n_devices of a process's devices; here each
    rank is a process, so a mesh spans every rank of the group and
    n_devices, if given, must be the group's size."""
    from torch.distributed.device_mesh import init_device_mesh

    from .launch import local_device

    dev = local_device()
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {n} ranks")
    if n % spp_shards:
        raise ValueError(f"make_mesh: {n} ranks do not split into {spp_shards} spp shards")
    return init_device_mesh(dev.type, (n // spp_shards, spp_shards), mesh_dim_names=AXES)


def _axes(mesh):
    """(tiles, spp shards, this rank's tile, this rank's spp shard)."""
    if tuple(mesh.mesh_dim_names) != AXES:
        raise ValueError(f"mesh: want dims {AXES}, got {mesh.mesh_dim_names}")
    tiles, spp_shards = mesh.shape
    return tiles, spp_shards, mesh.get_local_rank("tiles"), mesh.get_local_rank("spp")


def _sum(x, mesh, axis=None):
    """All-reduce (sum) over one mesh axis, or the whole world when axis is
    None; returns a new tensor."""
    x = x.detach().clone().contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM,
                    group=None if axis is None else mesh.get_group(axis))
    return x


def _gather_tiles(x, mesh):
    """The tiles' blocks concatenated in tile order on every rank."""
    tiles = mesh.shape[0]
    if tiles == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(tiles)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("tiles"))
    return torch.cat(parts)


def _local_sum(scene, cfg, pix, t0, local_spp, differentiable=False):
    """This shard's radiance sum over its local_spp samples (R, 3)."""
    acc = torch.zeros((pix.shape[0], 3), dtype=torch.float32, device=pix.device)
    for s in range(local_spp):
        rad, _ = render_sample(scene, cfg, pix, t0 + s, differentiable=differentiable)
        acc = acc + rad
    return acc


def _tile_pixels(cfg, mesh, device):
    tiles, spp_shards, ti, si = _axes(mesh)
    n_pixels = cfg.width * cfg.height
    if n_pixels % tiles:
        raise ValueError(f"{n_pixels} pixels do not split into {tiles} tiles")
    if cfg.spp % spp_shards:
        raise ValueError(f"spp {cfg.spp} does not split into {spp_shards} spp shards")
    per = n_pixels // tiles
    pix = torch.arange(ti * per, (ti + 1) * per, dtype=torch.int64, device=device)
    local_spp = cfg.spp // spp_shards
    return pix, local_spp, si * local_spp


def render_image_sharded(scene: SceneData, cfg: RenderConfig, mesh, timestamp0: int = 0):
    """Distributed render: pixels sharded over 'tiles', spp over 'spp', on
    the wavefront (render_sample).

    The forward pass communicates nothing; the sample average is one
    all-reduce over the spp group, then the tiles are gathered.  Returns
    the (H, W, 3) image on every rank."""
    pix, local_spp, s0 = _tile_pixels(cfg, mesh, scene.device)
    acc = _local_sum(scene, cfg, pix, int(timestamp0) + s0, local_spp)
    spp_shards = mesh.shape[1]
    rad = _sum(acc / local_spp, mesh, "spp") / spp_shards
    return _gather_tiles(rad, mesh).reshape(cfg.height, cfg.width, 3)


def _padded_rows(cfg: RenderConfig, tiles: int, device):
    """The frame's raster pixel rows (mega.pix_rows) padded to a multiple of
    tiles with copies of row 0, and the mask of real lanes (pad rows and
    lanes past the last pixel are not)."""
    from ..integrator.mega import LANES, pix_rows

    pix = pix_rows(cfg, device)
    rows = pix.shape[0]
    rows_pad = -(-rows // tiles) * tiles
    valid = (torch.arange(rows * LANES, device=device) < cfg.width * cfg.height).reshape(rows,
                                                                                         LANES)
    if rows_pad > rows:
        pix = torch.cat([pix, pix[:1].expand(rows_pad - rows, LANES)])
        valid = torch.cat([valid, torch.zeros((rows_pad - rows, LANES), dtype=torch.bool,
                                              device=device)])
    return pix.contiguous(), valid


def render_image_sharded_fast(scene: SceneData, cfg: RenderConfig, mesh, timestamp0: int = 0):
    """Distributed render through the megakernels (dist.py:105-201): each
    rank runs K4 (mega_bvh_eligible) or K1 (mega_eligible) on its tile of
    the frame's pixel rows at its local spp (its own progressive frames);
    per-lane sums add over the spp group, the tiles are gathered, then the
    image is divided by cfg.spp.  Where neither kernel covers the (scene,
    cfg), or spp does not split over the spp axis, it renders with
    render_image_sharded and reports 0.0 rays (the JAX package's dispatch:
    the wavefront does not count rays).

    Returns (image (H, W, 3) on every rank, rays traced, a float)."""
    from ..integrator.mega import mega_eligible, render_mega_rows
    from ..integrator.mega_bvh import mega_bvh_eligible, render_mega_bvh_rows

    tiles, spp_shards, ti, si = _axes(mesh)
    use_bvh_kernel = mega_bvh_eligible(scene, cfg)
    use_brute_kernel = not use_bvh_kernel and mega_eligible(scene, cfg)
    if not (use_bvh_kernel or use_brute_kernel) or cfg.spp % spp_shards:
        return render_image_sharded(scene, cfg, mesh, timestamp0), 0.0
    local_spp = cfg.spp // spp_shards
    pix, valid = _padded_rows(cfg, tiles, scene.device)
    per = pix.shape[0] // tiles
    pix_l = pix[ti * per:(ti + 1) * per]
    render = render_mega_bvh_rows if use_bvh_kernel else render_mega_rows
    rr, rg, rb, rays = render(scene, cfg.replace(spp=local_spp), pix_l,
                              int(timestamp0) + si * local_spp)
    # sample sums add across spp shards (disjoint progressive frames)
    rad = _gather_tiles(_sum(torch.stack([rr, rg, rb], dim=-1), mesh, "spp"), mesh)
    rays = _gather_tiles(_sum(rays, mesh, "spp"), mesh)
    n_pixels = cfg.width * cfg.height
    nrays = float(rays[valid].to(torch.float64).sum())
    img = (rad.reshape(-1, 3)[:n_pixels] / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, nrays


def grad_step_sharded(scene: SceneData, cfg: RenderConfig, mesh, target, timestamp0: int = 0):
    """One distributed inverse-rendering gradient step on the
    differentiable wavefront (dist.py:204-282).

    Differentiates the MSE between the rendered image and `target` w.r.t.
    the BSDF parameter table, sharded like render_image_sharded.  With
    img = (1/S) sum_shards x_i and the residual r = 2 (img - t) held
    constant, each rank differentiates the linear surrogate
    sum(r * x_local) / S through its own samples only; the all-reduce of
    those gradients over the world, divided by n_pixels * 3, is exactly
    dL/dtheta, and no gradient flows through a collective.

    Returns (loss, grads) with grads shaped like scene.bsdf_params, the
    same on every rank."""
    pix, local_spp, s0 = _tile_pixels(cfg, mesh, scene.device)
    spp_shards = mesh.shape[1]
    n_pixels = cfg.width * cfg.height
    tgt = torch.as_tensor(target, dtype=torch.float32).to(scene.device).reshape(n_pixels, 3)[pix]
    bp = scene.bsdf_params.detach().clone().requires_grad_(True)
    x_local = _local_sum(scene.replace(bsdf_params=bp), cfg, pix, int(timestamp0) + s0,
                         local_spp, differentiable=True) / local_spp
    img = _sum(x_local, mesh, "spp") / spp_shards
    residual = 2.0 * (img - tgt)
    surrogate = torch.sum(residual * x_local) / spp_shards
    (grads,) = torch.autograd.grad(surrogate, bp)
    denom = n_pixels * 3
    loss = _sum(torch.sum((img - tgt) ** 2), mesh, "tiles") / denom
    return loss, _sum(grads, mesh) / denom


def grad_step_sharded_fast(scene: SceneData, cfg: RenderConfig, mesh, target,
                           timestamp0: int = 0, optimize_emission: bool = False):
    """Distributed gradient step through the fused forward-gradient
    kernels (dist.py:285-414): each rank runs K5 (mega_grad_eligible) or K6
    (mega_bvh_grad_eligible) through integrator.mega_grad.render_blocks_diff
    on its tile of the frame's pixel rows at its local spp; the backward
    pass contracts that launch's partials.  The loss gradient takes the
    linear-surrogate identity of grad_step_sharded: with the per-lane mean
    img = sum over spp shards of x_s / spp and r = 2 (img - t) / N held
    constant (pad lanes masked out), each rank differentiates
    sum(r * x_local / spp) through its own samples; one all-reduce of the
    gradients over the world gives dL/dtheta.

    Returns (loss, d_bsdf_params[, d_tri_emission, d_light_emission]); the
    emission gradients are appended when optimize_emission.  Where neither
    kernel covers the (scene, cfg), or spp does not split over the spp
    axis, it runs grad_step_sharded (the differentiable wavefront; zero
    emission gradients)."""
    from ..integrator.mega_grad import (mega_bvh_grad_eligible, mega_grad_eligible,
                                        render_blocks_diff)

    tiles, spp_shards, ti, si = _axes(mesh)
    use_brute = mega_grad_eligible(scene, cfg)
    use_bvh = not use_brute and mega_bvh_grad_eligible(scene, cfg)
    if not (use_brute or use_bvh) or cfg.spp % spp_shards:
        loss, grads = grad_step_sharded(scene, cfg, mesh, target, timestamp0)
        if optimize_emission:
            return (loss, grads, torch.zeros_like(scene.tri_emission),
                    torch.zeros_like(scene.light_emission))
        return loss, grads
    local_spp = cfg.spp // spp_shards
    n_pixels = cfg.width * cfg.height
    pix, valid = _padded_rows(cfg, tiles, scene.device)
    per = pix.shape[0] // tiles
    pix_l, val_l = pix[ti * per:(ti + 1) * per], valid[ti * per:(ti + 1) * per]
    tgt = torch.as_tensor(target, dtype=torch.float32).to(scene.device).reshape(n_pixels, 3)
    tgt_l = tgt[pix_l.long()]
    denom = n_pixels * 3
    params = [x.detach().clone().requires_grad_(True)
              for x in (scene.bsdf_params, scene.tri_emission, scene.light_emission)]
    sc = scene.replace(bsdf_params=params[0], tri_emission=params[1], light_emission=params[2])
    # this shard's contribution to the per-lane mean
    x = render_blocks_diff(sc, cfg.replace(spp=local_spp), pix_l,
                           int(timestamp0) + si * local_spp, use_bvh) / cfg.spp
    img_l = _sum(x, mesh, "spp")
    vm = val_l[..., None].to(torch.float32)
    residual = 2.0 * (img_l - tgt_l) * vm / denom
    grads = torch.autograd.grad(torch.sum(residual * x), params)
    loss = _sum(torch.sum(vm * (img_l - tgt_l) ** 2), mesh, "tiles") / denom
    d_bp, d_te, d_le = (_sum(g, mesh) for g in grads)
    if optimize_emission:
        return loss, d_bp, d_te, d_le
    return loss, d_bp
