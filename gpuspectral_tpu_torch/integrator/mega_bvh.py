"""K4: the persistent path-tracing megakernel with BVH traversal
(csrc/mega_bvh.cu).

The counterpart of gpuspectral_tpu/integrator/mega_bvh.py: the whole forward
path tracer for one pixel lane in one CUDA thread, K1's per-lane tracer
(csrc/bounce.cuh) with K3's BVH walk (csrc/bvh.cuh) as its intersector, plus
the power light pick, the per-corner texture blend and block-synchronous
regeneration (cfg.mega_sync_regen, per-pixel results unchanged).

`render_mega_bvh_rows` launches the kernel for CUDA tensors (counting
launches in utils.profiling) on tables packed once a scene
(`launch_tables`; only the parameters, pixels and outputs are per call)
and runs the plain version,
`render_mega_bvh_rows_ref` — the torch wavefront over the same pixel rows,
on the plain K3 (the brute-force Woop scan), shading textures with the same
per-corner blend — for CPU tensors.  Pixel and output planes are
(rows, LANES).

Not carried over from the TPU kernel: its schedule (VMEM residency and
streaming, 1024-ray blocks, traversal subgroups, per-round bin picks, the
tiled pixel layout) and `debug_rounds_cap`, a TPU probing knob that biases
the image; a nonzero cap raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bvh import ftb
from ..scene.data import SceneData
from ..utils import profiling
from ..utils.config import RenderConfig
from . import path_tracer
from .mega import LANES, _pack_tables, env_fused_ok, kernel_params, pack_env, render_frame


def mega_bvh_eligible(scene: SceneData, cfg: RenderConfig) -> bool:
    """Whether the fused-BVH megakernel covers this (scene, config): the
    semantic gates of mega_bvh.py:891-902 (the TPU residency and streaming
    limits do not apply)."""
    return (
        cfg.use_bvh
        and env_fused_ok(scene)
        and cfg.light_sampling in ("uniform", "power")
        and scene.num_tris > 0
        and scene.num_lights < (1 << 16)
    )


def pack_attr(scene: SceneData, light_mode: str) -> torch.Tensor:
    """(T, 32 | 41) attribute rows (mega_bvh.py:_pack_tables_bvh): K1's rows
    0-30, row 31 the light-selection pdf of the triangle's emitter (0 when
    not emissive), and for textured scenes rows 32-40 the per-corner texture
    colours (rgb x 3 corners)."""
    return _attr_rows(scene, _pack_tables(scene)[1], light_mode)


def _attr_rows(scene: SceneData, attr, light_mode: str) -> torch.Tensor:
    """pack_attr from K1's rows `attr` (_pack_tables)."""
    lidx = scene.tri_light_idx.long()
    if light_mode == "power":
        sel = scene.light_prob[torch.clamp(lidx, min=0)]
    else:
        sel = torch.full_like(attr[:, 0], 1.0 / scene.num_lights)
    attr = torch.cat([attr[:, :31], torch.where(lidx >= 0, sel, 0.0)[:, None]], dim=1)
    if scene.has_textures:
        attr = torch.cat([attr, path_tracer.corner_texture_rows(scene)], dim=1)
    return attr.contiguous()


class LaunchTables(NamedTuple):
    """What K4 reads by pointer besides the pixels, its parameters and its
    outputs: walk_tables' rows and host ints, pack_attr's rows, the light
    and camera rows of _pack_tables, pack_env's table and the light
    selection tables."""

    pairs: torch.Tensor
    woop: torch.Tensor
    walk_ip: torch.Tensor
    attr: torch.Tensor
    light: torch.Tensor
    camv: torch.Tensor
    env: torch.Tensor
    light_cdf: torch.Tensor
    light_prob: torch.Tensor


def _sources(scene: SceneData) -> tuple:
    """Every tensor that LaunchTables are made from."""
    return (scene.tri_pos, scene.tri_nrm, scene.tri_uv, scene.tri_bsdf, scene.tri_emission,
            scene.tri_twofaced, scene.tri_light_idx, scene.tri_woop, scene.bsdf_kind,
            scene.bsdf_params, scene.textures, scene.bsdf_tex, scene.light_pos,
            scene.light_emission, scene.envmap, scene.envmap_rot, scene.envmap_cdf,
            scene.envmap_pdf, scene.light_cdf, scene.light_prob, scene.bvh_pairs,
            scene.camera.to_world, scene.camera.fov)


def _pack(scene: SceneData, light_mode: str) -> LaunchTables:
    pairs, woop, walk_ip = ftb.walk_tables(scene)
    _, attr, light, camv = _pack_tables(scene)
    return LaunchTables(pairs, woop, walk_ip, _attr_rows(scene, attr, light_mode), light, camv,
                        pack_env(scene), scene.light_cdf.contiguous(),
                        scene.light_prob.contiguous())


def launch_tables(scene: SceneData, light_mode: str) -> LaunchTables:
    """K4's tables for (scene, light_mode), packed on the first call and held
    on the scene object itself, so they die with it and a scene.replace(...)
    gets its own.  A held set is served while every source tensor keeps the
    in-place version (Tensor._version) it was packed at; a source that
    requires grad (the set would hold its graph) or is an inference tensor
    (it has no version) is packed anew on every call and nothing is held.
    Counts "mega_bvh.tables.packed" / "mega_bvh.tables.reused"."""
    src = _sources(scene)
    held = vars(scene).setdefault("_k4_tables", {})  # light_mode -> (versions, tables)
    versions = None
    if any(t.requires_grad or t.is_inference() for t in src):
        held.pop(light_mode, None)
    else:
        versions = tuple(t._version for t in src)
        entry = held.get(light_mode)
        if entry is not None and entry[0] == versions:
            profiling.count("mega_bvh.tables.reused")
            return entry[1]
    profiling.count("mega_bvh.tables.packed")
    tables = _pack(scene, light_mode)
    if versions is not None:
        held[light_mode] = (versions, tables)
    return tables


def _check(scene, cfg, pix):
    if not mega_bvh_eligible(scene, cfg):
        raise ValueError("render_mega_bvh_rows: (scene, cfg) is not eligible")
    if cfg.debug_rounds_cap:
        raise NotImplementedError("debug_rounds_cap is a TPU probing knob; not in the port")
    if pix.dim() != 2 or pix.shape[1] != LANES or pix.dtype != torch.int32:
        raise ValueError(f"pix: want int32 (rows, {LANES}), got {pix.dtype} {tuple(pix.shape)}")
    if pix.device != scene.device:
        raise ValueError(f"pix on {pix.device}, scene on {scene.device}")


def render_mega_bvh_rows_ref(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0):
    """Plain torch version of render_mega_bvh_rows: the torch wavefront on
    the plain K3 over the same pixel rows (no light-pick sharing or ray
    sorting, which the kernel does not do), textures by the per-corner
    blend.  Returns (rad_r, rad_g, rad_b, rays) planes."""
    rows = pix.shape[0]
    plain = cfg.replace(intersector="woop", light_block=0, sort_rays=False, shadow_sort=False)
    st = path_tracer.trace_wavefront(scene, plain, pix.reshape(-1), timestamp0,
                                     tex_mode="corners", bvh_isect=path_tracer.PLAIN_K3)
    rad, rays = st["radiance"], st["rays_traced"]
    shape = (rows, LANES)
    return (rad[:, 0].reshape(shape), rad[:, 1].reshape(shape),
            rad[:, 2].reshape(shape), rays.reshape(shape))


def render_mega_bvh_rows(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0):
    """Run the fused-BVH megakernel over explicit pixel rows.  pix: (rows,
    LANES) int32 pixel ids.  Returns per-lane radiance sums over cfg.spp and
    ray counts, each (rows, LANES)."""
    _check(scene, cfg, pix)
    if pix.device.type == "cpu":
        return render_mega_bvh_rows_ref(scene, cfg, pix, timestamp0)
    if pix.device.type != "cuda":
        raise ValueError(f"render_mega_bvh_rows: unsupported device {pix.device}")
    from .. import _build

    with profiling.stage("gst.k4.prep"):
        lib = _build.load()
        tab = launch_tables(scene, cfg.light_sampling)
        ip, fp = kernel_params(scene, cfg, timestamp0, power_pick=cfg.light_sampling == "power",
                               textured=scene.has_textures, attr_stride=tab.attr.shape[1])
        pix = pix.contiguous()
        rows = pix.shape[0]
        out = [torch.empty((rows, LANES), dtype=torch.float32, device=pix.device)
               for _ in range(3)]
        rays = torch.empty((rows, LANES), dtype=torch.int32, device=pix.device)
    with profiling.stage("gst.k4.launch"), torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_mega_bvh(
            pix.data_ptr(), pix.numel(), tab.pairs.data_ptr(), tab.woop.data_ptr(),
            tab.walk_ip.data_ptr(), tab.attr.data_ptr(), tab.light.data_ptr(),
            tab.light_cdf.data_ptr(), tab.light_prob.data_ptr(), tab.camv.data_ptr(),
            tab.env.data_ptr(), ip.ctypes.data, fp.ctypes.data, int(cfg.mega_sync_regen),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), rays.data_ptr(), stream,
        )
        _build.check(rc, "render_mega_bvh_rows")
    profiling.count("render_mega_bvh_rows.launch")
    return out[0], out[1], out[2], rays


def render_mega_bvh(scene: SceneData, cfg: RenderConfig, timestamp0=0):
    """K4's frame (mega.render_frame): the span "gst.k4.prep" holds the
    frame's rows and render_mega_bvh_rows's parameters, outputs and table
    lookup (the pack itself on a scene's first frame)."""
    return render_frame(scene, cfg, timestamp0, render_mega_bvh_rows, "gst.k4.prep")
