"""K1: the persistent path-tracing megakernel (csrc/mega.cu).

The counterpart of gpuspectral_tpu/integrator/mega.py: the whole forward
path tracer for one pixel lane in one CUDA thread — camera ray, brute-force
closest hit, the 8-BSDF sample and eval, NEE with MIS, firefly clamp,
Russian roulette and per-lane sample regeneration — with the same
estimator and the same counter-based RNG draws as the wavefront
(integrator/path_tracer.py), so the two agree up to float rounding.

`render_mega_rows` launches the kernel for CUDA tensors (counting launches
in utils.profiling) and runs the plain version,
`render_mega_rows_ref` — the torch wavefront over the same pixel rows — for
CPU tensors.  Pixel and output planes are (rows, LANES).

Environment emitters: constant maps and lat-long maps of at most
MEGA_ENV_MAX_TEXELS texels run in the kernel (the JAX package's fused-kernel
cap, kept so that dispatch matches it); bigger maps go to the wavefront.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import math3d as m3
from ..scene.data import MEGA_MAX_TRIS, SceneData
from ..utils import profiling
from ..utils.config import RenderConfig
from . import path_tracer

LANES = 128  # lanes per pixel row (one CUDA block)
MEGA_ENV_MAX_TEXELS = 2048  # gpuspectral_tpu/integrator/mega.py:598


def env_fused_ok(scene: SceneData) -> bool:
    """No environment, a constant (1x1) map, or a lat-long map of at most
    MEGA_ENV_MAX_TEXELS texels (mega.py:1396)."""
    if not scene.has_envmap:
        return True
    h, w = scene.envmap.shape[:2]
    return (h, w) == (1, 1) or h * w <= MEGA_ENV_MAX_TEXELS


def mega_eligible(scene: SceneData, cfg: RenderConfig) -> bool:
    """Whether the megakernel covers this (scene, config) (mega.py:1409)."""
    return (
        not cfg.use_bvh
        and not scene.has_textures
        and env_fused_ok(scene)
        and cfg.light_sampling == "uniform"
        and scene.num_tris > 0
        and scene.num_tris <= MEGA_MAX_TRIS
        and scene.num_lights < (1 << 16)
    )


def _pack_tables(scene: SceneData):
    """Kernel tables (mega.py:_pack_tables, row-major per triangle).

    attr (T, 32): 0-8 corner normals, 9-11 emission, 12 twofaced, 13 light
    idx, 14 bsdf kind, 15-26 bsdf params, 27-29 geometric normal, 30 area,
    31 pad.  light (L, 12): vertices, emission.  cam (13,): to_world
    rotation (row-major), origin, fov."""
    t = scene.tri_pos.shape[0]
    f32 = torch.float32
    e1 = scene.tri_pos[:, 1] - scene.tri_pos[:, 0]
    e2 = scene.tri_pos[:, 2] - scene.tri_pos[:, 0]
    cr = m3.cross(e1, e2)
    crl = m3.sqrt(torch.clamp(m3.dot(cr, cr), min=1e-24))
    gn = cr / torch.clamp(crl, min=1e-12)[:, None]
    area = 0.5 * crl
    bsdf = scene.tri_bsdf.long()
    attr = torch.cat(
        [
            scene.tri_nrm.reshape(t, 9),
            scene.tri_emission,
            scene.tri_twofaced[:, None].to(f32),
            scene.tri_light_idx[:, None].to(f32),
            scene.bsdf_kind[bsdf][:, None].to(f32),
            scene.bsdf_params[bsdf],
            gn,
            area[:, None],
            torch.zeros((t, 1), dtype=f32, device=scene.device),
        ],
        dim=1,
    ).contiguous()
    light = torch.cat(
        [scene.light_pos.reshape(-1, 9), scene.light_emission], dim=1
    ).contiguous()
    cam = scene.camera
    camv = torch.cat(
        [cam.to_world[:3, :3].reshape(9), cam.to_world[:3, 3], cam.fov.reshape(1)]
    ).to(f32).contiguous()
    return scene.tri_woop_t.contiguous(), attr, light, camv


def woop_rows(scene: SceneData) -> torch.Tensor:
    """K1 / K5's Woop table: the scene's (num_tris, 12) rows in
    ops/woop.py's order (`tri_woop`, whose columns `tri_woop_t` holds), which
    csrc/brute.cuh stages as three float4 a triangle: contiguous float32 on
    a 16-byte boundary, else ValueError (_build.check_aligned)."""
    from .. import _build

    rows = scene.tri_woop[:scene.num_tris].contiguous()
    _build.check_aligned("woop_rows", tri_woop=rows)
    return rows


def pack_env(scene: SceneData) -> torch.Tensor:
    """The kernels' environment table: [world->env rotation (9, row-major) |
    texel radiance (h*w*3) | texel CDF (h*w) | texel pdf (h*w)]."""
    return torch.cat([scene.envmap_rot.reshape(-1), scene.envmap.reshape(-1),
                      scene.envmap_cdf.reshape(-1), scene.envmap_pdf.reshape(-1)]
                     ).to(torch.float32).contiguous()


def kernel_params(scene: SceneData, cfg: RenderConfig, timestamp0, *, power_pick=False,
                  textured=False, attr_stride=32):
    """(int32, float32) numpy parameter arrays in csrc/bounce.cuh's IParam /
    FParam order."""
    h, w = scene.envmap.shape[:2]
    ints = [cfg.width, cfg.height, cfg.spp, cfg.max_depth, cfg.rr_start_depth,
            scene.num_lights, int(cfg.nee), int(cfg.jitter), int(cfg.mis_mode == "exact"),
            int(power_pick), int(scene.has_envmap), int(scene.has_area_lights), h, w,
            int(textured), attr_stride, int(timestamp0) & 0xFFFFFFFF]
    ip = np.asarray(ints, np.int64).astype(np.uint32).view(np.int32)
    fp = np.asarray([cfg.rr_clamp_min, cfg.firefly_clamp, cfg.shadow_epsilon,
                     cfg.origin_epsilon], np.float32)
    return ip, fp


def render_mega_rows_ref(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0):
    """Plain torch version of render_mega_rows: the torch wavefront (with its
    plain Woop scans) over the same pixel rows.  Returns the same
    (rad_r, rad_g, rad_b, rays) planes: per-lane radiance sums over cfg.spp
    and ray counts."""
    rows = pix.shape[0]
    st = path_tracer.trace_wavefront(
        scene, cfg.replace(intersector="woop", light_block=0), pix.reshape(-1), timestamp0)
    rad, rays = st["radiance"], st["rays_traced"]
    shape = (rows, LANES)
    return (rad[:, 0].reshape(shape), rad[:, 1].reshape(shape),
            rad[:, 2].reshape(shape), rays.reshape(shape))


def render_mega_rows(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0):
    """Run the megakernel over explicit pixel rows.  pix: (rows, LANES)
    int32 pixel ids.  Returns per-lane radiance sums over cfg.spp and ray
    counts, each (rows, LANES)."""
    if not mega_eligible(scene, cfg):
        raise ValueError("render_mega_rows: (scene, cfg) is not megakernel-eligible")
    if pix.dim() != 2 or pix.shape[1] != LANES or pix.dtype != torch.int32:
        raise ValueError(f"pix: want int32 (rows, {LANES}), got {pix.dtype} {tuple(pix.shape)}")
    if pix.device != scene.device:
        raise ValueError(f"pix on {pix.device}, scene on {scene.device}")
    if pix.device.type == "cpu":
        return render_mega_rows_ref(scene, cfg, pix, timestamp0)
    if pix.device.type != "cuda":
        raise ValueError(f"render_mega_rows: unsupported device {pix.device}")
    return _launch(scene, cfg, pix, timestamp0)


def _launch(scene: SceneData, cfg: RenderConfig, pix, timestamp0, max_ctas=0):
    """K1 over CUDA pixel rows: render_mega_rows past its checks.  max_ctas
    > 0 caps the resident grid (the tests' small grids); every tensor the
    launch reads by pointer is held here until it returns."""
    from .. import _build

    with profiling.stage("gst.k1.prep"):
        lib = _build.load()
        woop = woop_rows(scene)
        _, attr, light, camv = _pack_tables(scene)
        env = pack_env(scene)
        ip, fp = kernel_params(scene, cfg, timestamp0)
        pix = pix.contiguous()
        rows = pix.shape[0]
        out = [torch.empty((rows, LANES), dtype=torch.float32, device=pix.device)
               for _ in range(3)]
        rays = torch.empty((rows, LANES), dtype=torch.int32, device=pix.device)
        next_lane = torch.empty(1, dtype=torch.int32, device=pix.device)
    with profiling.stage("gst.k1.launch"), torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_mega(
            pix.data_ptr(), pix.numel(), woop.data_ptr(), scene.num_tris,
            attr.data_ptr(), light.data_ptr(), camv.data_ptr(), env.data_ptr(),
            ip.ctypes.data, fp.ctypes.data, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), rays.data_ptr(), next_lane.data_ptr(), max_ctas, stream,
        )
        _build.check(rc, "render_mega_rows")
    profiling.count("render_mega_rows.launch")
    return out[0], out[1], out[2], rays


def pix_rows(cfg: RenderConfig, device):
    """Raster pixel rows (rows, LANES) int32 of a whole frame; lanes past
    the last pixel point at pixel 0 (mega.py:1471-1482)."""
    n_pixels = cfg.width * cfg.height
    rows = -(-n_pixels // LANES)
    pix = torch.arange(rows * LANES, dtype=torch.int32, device=device)
    return torch.where(pix < n_pixels, pix, 0).reshape(rows, LANES)


def render_frame(scene: SceneData, cfg: RenderConfig, timestamp0, rows_fn, prep: str):
    """The frame of a megakernel: (H, W, 3) radiance (mean over cfg.spp)
    plus the total rays traced (a float), pixels in raster order.
    rows_fn(scene, cfg, pix, timestamp0) renders the frame's pixel rows
    (render_mega_rows, mega_bvh.render_mega_bvh_rows); making the rows is
    the first piece of its span `prep`, the rows function the second.
    Lanes past the last pixel point at pixel 0 and are left out of the
    image and the ray total (mega.py:1471-1482)."""
    n_pixels = cfg.width * cfg.height
    with profiling.stage(prep):
        pix = pix_rows(cfg, scene.device)
    rad_r, rad_g, rad_b, rays = rows_fn(scene, cfg, pix, timestamp0)
    rad = torch.stack([rad_r.reshape(-1), rad_g.reshape(-1), rad_b.reshape(-1)], dim=-1)[:n_pixels]
    with profiling.stage("gst.sync.rays"):  # the host waits for the kernel here
        nrays = float(rays.reshape(-1)[:n_pixels].to(torch.float64).sum())
    img = (rad / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, nrays


def render_mega(scene: SceneData, cfg: RenderConfig, timestamp0=0):
    """K1's frame (render_frame): the span "gst.k1.prep" holds the frame's
    rows and _launch's tables."""
    return render_frame(scene, cfg, timestamp0, render_mega_rows, "gst.k1.prep")
