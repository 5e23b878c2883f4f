"""K5 and K6: the fused forward-gradient megakernels (csrc/mega_grad.cu,
csrc/mega_bvh.cu with csrc/grad.cuh).

The counterpart of gpuspectral_tpu/integrator/mega_grad.py.  One launch of
K5 (brute force; K1 plus a gradient hook) or K6 (BVH; K4 plus the same
hook) renders the image AND leaves per-lane gradient partials of

  * diffuse albedo (bsdf_params[:, 0:3] of up to MAX_GRAD_BSDFS rows),
  * emitter radiance (tri_emission of emissive triangles and
    light_emission, for scenes of at most MAX_GRAD_LIGHTS lights),

by the counting identity (csrc/grad.cuh): on a path with n_b prior bounces
on diffuse row b, d contribution / d kd_b = n_b * contribution / kd_b.
Sampling pdfs and ray geometry do not depend on kd for diffuse (cosine)
sampling, so these equal full autodiff's gradients; Russian roulette's 1/q
does depend on kd, so depth is gated to <= rr_start_depth.  The loss
cotangent enters linearly, so the backward pass of `render_mega_diff` /
`render_mega_bvh_diff` (torch.autograd.Function) is one contraction of the
partials with the cotangent (_contract_partials) and a scatter; no second
launch.  kd exactly 0 is the estimator's removable singularity, clamped at
_KD_EPS (inverse rendering reparameterizes through sigmoids and never
reaches it).

The wrappers `render_mega_fwdgrad_rows` (K5) and
`render_mega_bvh_fwdgrad_rows` (K6) launch the kernels for CUDA tensors
(counting launches in utils.profiling) and run the plain versions for CPU
tensors: the torch wavefront over the same pixel rows with the same hook
as a callback in path_tracer._bounce (K6's with textures by the per-corner
blend).  Partial planes are (NP, rows, LANES), NP = 3R + 6Lg, in
grad_plane_keys order.  On a scene that is not eligible the wrappers and
the differentiable renders raise; callers choose the differentiable
wavefront themselves (diff/invert.py, utils/bench.py).

Not carried over: the TPU watchdog's spp chunking of the BVH kernel
(mega_grad.py:712-734, gated on a TPU backend): the port runs one launch,
which the H100 runs to its end.  `render_blocks_diff` is the
differentiable render over explicit pixel rows that the sharded gradient
step (parallel/dist.py) runs on each rank's rows; render_mega_diff and
render_mega_bvh_diff are it over a whole frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bsdf.table import BSDF_DIFFUSE
from ..scene.data import SceneData
from ..utils import profiling
from ..utils.config import RenderConfig
from . import path_tracer
from .mega import (LANES, _pack_tables, kernel_params, mega_eligible, pack_env, pix_rows,
                   woop_rows)

MAX_GRAD_BSDFS = 8
MAX_GRAD_LIGHTS = 4
_KD_EPS = 1e-4


def mega_grad_eligible(scene: SceneData, cfg: RenderConfig) -> bool:
    """Whether K5 covers this (scene, config) (mega_grad.py:97-107)."""
    return (
        mega_eligible(scene, cfg)
        and not scene.has_envmap
        and scene.kinds_present == (BSDF_DIFFUSE,)
        and scene.bsdf_kind.shape[0] <= MAX_GRAD_BSDFS
        and scene.num_lights <= MAX_GRAD_LIGHTS
        and cfg.max_depth <= cfg.rr_start_depth
    )


def mega_bvh_grad_rows(scene: SceneData) -> tuple:
    """The diffuse BSDF rows K6 differentiates: the first MAX_GRAD_BSDFS."""
    kinds = scene.bsdf_kind.cpu().numpy()
    return tuple(int(r) for r in np.nonzero(kinds == BSDF_DIFFUSE)[0][:MAX_GRAD_BSDFS])


def mega_bvh_grad_eligible(scene: SceneData, cfg: RenderConfig) -> bool:
    """Whether K6 covers this (scene, config) (mega_grad.py:537-545)."""
    from .mega_bvh import mega_bvh_eligible

    return (
        mega_bvh_eligible(scene, cfg)
        and not scene.has_envmap
        and cfg.max_depth <= cfg.rr_start_depth
        and len(mega_bvh_grad_rows(scene)) > 0
    )


def _grad_lights(scene: SceneData) -> int:
    return scene.num_lights if scene.num_lights <= MAX_GRAD_LIGHTS else 0


def grad_plane_keys(n_rows: int, n_grad_lights: int) -> list:
    """Names of the partial planes, in plane order: [0, 3R) d kd (row-major
    i, c), then 3Lg tri_emission, then 3Lg light_emission.  A plane's
    cotangent channel is its index mod 3."""
    keys = [f"gkd_{i}_{c}" for i in range(n_rows) for c in range(3)]
    keys += [f"gte_{li}_{c}" for li in range(n_grad_lights) for c in range(3)]
    keys += [f"gle_{li}_{c}" for li in range(n_grad_lights) for c in range(3)]
    return keys


def init_grad_state(r: int, n_rows: int, n_grad_lights: int, device) -> dict:
    """The hook's per-lane state for the torch wavefront: partials (r, NP)
    and the per-row bounce counts (r, n_rows)."""
    npl = 3 * n_rows + 6 * n_grad_lights
    return dict(g_parts=torch.zeros((r, npl), dtype=torch.float32, device=device),
                g_n=torch.zeros((r, n_rows), dtype=torch.int64, device=device))


def make_diffuse_grad_hook(grad_rows, n_grad_lights: int, kd_ref):
    """The wavefront's counterpart of csrc/grad.cuh (mega_grad.py:110-174),
    for path_tracer._bounce's grad_hook: the same terms in the same order.
    grad_rows: the BSDF rows differentiated; kd_ref (R, 3) their kd."""
    R, Lg = len(grad_rows), n_grad_lights
    kd_c = torch.clamp(kd_ref, min=_KD_EPS)

    def hook(st, ctx):
        f32 = torch.float32
        W, e, fl, lemit = ctx["weight"], ctx["e"], ctx["f_light"], ctx["lemit"]
        accf = ctx["acc"].to(f32)
        hitm = accf * ctx["hit"].to(f32)
        neem = accf * ctx["nee_done"].to(f32) * ctx["lfront"]
        bidx, lhit, nee_s = ctx["bidx"], ctx["lhit"], ctx["nee_s"]
        emit_coeff = ctx["emit_w"] * ctx["light_flag"]
        fresh = ctx["depth"] == 0  # counts are per path
        parts = st["g_parts"].clone()
        n = st["g_n"].clone()
        for i, b in enumerate(grad_rows):
            selb = (bidx == b).to(f32)
            nbi = torch.where(fresh, 0, n[:, i])
            nb = nbi.to(f32)
            for c in range(3):
                dfl = fl[:, c] / kd_c[i, c]
                direct = neem * selb * nee_s * W[:, c] * lemit[:, c] * dfl
                suffix = accf * e[:, c] * nb / kd_c[i, c]
                parts[:, 3 * i + c] = parts[:, 3 * i + c] + (direct + suffix)
            n[:, i] = nbi + (ctx["cont"] & (bidx == b)).to(torch.int64)
        for li in range(Lg):
            sel_hit = hitm * (lhit == li).to(f32)
            sel_nee = neem * (ctx["lidx"] == li).to(f32)
            for c in range(3):
                te, le = 3 * R + 3 * li + c, 3 * R + 3 * Lg + 3 * li + c
                parts[:, te] = parts[:, te] + sel_hit * emit_coeff * W[:, c]
                parts[:, le] = parts[:, le] + sel_nee * nee_s * fl[:, c] * W[:, c]
        st["g_parts"], st["g_n"] = parts, n
        return st

    return hook


def _contract_partials(parts, gp, R: int, Lg: int):
    """Contract partials (NP, rows, LANES) with per-lane cotangents of the
    radiance sums gp (rows, LANES, 3), in full float32 (an elementwise
    product and a sum: no matmul, so no TF32).  Returns (d_kd (R, 3),
    d_te_l (Lg, 3), d_le (Lg, 3))."""
    npl = 3 * R + 6 * Lg
    cidx = torch.arange(npl, device=parts.device) % 3
    gsel = gp.permute(2, 0, 1)[cidx]  # (NP, rows, LANES)
    tot = (parts * gsel).sum(dim=(1, 2))
    return (tot[:3 * R].reshape(R, 3), tot[3 * R:3 * R + 3 * Lg].reshape(Lg, 3),
            tot[3 * R + 3 * Lg:].reshape(Lg, 3))


def _scatter_grads(scene: SceneData, grad_rows, Lg: int, d_kd, d_te_l, d_le_g):
    """Full-shape gradients of (bsdf_params, tri_emission, light_emission)
    from the contracted partials (_scatter_grads_brute / _scatter_grads_bvh):
    a light's emitter-hit gradient lands on each of its triangles."""
    d_bp = torch.zeros_like(scene.bsdf_params)
    with profiling.stage("gst.sync.grad_rows"):  # the host list's upload waits for the stream
        d_bp[list(grad_rows), 0:3] = d_kd
    if not Lg:
        return d_bp, torch.zeros_like(scene.tri_emission), torch.zeros_like(scene.light_emission)
    pad = torch.zeros((scene.num_lights - Lg, 3), dtype=torch.float32, device=d_kd.device)
    d_te_l = torch.cat([d_te_l, pad])
    d_le = torch.cat([d_le_g, pad])
    lidx = scene.tri_light_idx.long()
    d_te = torch.where((lidx >= 0)[:, None], d_te_l[torch.clamp(lidx, min=0)], 0.0)
    return d_bp, d_te, d_le


def _check_pix(scene, pix):
    if pix.dim() != 2 or pix.shape[1] != LANES or pix.dtype != torch.int32:
        raise ValueError(f"pix: want int32 (rows, {LANES}), got {pix.dtype} {tuple(pix.shape)}")
    if pix.device != scene.device:
        raise ValueError(f"pix on {pix.device}, scene on {scene.device}")


def _planes_ref(scene, cfg, pix, timestamp0, grad_rows, Lg, tex_mode):
    """The plain versions of K5 / K6: the torch wavefront with the hook."""
    kd = scene.bsdf_params[list(grad_rows), 0:3]
    hook = make_diffuse_grad_hook(grad_rows, Lg, kd)
    r = pix.numel()
    state0 = init_grad_state(r, len(grad_rows), Lg, pix.device)
    st = path_tracer.trace_wavefront(scene, cfg, pix.reshape(-1), timestamp0, tex_mode=tex_mode,
                                     grad_hook=hook, hook_state=state0,
                                     bvh_isect=path_tracer.PLAIN_K3)
    rad, rays = st["radiance"], st["rays_traced"]
    shape = (pix.shape[0], LANES)
    parts = st["g_parts"].t().reshape(-1, *shape).contiguous()
    return (rad[:, 0].reshape(shape), rad[:, 1].reshape(shape), rad[:, 2].reshape(shape),
            rays.reshape(shape), parts)


def _launch_planes(pix, npl):
    rows = pix.shape[0]
    out = [torch.empty((rows, LANES), dtype=torch.float32, device=pix.device) for _ in range(3)]
    rays = torch.empty((rows, LANES), dtype=torch.int32, device=pix.device)
    parts = torch.zeros((npl, rows, LANES), dtype=torch.float32, device=pix.device)
    return out, rays, parts


def render_mega_fwdgrad_rows_ref(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0):
    """Plain torch version of render_mega_fwdgrad_rows."""
    plain = cfg.replace(intersector="woop", light_block=0)
    return _planes_ref(scene, plain, pix, timestamp0, tuple(range(scene.bsdf_kind.shape[0])),
                       scene.num_lights, "nearest")


def render_mega_fwdgrad_rows(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0):
    """K5 over explicit pixel rows, pix (rows, LANES) int32.  Returns
    (rad_r, rad_g, rad_b, rays) per-lane sums over cfg.spp, each (rows,
    LANES), and the partial planes (3B + 6L, rows, LANES) of every BSDF row
    and light (grad_plane_keys order)."""
    if not mega_grad_eligible(scene, cfg):
        raise ValueError("render_mega_fwdgrad_rows: (scene, cfg) is not K5-eligible")
    _check_pix(scene, pix)
    if pix.device.type == "cpu":
        return render_mega_fwdgrad_rows_ref(scene, cfg, pix, timestamp0)
    if pix.device.type != "cuda":
        raise ValueError(f"render_mega_fwdgrad_rows: unsupported device {pix.device}")
    return _launch_k5(scene, cfg, pix, timestamp0)


def _launch_k5(scene: SceneData, cfg: RenderConfig, pix, timestamp0, max_ctas=0):
    """K5 over CUDA pixel rows: render_mega_fwdgrad_rows past its checks.
    max_ctas > 0 caps the resident grid (the tests' small grids); every
    tensor the launch reads by pointer is held here until it returns."""
    from .. import _build

    with profiling.stage("gst.k5.prep"):
        lib = _build.load()
        B, L = scene.bsdf_kind.shape[0], scene.num_lights
        woop = woop_rows(scene)
        _, attr, light, camv = _pack_tables(scene)
        attr = torch.cat([attr, scene.tri_bsdf[:, None].to(torch.float32)], dim=1).contiguous()
        env = pack_env(scene)
        ip, fp = kernel_params(scene, cfg, timestamp0, attr_stride=attr.shape[1])
        rows = torch.arange(B, dtype=torch.int32, device=pix.device)
        kd = scene.bsdf_params[:, 0:3].contiguous()
        pix = pix.contiguous()
        out, rays, parts = _launch_planes(pix, 3 * B + 6 * L)
        next_lane = torch.empty(1, dtype=torch.int32, device=pix.device)
    with profiling.stage("gst.k5.launch"), torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_mega_grad(
            pix.data_ptr(), pix.numel(), woop.data_ptr(), scene.num_tris,
            attr.data_ptr(), light.data_ptr(), camv.data_ptr(), env.data_ptr(),
            ip.ctypes.data, fp.ctypes.data, rows.data_ptr(), kd.data_ptr(), B, L,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), rays.data_ptr(),
            parts.data_ptr(), next_lane.data_ptr(), max_ctas, stream)
        _build.check(rc, "render_mega_fwdgrad_rows")
    profiling.count("render_mega_fwdgrad_rows.launch")
    return out[0], out[1], out[2], rays, parts


def render_mega_bvh_fwdgrad_rows_ref(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0,
                                     grad_rows=None):
    """Plain torch version of render_mega_bvh_fwdgrad_rows: the wavefront on
    the plain K3, textures by the per-corner blend."""
    rows = mega_bvh_grad_rows(scene) if grad_rows is None else tuple(grad_rows)
    plain = cfg.replace(intersector="woop", light_block=0, sort_rays=False, shadow_sort=False)
    return _planes_ref(scene, plain, pix, timestamp0, rows, _grad_lights(scene), "corners")


def render_mega_bvh_fwdgrad_rows(scene: SceneData, cfg: RenderConfig, pix, timestamp0=0,
                                 grad_rows=None):
    """K6 over explicit pixel rows, pix (rows, LANES) int32.  Returns
    (rad_r, rad_g, rad_b, rays), each (rows, LANES), and the partial planes
    (3R + 6Lg, rows, LANES) of grad_rows (default mega_bvh_grad_rows) and,
    for scenes of at most MAX_GRAD_LIGHTS lights, of every light."""
    if not mega_bvh_grad_eligible(scene, cfg):
        raise ValueError("render_mega_bvh_fwdgrad_rows: (scene, cfg) is not K6-eligible")
    if cfg.debug_rounds_cap:
        raise NotImplementedError("debug_rounds_cap is a TPU probing knob; not in the port")
    _check_pix(scene, pix)
    grad_rows = mega_bvh_grad_rows(scene) if grad_rows is None else tuple(grad_rows)
    if not 0 < len(grad_rows) <= MAX_GRAD_BSDFS:
        raise ValueError(f"grad_rows: want 1..{MAX_GRAD_BSDFS} rows, got {grad_rows}")
    if pix.device.type == "cpu":
        return render_mega_bvh_fwdgrad_rows_ref(scene, cfg, pix, timestamp0, grad_rows)
    if pix.device.type != "cuda":
        raise ValueError(f"render_mega_bvh_fwdgrad_rows: unsupported device {pix.device}")
    from .. import _build
    from ..bvh import ftb
    from .mega_bvh import pack_attr

    lib = _build.load()
    R, Lg = len(grad_rows), _grad_lights(scene)
    pairs, woop_rows, walk_ip = ftb.walk_tables(scene)
    attr = pack_attr(scene, cfg.light_sampling)
    attr = torch.cat([attr, scene.tri_bsdf[:, None].to(torch.float32)], dim=1).contiguous()
    _, _, light, camv = _pack_tables(scene)
    env = pack_env(scene)
    ip, fp = kernel_params(scene, cfg, timestamp0, power_pick=cfg.light_sampling == "power",
                           textured=scene.has_textures, attr_stride=attr.shape[1])
    rows = torch.tensor(grad_rows, dtype=torch.int32, device=pix.device)
    kd = scene.bsdf_params[list(grad_rows), 0:3].contiguous()
    light_cdf = scene.light_cdf.contiguous()
    light_prob = scene.light_prob.contiguous()
    pix = pix.contiguous()
    out, rays, parts = _launch_planes(pix, 3 * R + 6 * Lg)
    with torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gst_mega_bvh_grad(
            pix.data_ptr(), pix.numel(), pairs.data_ptr(), woop_rows.data_ptr(),
            walk_ip.data_ptr(), attr.data_ptr(),
            light.data_ptr(), light_cdf.data_ptr(), light_prob.data_ptr(), camv.data_ptr(),
            env.data_ptr(), ip.ctypes.data, fp.ctypes.data, int(cfg.mega_sync_regen),
            rows.data_ptr(), kd.data_ptr(), R, Lg,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), rays.data_ptr(),
            parts.data_ptr(), stream)
    _build.check(rc, "render_mega_bvh_fwdgrad_rows")
    profiling.count("render_mega_bvh_fwdgrad_rows.launch")
    return out[0], out[1], out[2], rays, parts


class _BlocksDiff(torch.autograd.Function):
    """Per-lane radiance sums (n, LANES, 3) over cfg.spp from one
    fused-gradient launch; the backward pass contracts the saved partials
    with the per-lane cotangent (mega_grad.py:748-806)."""

    @staticmethod
    def forward(ctx, bp, te, le, scene, cfg, pix, timestamp0, bvh, grad_rows, Lg):
        sc = scene.replace(bsdf_params=bp.detach(), tri_emission=te.detach(),
                           light_emission=le.detach())
        if bvh:
            rr, rg, rb, _, parts = render_mega_bvh_fwdgrad_rows(sc, cfg, pix, timestamp0,
                                                                grad_rows)
        else:
            rr, rg, rb, _, parts = render_mega_fwdgrad_rows(sc, cfg, pix, timestamp0)
        ctx.save_for_backward(parts)
        ctx.meta = (sc, grad_rows, Lg)
        return torch.stack([rr, rg, rb], dim=-1)

    @staticmethod
    def backward(ctx, g):
        (parts,) = ctx.saved_tensors
        sc, grad_rows, Lg = ctx.meta
        with profiling.stage("gst.grad.contract"):
            d_kd, d_te_l, d_le = _contract_partials(parts, g, len(grad_rows), Lg)
            d_bp, d_te, d_le = _scatter_grads(sc, grad_rows, Lg, d_kd, d_te_l, d_le)
        return d_bp, d_te, d_le, None, None, None, None, None, None, None


def render_blocks_diff(scene: SceneData, cfg: RenderConfig, pix, timestamp0, bvh: bool,
                       grad_rows=None):
    """Differentiable per-lane radiance sums over cfg.spp (no /spp, no
    scatter) for explicit pixel rows pix (n, LANES) int32: K5 (bvh False:
    every BSDF row and light) or K6 (bvh True: grad_rows, default
    mega_bvh_grad_rows, and every light of a scene of at most
    MAX_GRAD_LIGHTS).  Returns (n, LANES, 3); gradients reach
    scene.bsdf_params (kd columns), scene.tri_emission and
    scene.light_emission from the same launch's partials, over these rows
    only (mega_grad.py:809-820).  The JAX package lays its BVH blocks out
    by mega_bvh_stream; the port keeps raster rows (mega.pix_rows)."""
    if bvh:
        if not mega_bvh_grad_eligible(scene, cfg):
            raise ValueError("render_blocks_diff: (scene, cfg) is not K6-eligible")
        rows = mega_bvh_grad_rows(scene) if grad_rows is None else tuple(grad_rows)
        lg = _grad_lights(scene)
    else:
        if not mega_grad_eligible(scene, cfg):
            raise ValueError("render_blocks_diff: (scene, cfg) is not K5-eligible")
        rows, lg = tuple(range(scene.bsdf_kind.shape[0])), scene.num_lights
    return _BlocksDiff.apply(scene.bsdf_params, scene.tri_emission, scene.light_emission,
                             scene, cfg, pix, int(timestamp0), bool(bvh), rows, lg)


def _image(scene: SceneData, cfg: RenderConfig, pix, timestamp0, bvh, grad_rows=None):
    """Image (H, W, 3) of render_blocks_diff over a whole frame's raster
    rows pix (pix_rows): the first n_pixels lanes, divided by cfg.spp."""
    n_pixels = cfg.width * cfg.height
    rad = render_blocks_diff(scene, cfg, pix, timestamp0, bvh, grad_rows)
    return (rad.reshape(-1, 3)[:n_pixels] / cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_mega_diff(scene: SceneData, cfg: RenderConfig, timestamp0=0):
    """Differentiable render through K5: (H, W, 3) image whose gradient
    w.r.t. scene.bsdf_params (kd columns), scene.tri_emission and
    scene.light_emission comes from the same launch's partials (zeros
    elsewhere).  Raises when the (scene, cfg) is not K5-eligible.  The
    frame's rows are K5's first piece of "gst.k5.prep"; _launch_k5 makes
    the rest."""
    with profiling.stage("gst.k5.prep"):
        pix = pix_rows(cfg, scene.device)
    return _image(scene, cfg, pix, timestamp0, False)


def render_mega_bvh_diff(scene: SceneData, cfg: RenderConfig, timestamp0=0, grad_rows=None):
    """Differentiable render through K6: gradients of the kd columns of
    grad_rows (default mega_bvh_grad_rows) and, for scenes of at most
    MAX_GRAD_LIGHTS lights, of emitter radiance; zeros elsewhere.  One
    launch at full spp (the TPU's spp chunking is not carried over).
    Raises when the (scene, cfg) is not K6-eligible."""
    return _image(scene, cfg, pix_rows(cfg, scene.device), timestamp0, True, grad_rows)
