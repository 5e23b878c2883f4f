"""The plain path tracer the benchmark holds the port to.

A frozen copy of the estimator of gpuspectral_tpu_torch/integrator/
path_tracer.py:_bounce (its brute-force branch, which the megakernels'
plain versions run), with this package's scenes and intersector: camera
rays, the 8 BSDFs, NEE with MIS over the area lights and the environment,
the firefly clamp, Russian roulette, and the same counter-based RNG draws,
so that a pixel's samples follow the paths the kernels follow.

Unlike the port's persistent-lane wavefront, every (pixel, sample) pair is
a lane of its own and all lanes start together; a lane's path, and so its
radiance and its rays, depend only on (pixel, sample, timestamp), so the
order is free.  A pixel's samples are summed after they end (the kernels
add them up bounce by bounce in one lane: the same terms, another order).

`state_dtype` rounds the path state (origins, directions, throughput, the
radiance sums and the MIS weights) to that type after every bounce: the
benchmark's control, the reference a precision below the one it states.
A `Tally` counts the work of the traced rays for the roofline shares.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import envmap as env_mod
from . import math3d as m3
from . import rng
from . import sampling as smp
from .bsdf import eval_bsdf, is_transmission, sample_bsdf
from .isect import BIG, Intersector

CH_BSDF_SELECT, CH_BSDF_U1, CH_BSDF_U2 = 0, 1, 2
CH_LIGHT_INDEX, CH_LIGHT_U1, CH_LIGHT_U2 = 3, 4, 5
CH_RR, CH_JITTER_X, CH_JITTER_Y = 6, 7, 8
CH_ENV_U1, CH_ENV_U2, CH_ENV_SELECT = 9, 10, 11
LANE_CHUNK = 1 << 18  # lanes traced together


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The render settings the reference reads (the port's RenderConfig
    defaults)."""

    width: int
    height: int
    spp: int
    max_depth: int = 50
    rr_start_depth: int = 10
    rr_clamp_min: float = 0.05
    firefly_clamp: float = 20.0
    nee: bool = True
    jitter: bool = False
    shadow_epsilon: float = 0.01
    origin_epsilon: float = 1e-4
    light_sampling: str = "uniform"
    mis_mode: str = "reference"
    tex_mode: str = "nearest"  # "corners": the fused-BVH kernels' texture blend


@dataclasses.dataclass
class Tally:
    """The work of the traced rays: closest and shadow rays, hit (shaded)
    vertices, the Woop tests of a scan in index order (a closest ray tests
    every triangle, a shadow ray those up to its first occluder), and the
    rays of every `stride`-th lane, for a walk that counts other tests."""

    closest: int = 0
    shadow: int = 0
    hits: int = 0
    woop_tests: int = 0
    stride: int = 0  # 0: keep no rays
    rays: list = dataclasses.field(default_factory=list)

    def record(self, keep, origin, direction, t_min, t_max, any_hit: bool):
        if self.stride <= 0 or not bool(keep.any()):
            return
        self.rays.append((origin[keep], direction[keep], t_min[keep], t_max[keep],
                          torch.full((int(keep.sum()),), any_hit, device=origin.device)))


def generate_rays(scene, cfg: RefConfig, pixel, seed):
    """Pinhole camera rays (gpuspectral_tpu_torch/scene/camera.py)."""
    px = (pixel % cfg.width).to(torch.float32)
    py = torch.div(pixel, cfg.width, rounding_mode="floor").to(torch.float32)
    if cfg.jitter:
        px = px + rng.uniform(seed, 0xFFFF, CH_JITTER_X)
        py = py + rng.uniform(seed, 0xFFFF, CH_JITTER_Y)
    xy_x = px - cfg.width / 2.0
    xy_y = py - cfg.height / 2.0
    half = torch.tensor(max(cfg.width, cfg.height) / 2.0, dtype=torch.float32,
                        device=scene.device)
    z = half / torch.tan(scene.cam_fov / 2.0)
    d = m3.normalize(torch.stack([-xy_x, -xy_y, z.expand(xy_x.shape)], dim=-1))
    r = scene.cam_to_world[:3, :3]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dw = torch.stack([r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz,
                      r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz,
                      r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz], dim=-1)
    return scene.cam_to_world[:3, 3].expand(dw.shape), dw


def _texture_lookup(scene, uv_c, tex_id, bu, bv):
    bw = 1.0 - bu - bv
    uv = bw[:, None] * uv_c[:, 0] + bu[:, None] * uv_c[:, 1] + bv[:, None] * uv_c[:, 2]
    res = scene.textures.shape[1]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    px = torch.clamp((u * res).to(torch.int64), 0, res - 1)
    py = torch.clamp(((1.0 - v) * res).to(torch.int64), 0, res - 1)
    idx = torch.clamp(tex_id.long(), min=0) * res * res + py * res + px
    return torch.where((tex_id >= 0)[:, None], scene.textures.reshape(-1, 3)[idx], 1.0)


def corner_texture_rows(scene):
    """(T, 9): the nearest texel at each corner's uv."""
    t = scene.tri_uv.shape[0]
    tex_id = scene.bsdf_tex[scene.tri_bsdf.long()]
    zeros = torch.zeros((t,), dtype=torch.float32, device=scene.device)
    return torch.cat([_texture_lookup(scene, scene.tri_uv, tex_id, zeros + bu, zeros + bv)
                      for bu, bv in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))], dim=1)


def tables(scene, cfg: RefConfig) -> dict:
    """Per-render tables: triangle rows, light rows, corner texels and the
    intersector."""
    t = scene.tri_pos.shape[0]
    bsdf = scene.tri_bsdf.long()
    cols = [scene.tri_pos.reshape(t, 9), scene.tri_nrm.reshape(t, 9), scene.tri_emission,
            scene.tri_twofaced[:, None].float(), scene.tri_light_idx[:, None].float(),
            scene.bsdf_kind[bsdf][:, None].float(), scene.bsdf_params[bsdf]]
    if scene.has_textures:
        cols += [scene.tri_uv.reshape(t, 6), scene.bsdf_tex[bsdf][:, None].float()]
    out = dict(tri=torch.cat(cols, dim=1),
               light=torch.cat([scene.light_pos.reshape(-1, 9), scene.light_emission], dim=1),
               isect=Intersector(scene.woop, scene.tri_pos))
    if scene.has_textures and cfg.tex_mode == "corners":
        out["corner_tex"] = corner_texture_rows(scene)
    return out


def _fresh(origin, direction, seed):
    r, dev, f32 = origin.shape[0], origin.device, torch.float32
    return dict(origin=origin, direction=direction, seed=seed,
                weight=torch.ones((r, 3), dtype=f32, device=dev),
                direct_weight=torch.ones((r,), dtype=f32, device=dev),
                prev_pdf=torch.ones((r,), dtype=f32, device=dev),
                prev_nee=torch.zeros((r,), dtype=torch.bool, device=dev),
                prev_nee_any=torch.zeros((r,), dtype=torch.bool, device=dev),
                was_delta=torch.zeros((r,), dtype=torch.bool, device=dev),
                count_emitted=torch.ones((r,), dtype=torch.bool, device=dev),
                done=torch.zeros((r,), dtype=torch.bool, device=dev),
                radiance=torch.zeros((r, 3), dtype=f32, device=dev),
                rays_traced=torch.zeros((r,), dtype=torch.int32, device=dev))


def bounce(scene, cfg: RefConfig, depth: int, state: dict, tabs: dict,
           tally: Optional[Tally] = None, grad_hook=None) -> dict:
    """One bounce of every lane of `state` (all alive: the caller drops
    finished lanes).  The estimator of path_tracer.py:_bounce, brute-force
    branch, line for line."""
    origin, direction, seed = state["origin"], state["direction"], state["seed"]
    r = origin.shape[0]
    dev = origin.device
    alive = ~state["done"]
    zeros = torch.zeros((r,), dtype=torch.float32, device=dev)
    t, prim, bu, bv = tabs["isect"].closest(origin, direction, zeros,
                                             torch.where(alive, BIG, -BIG))
    rows = tabs["tri"][torch.clamp(prim, min=0).long()]
    pos_c = rows[:, 0:9].reshape(r, 3, 3)
    nrm_c = rows[:, 9:18].reshape(r, 3, 3)
    emission = rows[:, 18:21]
    twofaced = rows[:, 21] > 0.5
    tri_lidx = torch.round(rows[:, 22]).to(torch.int32)
    bkind = torch.round(rows[:, 23]).to(torch.int32)
    bparams = rows[:, 24:36]
    gn = m3.normalize(m3.cross(pos_c[:, 1] - pos_c[:, 0], pos_c[:, 2] - pos_c[:, 0]))
    hit = (prim >= 0) & alive
    miss = (~(prim >= 0)) & alive

    if scene.has_textures:
        if "corner_tex" in tabs:
            c = tabs["corner_tex"][torch.clamp(prim, min=0).long()]
            bw_ = 1.0 - bu - bv
            mod = bw_[:, None] * c[:, 0:3] + bu[:, None] * c[:, 3:6] + bv[:, None] * c[:, 6:9]
        else:
            mod = _texture_lookup(scene, rows[:, 36:42].reshape(r, 3, 2),
                                  torch.round(rows[:, 42]).to(torch.int64), bu, bv)
        bparams = torch.cat([bparams[:, 0:3] * mod, bparams[:, 3:]], dim=1)

    t_safe = torch.where(hit, t, 1.0)
    position = m3.fma(direction, t_safe[..., None], origin)
    bw = 1.0 - bu - bv
    sn = m3.normalize(bw[..., None] * nrm_c[:, 0] + bu[..., None] * nrm_c[:, 1]
                      + bv[..., None] * nrm_c[:, 2])
    sn = torch.where(m3.dot(sn, gn)[..., None] < 0.0, -sn, sn)
    backface = m3.dot(gn, -direction) < 0.0
    emissive = torch.any(emission != 0.0, dim=-1)
    flip = backface & twofaced & (~emissive)
    gn = torch.where(flip[..., None], -gn, gn)
    sn = torch.where(flip[..., None], -sn, sn)
    tg, bn, nn = m3.onb_create(sn)
    wo = m3.normalize(m3.onb_world_to_local(tg, bn, nn, -direction))

    bounce_t = torch.full_like(seed, depth)
    u_sel = rng.uniform(seed, bounce_t, CH_BSDF_SELECT)
    u1 = rng.uniform(seed, bounce_t, CH_BSDF_U1)
    u2 = rng.uniform(seed, bounce_t, CH_BSDF_U2)
    wi_local, f, pdf, delta = sample_bsdf(bparams, bkind, wo, u_sel, u1, u2,
                                          present=scene.kinds_present)
    now = torch.abs(wi_local[..., 2])
    wi_world = m3.onb_local_to_world(tg, bn, nn, wi_local)
    transmission = is_transmission(bkind)

    if cfg.light_sampling == "power":
        u_l = rng.uniform(seed, bounce_t, CH_LIGHT_INDEX)
        lidx = torch.clamp(torch.searchsorted(scene.light_cdf, u_l), 0, scene.num_lights - 1)
        select_pdf = scene.light_prob[lidx]
    else:
        lidx = rng.random_bits(seed, bounce_t, CH_LIGHT_INDEX) % scene.num_lights
        select_pdf = 1.0 / scene.num_lights
    lrows = tabs["light"][lidx]
    lv = lrows[:, 0:9].reshape(-1, 3, 3)
    lemit = lrows[:, 9:12]
    lu1 = rng.uniform(seed, bounce_t, CH_LIGHT_U1)
    lu2 = rng.uniform(seed, bounce_t, CH_LIGHT_U2)
    light_pos, light_emitted, light_pdf = smp.sample_triangle_light(
        lv[:, 0], lv[:, 1], lv[:, 2], lemit, position, lu1, lu2)
    light_pdf = light_pdf * select_pdf
    ldelta = light_pos - position
    ldist = m3.length(ldelta)
    ldir = ldelta / torch.clamp(ldist, min=1e-12)[..., None]
    if grad_hook is not None:
        lnormal = m3.normalize(m3.cross(lv[:, 1] - lv[:, 0], lv[:, 2] - lv[:, 0]))
        lfront = (m3.dot(-ldir, lnormal) > 0.0).to(torch.float32)

    p_env = 0.0
    env_nee = scene.has_envmap and cfg.nee
    if env_nee:
        p_env = 0.5 if scene.has_area_lights else 1.0
        eu1 = rng.uniform(seed, bounce_t, CH_ENV_U1)
        eu2 = rng.uniform(seed, bounce_t, CH_ENV_U2)
        if scene.has_area_lights:
            env_pick = rng.uniform(seed, bounce_t, CH_ENV_SELECT) < p_env
        else:
            env_pick = torch.ones_like(hit)
        env_dir, env_pdf = env_mod.sample_envmap(scene.envmap, scene.envmap_rot, scene.envmap_cdf,
                                                 scene.envmap_pdf, eu1, eu2)
        env_l = env_mod.eval_envmap(scene.envmap, scene.envmap_rot, env_dir)
        ldir = torch.where(env_pick[..., None], env_dir, ldir)
        ldist = torch.where(env_pick, BIG, ldist)
        light_emitted = torch.where(env_pick[..., None], env_l, light_emitted)
        light_pdf = torch.where(env_pick, env_pdf * p_env, light_pdf * (1.0 - p_env))

    w_light_local = m3.onb_world_to_local(tg, bn, nn, ldir)
    nol = torch.abs(m3.dot(sn, ldir))
    f_light, light_eval_pdf, _ = eval_bsdf(bparams, bkind, wo, w_light_local,
                                           present=scene.kinds_present)
    front_ok = (m3.dot(gn, -direction) > 0.0) & (m3.dot(gn, ldir) > 0.0)
    nee_candidate = hit & (~delta) & (front_ok | transmission)
    if not cfg.nee:
        nee_candidate = torch.zeros_like(nee_candidate)

    sh_tmin = torch.full((r,), cfg.shadow_epsilon, dtype=torch.float32, device=dev)
    sh_tmax = ldist - cfg.shadow_epsilon
    cand = torch.nonzero(nee_candidate, as_tuple=True)[0]
    shadowed = torch.zeros((r,), dtype=torch.bool, device=dev)
    if cand.numel():
        occ, first = tabs["isect"].any_hit(position[cand], ldir[cand], sh_tmin[cand],
                                           sh_tmax[cand])
        shadowed[cand] = occ
        if tally is not None:
            tally.woop_tests += int(torch.where(first >= 0, first + 1, scene.num_tris).sum())
            tally.record(state["lane"][cand] % max(tally.stride, 1) == 0, position[cand],
                         ldir[cand], sh_tmin[cand], sh_tmax[cand], True)
    if tally is not None:
        tally.closest += int(alive.sum())
        tally.shadow += int(cand.numel())
        tally.hits += int(hit.sum())
        tally.woop_tests += int(alive.sum()) * scene.num_tris
        tally.record(state["lane"] % max(tally.stride, 1) == 0, origin, direction, zeros,
                     torch.full_like(zeros, BIG), False)
    nee_done = nee_candidate & (~shadowed) & (light_pdf != 0.0)

    mis_bsdf_pdf = torch.where(env_pick, light_eval_pdf, pdf) if env_nee else pdf
    w_mis = smp.power_heuristic(light_pdf, mis_bsdf_pdf)
    nee_contrib = (w_mis[..., None] * nol[..., None] * f_light * state["weight"] * light_emitted
                   / torch.clamp(light_pdf, min=1e-12)[..., None])
    emitted = torch.where(nee_done[..., None], nee_contrib, 0.0)

    light_flag = (m3.dot(gn, -direction) > 0.0).to(torch.float32)
    ce, wd = state["count_emitted"], state["was_delta"]
    self_emit = emission * light_flag[..., None] * state["weight"]
    if cfg.nee and cfg.mis_mode == "exact":
        e1h = pos_c[:, 1] - pos_c[:, 0]
        e2h = pos_c[:, 2] - pos_c[:, 0]
        area_hit = 0.5 * m3.length(m3.cross(e1h, e2h))
        cos_hit = torch.abs(m3.dot(gn, -direction))
        if cfg.light_sampling == "power":
            sel_hit = scene.light_prob[torch.clamp(tri_lidx, min=0).long()]
        else:
            sel_hit = 1.0 / scene.num_lights
        sel_hit = sel_hit * (1.0 - p_env)
        pdf_hit = t_safe * t_safe / torch.clamp(cos_hit * area_hit, min=1e-12) * sel_hit
        w_emit = torch.where(state["prev_nee"], smp.power_heuristic(state["prev_pdf"], pdf_hit),
                             1.0)
        emitted = emitted + torch.where(((~ce) & (~wd))[..., None], w_emit[..., None] * self_emit,
                                        0.0)
        emitted = emitted + torch.where((ce | wd)[..., None], self_emit, 0.0)
    elif cfg.nee:
        emitted = emitted + torch.where(((~ce) & (~wd))[..., None],
                                        state["direct_weight"][..., None] * self_emit, 0.0)
        emitted = emitted + torch.where((ce | wd)[..., None], self_emit, 0.0)
    else:
        emitted = emitted + self_emit
    emitted = torch.where(hit[..., None], emitted, 0.0)

    if scene.has_envmap:
        env_miss = env_mod.eval_envmap(scene.envmap, scene.envmap_rot, direction)
        if cfg.nee:
            pdf_e = env_mod.envmap_pdf(scene.envmap_pdf, scene.envmap_rot, direction) * p_env
            w_env = torch.where(state["prev_nee_any"] & (~wd),
                                smp.power_heuristic(state["prev_pdf"], pdf_e), 1.0)
            scale_env = torch.where(ce, 1.0, w_env)
        else:
            scale_env = torch.ones_like(state["prev_pdf"])
        emitted = emitted + torch.where(miss[..., None],
                                        scale_env[..., None] * state["weight"] * env_miss, 0.0)

    invalid_hemi = (m3.dot(wi_world, gn) <= 0.0) & (~transmission)
    self_isect = (m3.dot(gn, -direction) <= 0.0) & (~transmission)
    bad_pdf = (~torch.isfinite(pdf)) | (~m3.is_finite3(f)) | (pdf == 0.0)
    terminate = hit & (invalid_hemi | self_isect | bad_pdf)
    new_direct_weight = torch.where(nee_done, smp.power_heuristic(pdf, light_pdf), 1.0)
    offset_n = m3.faceforward(gn, -wi_world, gn)
    new_origin = m3.fma(offset_n, torch.full_like(offset_n, cfg.origin_epsilon), position)
    new_weight = state["weight"] * f * (now * (1.0 / torch.clamp(pdf, min=1e-12)))[..., None]

    cont = hit & (~terminate)
    out = dict(state)
    out["rays_traced"] = (state["rays_traced"] + alive.to(torch.int32)
                          + nee_candidate.to(torch.int32))
    out["origin"] = torch.where(cont[..., None], new_origin, origin)
    out["direction"] = torch.where(cont[..., None], wi_world, direction)
    out["weight"] = torch.where(cont[..., None], new_weight, state["weight"])
    out["direct_weight"] = torch.where(cont, new_direct_weight, state["direct_weight"])
    out["prev_pdf"] = torch.where(cont, pdf, state["prev_pdf"])
    out["prev_nee"] = torch.where(cont, nee_done, state["prev_nee"])
    out["prev_nee_any"] = torch.where(cont, nee_candidate, state["prev_nee_any"])
    out["was_delta"] = torch.where(cont, delta, wd)
    out["count_emitted"] = torch.where(cont, False, ce)
    out["done"] = state["done"] | miss | terminate
    keep = torch.all(emitted < cfg.firefly_clamp, dim=-1)
    out["radiance"] = state["radiance"] + torch.where((alive & keep)[..., None], emitted, 0.0)

    if grad_hook is not None:
        if cfg.nee and cfg.mis_mode == "exact":
            emit_w = torch.where((~ce) & (~wd), w_emit, 1.0)
        elif cfg.nee:
            emit_w = torch.where((~ce) & (~wd), state["direct_weight"], 1.0)
        else:
            emit_w = torch.ones_like(light_flag)
        bidx = scene.tri_bsdf[torch.clamp(prim, min=0).long()]
        out = grad_hook(out, dict(
            depth=depth, bidx=bidx, lhit=tri_lidx, weight=state["weight"], hit=hit,
            acc=alive & keep, cont=cont, nee_done=nee_done,
            nee_s=w_mis * nol * (1.0 / torch.clamp(light_pdf, min=1e-12)), f_light=f_light,
            lfront=lfront, lemit=lemit, lidx=lidx, emit_w=emit_w, light_flag=light_flag,
            e=emitted))

    if_rr = depth > cfg.rr_start_depth
    q = torch.clamp(torch.amax(out["weight"], dim=-1), cfg.rr_clamp_min, 1.0)
    rr_kill = if_rr & (rng.uniform(seed, bounce_t, CH_RR) > q)
    out["weight"] = torch.where((if_rr & ~rr_kill)[..., None], out["weight"] / q[..., None],
                                out["weight"])
    out["done"] = out["done"] | rr_kill
    return out


_ROUNDED = ("origin", "direction", "weight", "radiance", "direct_weight", "prev_pdf")


def trace(scene, cfg: RefConfig, pixel, sample, timestamp0: int, tabs: dict,
          tally: Optional[Tally] = None, state_dtype=None, grad_hook=None, hook_state=None,
          lane0: int = 0):
    """Trace the lanes (pixel[i], sample[i]) to the end of their paths.
    Returns the final state of every lane (radiance, rays_traced and the
    keys of hook_state among them), in lane order."""
    pixel = rng.as_u32(pixel)
    seed = rng.pixel_seed(pixel, (rng.as_u32(sample) + int(timestamp0)) & 0xFFFFFFFF)
    o, d = generate_rays(scene, cfg, pixel, seed)
    state = _fresh(o, d, seed)
    state["lane"] = torch.arange(pixel.shape[0], device=pixel.device) + int(lane0)
    state.update(hook_state or {})
    n = pixel.shape[0]
    final = {k: v.clone() for k, v in state.items()}
    idx = torch.arange(n, device=pixel.device)
    for depth in range(cfg.max_depth + 1):
        if idx.numel() == 0:
            break
        state = bounce(scene, cfg, depth, state, tabs, tally, grad_hook)
        if state_dtype is not None:
            for k in _ROUNDED:
                state[k] = state[k].to(state_dtype).to(torch.float32)
        ended = state["done"] | (depth + 1 >= cfg.max_depth + 1)
        for k, v in state.items():
            final[k][idx[ended]] = v[ended]
        live = ~ended
        idx = idx[live]
        state = {k: v[live] for k, v in state.items()}
    return final


def render_pixels(scene, cfg: RefConfig, pixels, timestamp0: int, tally: Optional[Tally] = None,
                  state_dtype=None):
    """Sums over cfg.spp samples of each pixel's radiance (P, 3) and rays
    (P,) int64, at the frame of timestamp0 (sample s draws the stream of
    timestamp timestamp0 + s, as the kernels' frames do)."""
    tabs = tables(scene, cfg)
    p = pixels.shape[0]
    dev = pixels.device
    rad = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((p,), dtype=torch.int64, device=dev)
    lanes = p * cfg.spp
    for b in range(0, lanes, LANE_CHUNK):
        lane = torch.arange(b, min(lanes, b + LANE_CHUNK), device=dev)
        who, sample = lane // cfg.spp, lane % cfg.spp
        st = trace(scene, cfg, pixels[who], sample, timestamp0, tabs, tally, state_dtype,
                   lane0=b)
        rad.index_add_(0, who, st["radiance"])
        rays.index_add_(0, who, st["rays_traced"].to(torch.int64))
    return rad, rays
