"""Wavefront path tracer (port of gpuspectral_tpu/integrator/path_tracer.py,
the forward path).

One vectorized bounce step (`_bounce`) over a batch of lanes, iterated until
every lane is done; `trace_wavefront` keeps each lane busy with its own
pixel's samples, regenerating a fresh camera path the moment the previous
one ends.  Reference semantics (raygen.rgen / rayhit.rchit): firefly clamp,
Russian roulette after depth 10, NEE with power-heuristic MIS and the
countEmitted / wasDelta / directWeight bookkeeping, two-faced flip for
non-emitters, invalid-hemisphere / self-intersection / non-finite
terminations, shadow epsilon 0.01, origin offset 1e-4.  Beyond the
reference, as the JAX package: environment emitters (miss shading and an
environment NEE strategy mixed with the area lights) and textures.

RNG channel layout per bounce (as the JAX package):
  ch 0..2 bsdf (select, u1, u2), ch 3 light index bits, ch 4..5 light
  triangle (u1, u2), ch 6 russian roulette, ch 7..8 subpixel jitter,
  ch 9..11 environment NEE (u1, u2, strategy select).

Intersection.  Brute force (cfg.use_bvh False): for CUDA tensors with
intersector "auto" or "pallas" the kernels of ops/cuda_isect.py (K2); with
"woop", or "auto" for CPU tensors, the plain torch Woop scans; with "mt"
the Moller-Trumbore scans of ops/intersect.py.  BVH (cfg.use_bvh), with
intersector "pallas" or, for CUDA tensors, "auto": the wrappers that
cfg.bvh_kernel names in _BVH_KERNELS, "ftb" (the walk of bvh/ftb.py, K3a /
K3b), "cluster" (the cluster sweep of bvh/cluster_sweep.py: votes K7c,
then K7d / K7e), "dfs" (the block-gated depth-first walk of
bvh/dfs_sweep.py, K7f / K7g) or "binned" (the per-ray-vote binned sweep of
bvh/binned.py, K7a / K7b), with optional ray sorting (cfg.sort_rays)
and shadow-ray sorting (cfg.shadow_sort) for any; they run their plain
versions for CPU tensors and return the hit triangle's attribute rows.  With "woop" or
"mt" (or "auto" for CPU tensors) and cfg.use_bvh, the packet traversal of
bvh/traverse.py (Moller-Trumbore leaves, packets of cfg.packet_size rays),
as the JAX wavefront runs its XLA traversal there: K7h (bvh/kernels.py,
csrc/traverse.cu) for CUDA tensors, its plain torch version for CPU
tensors, over the packed leaf rows that _tables builds once per render.
This module is also the plain version of the four megakernels
(integrator/mega.py, integrator/mega_bvh.py and, with a gradient hook in
`_bounce`, integrator/mega_grad.py); the BVH ones name their intersector
(`bvh_isect`, the plain K3 scans) instead of the traversal.

Differentiable mode (`trace_rays` / `render_sample` with
differentiable=True, path_tracer.py:711-760, 924-936): torch autograd
through the bounce loop.  With cfg.grad_remat "bounce" every bounce runs
under torch.utils.checkpoint, so the backward pass replays it instead of
storing its intermediates; the counter-based RNG makes the replay exact
(path-replay backprop).  With "sample" the caller checkpoints whole
samples.  The intersection kernels have no derivative of their own:
closest hits go through `cuda_isect.closest_diff`, `ftb.ftb_closest_diff`,
`cluster_sweep.cluster_closest_diff`, `dfs_sweep.dfs_closest_diff` or
`binned.binned_closest_diff`, whose backward re-evaluates the hit
triangle's Woop test in plain torch, or, with a BVH and intersector "woop"
/ "mt", through `kernels.traverse_closest_diff` (K7h forward on the card,
the plain traversal for CPU tensors; the hit triangle's Moller-Trumbore
test re-evaluated in the backward); the scans are plain torch,
differentiated as they are.  Shadow rays and intersector tables are
detached (visibility is a step function, as the JAX package's
stop_gradient says).
"""

from __future__ import annotations

import torch

from ..bsdf.dispatch import eval_bsdf, is_transmission, sample_bsdf
from ..bvh import binned, cluster_sweep, dfs_sweep, ftb, kernels, traverse
from ..ops import cuda_isect
from ..ops import intersect as isect
from ..ops import math3d as m3
from ..ops import rng
from ..ops import sampling as smp
from ..ops import woop as woop_mod
from ..scene.camera import generate_rays
from ..scene.data import SceneData
from ..utils.config import RenderConfig
from . import envmap as env_mod

CH_BSDF_SELECT = 0
CH_BSDF_U1 = 1
CH_BSDF_U2 = 2
CH_LIGHT_INDEX = 3
CH_LIGHT_U1 = 4
CH_LIGHT_U2 = 5
CH_RR = 6
CH_JITTER_X = 7
CH_JITTER_Y = 8
CH_ENV_U1 = 9
CH_ENV_U2 = 10
CH_ENV_SELECT = 11

_BIG = 1e30

# the BVH intersector of the megakernels' plain versions (bvh_isect of
# _bounce): the plain K3 scans, which K4 and K6 equal
PLAIN_K3 = (ftb.ftb_closest_ref, ftb.ftb_any_ref)

# cfg.bvh_kernel -> (module, closest hit, differentiable closest hit, any
# hit).  The wrappers are looked up by name at each bounce, so one that is
# patched onto its module (a tally of the kernels' work) is the one called.
_BVH_KERNELS = {
    "ftb": (ftb, "ftb_closest", "ftb_closest_diff", "ftb_any"),
    "cluster": (cluster_sweep, "cluster_closest", "cluster_closest_diff", "cluster_any"),
    "dfs": (dfs_sweep, "dfs_closest", "dfs_closest_diff", "dfs_any"),
    "binned": (binned, "binned_closest", "binned_closest_diff", "binned_any"),
}


def _resolve_intersector(scene: SceneData, cfg: RenderConfig) -> str:
    """"pallas" (the CUDA kernels, or their plain versions for CPU tensors),
    "woop" or "mt" (the plain torch scans, or with cfg.use_bvh the packet
    traversal: K7h for CUDA tensors)."""
    isector = cfg.intersector
    if cfg.use_bvh and cfg.bvh_kernel not in _BVH_KERNELS:
        raise NotImplementedError(
            f"bvh_kernel {cfg.bvh_kernel!r} is not a BVH kernel of the port (have: "
            + ", ".join(_BVH_KERNELS) + ")")
    if isector in ("auto", "mega", "mega_bvh"):
        return "pallas" if scene.device.type == "cuda" else "woop"
    if isector in ("pallas", "woop", "mt"):
        return isector
    raise NotImplementedError(f"intersector {isector!r} is not in the port yet")


def _tri_table(scene: SceneData):
    """(T, 36 | 43) packed per-triangle attributes (path_tracer.py:_tri_table);
    textured scenes append corner uvs (36:42) and the texture id (42)."""
    t = scene.tri_pos.shape[0]
    f32 = torch.float32
    bsdf = scene.tri_bsdf.long()
    cols = [
        scene.tri_pos.reshape(t, 9),  # 0:9
        scene.tri_nrm.reshape(t, 9),  # 9:18
        scene.tri_emission,  # 18:21
        scene.tri_twofaced[:, None].to(f32),  # 21
        scene.tri_light_idx[:, None].to(f32),  # 22
        scene.bsdf_kind[bsdf][:, None].to(f32),  # 23
        scene.bsdf_params[bsdf],  # 24:36
    ]
    if scene.has_textures:
        cols.append(scene.tri_uv.reshape(t, 6))  # 36:42
        cols.append(scene.bsdf_tex[bsdf][:, None].to(f32))  # 42
    return torch.cat(cols, dim=1)


def _gather_tri(tri_table, prim):
    """Shading data of (possibly miss = -1) prim ids."""
    rows = tri_table[torch.clamp(prim, min=0).long()]
    r = rows.shape[0]
    return (
        rows[:, 0:9].reshape(r, 3, 3),  # pos
        rows[:, 9:18].reshape(r, 3, 3),  # nrm
        rows[:, 24:36],  # bsdf params
        torch.round(rows[:, 23]).to(torch.int32),  # kind
        rows[:, 18:21],  # emission
        rows[:, 21] > 0.5,  # twofaced
        torch.round(rows[:, 22]).to(torch.int32),  # light idx
        rows,  # full rows (uv / texture columns when textured)
    )


def _safe_inv(x, eps=1e-12):
    return 1.0 / torch.clamp(x, min=eps)


def _texture_lookup(scene: SceneData, uv_c, tex_id, bu, bv):
    """Nearest-texel lookup in the atlas with wrap addressing
    (path_tracer.py:136-149).  uv_c (R,3,2) corner uvs, tex_id (R,) (-1 =
    untextured: 1.0)."""
    bw = 1.0 - bu - bv
    uv = bw[:, None] * uv_c[:, 0] + bu[:, None] * uv_c[:, 1] + bv[:, None] * uv_c[:, 2]
    res = scene.textures.shape[1]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    px = torch.clamp((u * res).to(torch.int64), 0, res - 1)
    py = torch.clamp(((1.0 - v) * res).to(torch.int64), 0, res - 1)
    flat = scene.textures.reshape(-1, 3)
    idx = torch.clamp(tex_id.long(), min=0) * res * res + py * res + px
    return torch.where((tex_id >= 0)[:, None], flat[idx], 1.0)


def corner_texture_rows(scene: SceneData):
    """(T, 9) per-corner texture colours: the nearest texel at each corner's
    uv (mega_bvh.py:787-801).  The fused-BVH megakernel shades a textured hit
    with their barycentric blend instead of a per-hit lookup."""
    t = scene.tri_uv.shape[0]
    tex_id = scene.bsdf_tex[scene.tri_bsdf.long()]
    zeros = torch.zeros((t,), dtype=torch.float32, device=scene.device)
    return torch.cat([_texture_lookup(scene, scene.tri_uv, tex_id, zeros + bu, zeros + bv)
                      for bu, bv in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))], dim=1)


def _fused_bvh(scene: SceneData, cfg: RenderConfig, bvh_isect) -> bool:
    """Whether the closest hits come from a BVH kernel's wrapper (or the
    given `bvh_isect` pair) with the hit triangle's attribute rows, rather
    than from a scan or the packet traversal, which give prim ids only."""
    return cfg.use_bvh and (bvh_isect is not None
                            or _resolve_intersector(scene, cfg) == "pallas")


def _tables(scene: SceneData, cfg: RenderConfig, tex_mode: str, bvh_isect=None):
    """Per-render lookup tables: the triangle rows, or the BVH kernels'
    attribute rows, the light rows, the corner texture colours and, for the
    packet traversal, its packed leaf rows and node rows."""
    out = dict(light=torch.cat([scene.light_pos.reshape(-1, 9), scene.light_emission], dim=1))
    if _fused_bvh(scene, cfg, bvh_isect):
        out["attr"] = ftb.attr_table(scene)
        # extra keywords of the BVH kernels' wrappers: the cluster sweep's
        # supernode boxes, built once here and not at each call
        out["bvh_kw"] = (dict(supernodes=cluster_sweep.scene_supernodes(scene))
                         if bvh_isect is None and cfg.bvh_kernel == "cluster" else {})
    else:
        out["tri"] = _tri_table(scene)
        if cfg.use_bvh:
            out["packed"] = kernels.pack_tris(scene.tri_pos, scene.bvh_clusters,
                                              scene.bvh_leaf_size)
            out["nodes"] = kernels.pack_nodes(scene.bvh_node_min, scene.bvh_node_max,
                                              out["packed"])
    if scene.has_textures and tex_mode == "corners":
        out["corner_tex"] = corner_texture_rows(scene)
    return out


def _bounce(scene: SceneData, cfg: RenderConfig, bounce, state, tables,
            differentiable: bool = False, grad_hook=None, bvh_isect=None):
    """One wavefront bounce (path_tracer.py:_bounce).  `bounce` is the
    per-lane depth (int64 tensor); `state` a dict of per-lane tensors;
    `tables` from _tables (with the same bvh_isect).  differentiable:
    closest hits through the autograd wrappers of the intersection kernels.
    grad_hook(state, ctx) -> state: the fused-gradient kernels' hook
    (integrator/mega_grad.py), called where the JAX megakernel body calls it
    (mega.py:1108-1116).  bvh_isect: (closest, any hit) with the signatures
    of ftb.ftb_closest / ftb_any, run for cfg.use_bvh in place of the
    intersector cfg names (the megakernels' plain versions pass the plain K3
    scans, which K4 and K6 equal)."""
    origin, direction = state["origin"], state["direction"]
    seed = state["seed"]
    alive = ~state["done"]
    r = origin.shape[0]
    dev = origin.device
    isector = _resolve_intersector(scene, cfg)

    t_max0 = torch.where(alive, _BIG, -_BIG)
    zeros = torch.zeros((r,), dtype=torch.float32, device=dev)
    pos_c = area_hit = None
    fused = _fused_bvh(scene, cfg, bvh_isect)
    if fused:
        if bvh_isect is None:
            kernels, closest_name, diff_name, any_name = _BVH_KERNELS[cfg.bvh_kernel]
            closest = getattr(kernels, diff_name if differentiable else closest_name)
            any_hit = getattr(kernels, any_name)
        else:
            closest, any_hit = bvh_isect
        bvh_kw = tables["bvh_kw"]
        t, prim, bu, bv, attrs = closest(scene, origin.contiguous(), direction.contiguous(),
                                         active=alive, attr=tables["attr"], **bvh_kw)
        nrm_c = attrs[:, 0:9].reshape(r, 3, 3)
        gn = attrs[:, 9:12]
        area_hit = attrs[:, 12]
        bsdf_idx, tri_lidx, twofaced = ftb.unpack_meta(attrs[:, 13])
        bparams = scene.bsdf_params[bsdf_idx]
        bkind = scene.bsdf_kind[bsdf_idx]
        emission = torch.where((tri_lidx >= 0)[:, None],
                               scene.light_emission[torch.clamp(tri_lidx, min=0)], 0.0)
        uv_c = attrs[:, 14:20].reshape(r, 3, 2) if scene.has_textures else None
        tex_id = scene.bsdf_tex[bsdf_idx] if scene.has_textures else None
    else:
        if cfg.use_bvh:
            t, prim, bu, bv = traverse.intersect_closest_bvh(
                origin, direction, tables["packed"], scene.bvh_node_min, scene.bvh_node_max,
                scene.bvh_levels, active=alive, packet_size=cfg.packet_size,
                nodes=tables["nodes"])
        elif isector == "pallas" and differentiable:
            t, prim, bu, bv = cuda_isect.closest_diff(origin.contiguous(), direction.contiguous(),
                                                      scene.tri_woop_t, scene.tri_woop, t_max0,
                                                      scene.tri_rows)
        elif isector == "pallas":
            t, prim = cuda_isect.closest_cuda(origin.contiguous(), direction.contiguous(),
                                              scene.tri_woop_t, zeros, t_max0, scene.tri_rows)
            bu, bv = woop_mod._recover_uv(origin, direction, scene.tri_woop, prim,
                                          torch.where(prim >= 0, t, 0.0))
            bu = torch.where(prim >= 0, bu, 0.0)
            bv = torch.where(prim >= 0, bv, 0.0)
        elif isector == "mt":
            t, prim, bu, bv = isect.intersect_closest(origin, direction, scene.tri_pos,
                                                      active=alive, tri_chunk=cfg.tri_chunk)
        else:
            chunk = min(cfg.tri_chunk, scene.tri_woop.shape[0])
            t, prim, bu, bv = woop_mod.closest_scan(origin, direction, scene.tri_woop,
                                                    zeros, t_max0, chunk)
        pos_c, nrm_c, bparams, bkind, emission, twofaced, tri_lidx, rows = _gather_tri(
            tables["tri"], prim)
        gn = m3.normalize(m3.cross(pos_c[:, 1] - pos_c[:, 0], pos_c[:, 2] - pos_c[:, 0]))
        uv_c = rows[:, 36:42].reshape(r, 3, 2) if scene.has_textures else None
        tex_id = torch.round(rows[:, 42]).to(torch.int64) if scene.has_textures else None
    hit = (prim >= 0) & alive
    miss = (~(prim >= 0)) & alive

    if scene.has_textures:
        # modulate the diffuse / reflectance colour by the bound texture
        if "corner_tex" in tables:
            c = tables["corner_tex"][torch.clamp(prim, min=0).long()]
            bw_ = 1.0 - bu - bv
            mod = bw_[:, None] * c[:, 0:3] + bu[:, None] * c[:, 3:6] + bv[:, None] * c[:, 6:9]
        else:
            mod = _texture_lookup(scene, uv_c, tex_id, bu, bv)
        bparams = torch.cat([bparams[:, 0:3] * mod, bparams[:, 3:]], dim=1)

    # hit position (fused, as XLA and the megakernels compute it); miss
    # lanes carry t = 1e30, clamped to keep math finite
    t_safe = torch.where(hit, t, 1.0)
    position = m3.fma(direction, t_safe[..., None], origin)

    bw = 1.0 - bu - bv
    sn = m3.normalize(
        bw[..., None] * nrm_c[:, 0] + bu[..., None] * nrm_c[:, 1] + bv[..., None] * nrm_c[:, 2]
    )
    # orient the interpolated shading normal into the geometric hemisphere
    sn = torch.where(m3.dot(sn, gn)[..., None] < 0.0, -sn, sn)

    # two-faced flip for non-emitters viewed from behind (rayhit.rchit:698-707)
    backface = m3.dot(gn, -direction) < 0.0
    emissive = torch.any(emission != 0.0, dim=-1)
    flip = backface & twofaced & (~emissive)
    gn = torch.where(flip[..., None], -gn, gn)
    sn = torch.where(flip[..., None], -sn, sn)

    tg, bn, nn = m3.onb_create(sn)
    wo = m3.normalize(m3.onb_world_to_local(tg, bn, nn, -direction))

    u_sel = rng.uniform(seed, bounce, CH_BSDF_SELECT)
    u1 = rng.uniform(seed, bounce, CH_BSDF_U1)
    u2 = rng.uniform(seed, bounce, CH_BSDF_U2)
    wi_local, f, pdf, delta = sample_bsdf(
        bparams, bkind, wo, u_sel, u1, u2, present=scene.kinds_present
    )
    now = torch.abs(wi_local[..., 2])
    wi_world = m3.onb_local_to_world(tg, bn, nn, wi_local)

    transmission = is_transmission(bkind)

    # light sampling (rayhit.rchit:147-153,720-729); cfg.light_block > 0
    # shares lane 0's pick draw across aligned lane groups
    pick_seed = seed
    if cfg.light_block > 0:
        nb = r // cfg.light_block
        if nb * cfg.light_block == r:
            pick_seed = seed.reshape(nb, cfg.light_block)[:, 0:1].expand(
                nb, cfg.light_block).reshape(r)
    if cfg.light_sampling == "power":
        u_l = rng.uniform(pick_seed, bounce, CH_LIGHT_INDEX)
        lidx = torch.clamp(
            torch.searchsorted(scene.light_cdf, u_l), 0, scene.num_lights - 1
        )
        select_pdf = scene.light_prob[lidx]
    else:  # uniform, the reference's scheme
        lbits = rng.random_bits(pick_seed, bounce, CH_LIGHT_INDEX)
        lidx = lbits % scene.num_lights
        select_pdf = 1.0 / scene.num_lights
    lrows = tables["light"][lidx]
    lv = lrows[:, 0:9].reshape(-1, 3, 3)
    lemit = lrows[:, 9:12]
    lu1 = rng.uniform(seed, bounce, CH_LIGHT_U1)
    lu2 = rng.uniform(seed, bounce, CH_LIGHT_U2)
    light_pos, light_emitted, light_pdf = smp.sample_triangle_light(
        lv[:, 0], lv[:, 1], lv[:, 2], lemit, position, lu1, lu2
    )
    light_pdf = light_pdf * select_pdf

    ldelta = light_pos - position
    ldist = m3.length(ldelta)
    ldir = ldelta / torch.clamp(ldist, min=1e-12)[..., None]
    if grad_hook is not None:  # the light's facing flag, as the megakernels keep it
        lnormal = m3.normalize(m3.cross(lv[:, 1] - lv[:, 0], lv[:, 2] - lv[:, 0]))
        lfront = (m3.dot(-ldir, lnormal) > 0.0).to(torch.float32)

    # NEE over the environment emitter (path_tracer.py:404-433): with
    # probability p_env the NEE strategy samples the map instead of an area
    # light; pdfs carry the selection probability so the mixture MIS is exact
    p_env = 0.0
    env_nee = scene.has_envmap and cfg.nee
    if env_nee:
        p_env = 0.5 if scene.has_area_lights else 1.0
        eu1 = rng.uniform(seed, bounce, CH_ENV_U1)
        eu2 = rng.uniform(seed, bounce, CH_ENV_U2)
        if scene.has_area_lights:
            env_pick = rng.uniform(seed, bounce, CH_ENV_SELECT) < p_env
        else:
            env_pick = torch.ones_like(hit)
        env_dir, env_pdf = env_mod.sample_envmap(
            scene.envmap, scene.envmap_rot, scene.envmap_cdf, scene.envmap_pdf, eu1, eu2)
        env_l = env_mod.eval_envmap(scene.envmap, scene.envmap_rot, env_dir)
        ldir = torch.where(env_pick[..., None], env_dir, ldir)
        ldist = torch.where(env_pick, _BIG, ldist)
        light_emitted = torch.where(env_pick[..., None], env_l, light_emitted)
        light_pdf = torch.where(env_pick, env_pdf * p_env, light_pdf * (1.0 - p_env))

    w_light_local = m3.onb_world_to_local(tg, bn, nn, ldir)
    nol = torch.abs(m3.dot(sn, ldir))
    f_light, light_eval_pdf, _ = eval_bsdf(
        bparams, bkind, wo, w_light_local, present=scene.kinds_present
    )

    # NEE eligibility (rayhit.rchit:734-736)
    front_ok = (m3.dot(gn, -direction) > 0.0) & (m3.dot(gn, ldir) > 0.0)
    nee_candidate = hit & (~delta) & (front_ok | transmission)
    if not cfg.nee:
        nee_candidate = torch.zeros_like(nee_candidate)

    sh_tmin = torch.full((r,), cfg.shadow_epsilon, dtype=torch.float32, device=dev)
    sh_tmax = ldist - cfg.shadow_epsilon
    if fused:
        if cfg.shadow_sort:
            # sort shadow segments by endpoint + origin so that a warp's rays
            # head for one light region (path_tracer.py:456-473); occlusion
            # is per ray, so the order changes only the cost
            endpoint = light_pos
            if env_nee:
                diag = m3.length(scene.bvh_node_max[0] - scene.bvh_node_min[0])
                endpoint = torch.where(env_pick[..., None], position + ldir * diag, light_pos)
            order = torch.argsort(_segment_sort_key(scene, position, endpoint, nee_candidate),
                                  stable=True)
            occ_s = any_hit(scene, position.detach()[order].contiguous(),
                            ldir.detach()[order].contiguous(), sh_tmin,
                            sh_tmax.detach()[order], active=nee_candidate[order], **bvh_kw)
            shadowed = torch.zeros_like(occ_s).index_copy(0, order, occ_s)
        else:
            shadowed = any_hit(scene, position.detach().contiguous(),
                               ldir.detach().contiguous(), sh_tmin, sh_tmax.detach(),
                               active=nee_candidate, **bvh_kw)
    elif cfg.use_bvh:
        shadowed = traverse.intersect_any_bvh(
            position.detach(), ldir.detach(), tables["packed"], scene.bvh_node_min,
            scene.bvh_node_max, scene.bvh_levels, sh_tmin, sh_tmax.detach(),
            active=nee_candidate, packet_size=cfg.packet_size, nodes=tables["nodes"])
    elif isector == "pallas":
        shadowed = cuda_isect.any_cuda(position.detach().contiguous(),
                                       ldir.detach().contiguous(), scene.tri_woop_t, sh_tmin,
                                       torch.where(nee_candidate, sh_tmax.detach(), -1.0),
                                       scene.tri_rows)
    elif isector == "mt":
        shadowed = isect.intersect_any(position.detach(), ldir.detach(), scene.tri_pos, sh_tmin,
                                       sh_tmax.detach(), active=nee_candidate,
                                       tri_chunk=cfg.tri_chunk)
    else:
        chunk = min(cfg.tri_chunk, scene.tri_woop.shape[0])
        shadowed = woop_mod.any_scan(position.detach(), ldir.detach(), scene.tri_woop, sh_tmin,
                                     torch.where(nee_candidate, sh_tmax.detach(), -1.0), chunk)
    nee_done = nee_candidate & (~shadowed) & (light_pdf != 0.0)

    # MIS complement pdf: the reference reuses the *sampled* BSDF pdf
    # (rayhit.rchit:750-754 quirk); the environment strategy weighs against
    # the exact eval pdf (path_tracer.py:569-577)
    mis_bsdf_pdf = torch.where(env_pick, light_eval_pdf, pdf) if env_nee else pdf
    w_mis = smp.power_heuristic(light_pdf, mis_bsdf_pdf)
    nee_contrib = (
        w_mis[..., None]
        * nol[..., None]
        * f_light
        * state["weight"]
        * light_emitted
        / torch.clamp(light_pdf, min=1e-12)[..., None]
    )
    emitted = torch.where(nee_done[..., None], nee_contrib, 0.0)

    # emitter accumulation with MIS bookkeeping (rayhit.rchit:760-768)
    light_flag = (m3.dot(gn, -direction) > 0.0).to(torch.float32)
    ce = state["count_emitted"]
    wd = state["was_delta"]
    self_emit = emission * light_flag[..., None] * state["weight"]
    if cfg.nee and cfg.mis_mode == "exact":
        # true MIS complement: light pdf of the point the BSDF ray hit
        if area_hit is None:
            e1h = pos_c[:, 1] - pos_c[:, 0]
            e2h = pos_c[:, 2] - pos_c[:, 0]
            area_hit = 0.5 * m3.length(m3.cross(e1h, e2h))
        cos_hit = torch.abs(m3.dot(gn, -direction))
        if cfg.light_sampling == "power":
            sel_hit = scene.light_prob[torch.clamp(tri_lidx, min=0).long()]
        else:
            sel_hit = 1.0 / scene.num_lights
        sel_hit = sel_hit * (1.0 - p_env)  # env / area mixture selection
        pdf_hit = t_safe * t_safe / torch.clamp(cos_hit * area_hit, min=1e-12) * sel_hit
        w_emit = torch.where(
            state["prev_nee"], smp.power_heuristic(state["prev_pdf"], pdf_hit), 1.0
        )
        emitted = emitted + torch.where(
            ((~ce) & (~wd))[..., None], w_emit[..., None] * self_emit, 0.0
        )
        emitted = emitted + torch.where((ce | wd)[..., None], self_emit, 0.0)
    elif cfg.nee:
        emitted = emitted + torch.where(
            ((~ce) & (~wd))[..., None], state["direct_weight"][..., None] * self_emit, 0.0
        )
        emitted = emitted + torch.where((ce | wd)[..., None], self_emit, 0.0)
    else:
        emitted = emitted + self_emit
    emitted = torch.where(hit[..., None], emitted, 0.0)

    if scene.has_envmap:
        # environment radiance on miss, MIS-discounted against the
        # environment NEE strategy (path_tracer.py:628-649)
        env_miss = env_mod.eval_envmap(scene.envmap, scene.envmap_rot, direction)
        if cfg.nee:
            pdf_e = env_mod.envmap_pdf(scene.envmap_pdf, scene.envmap_rot, direction) * p_env
            w_env = torch.where(state["prev_nee_any"] & (~wd),
                                smp.power_heuristic(state["prev_pdf"], pdf_e), 1.0)
            scale_env = torch.where(ce, 1.0, w_env)
        else:
            scale_env = torch.ones_like(state["prev_pdf"])
        emitted = emitted + torch.where(
            miss[..., None], scale_env[..., None] * state["weight"] * env_miss, 0.0)

    # path termination tests (rayhit.rchit:770-784)
    invalid_hemi = (m3.dot(wi_world, gn) <= 0.0) & (~transmission)
    self_isect = (m3.dot(gn, -direction) <= 0.0) & (~transmission)
    bad_pdf = (~torch.isfinite(pdf)) | (~m3.is_finite3(f)) | (pdf == 0.0)
    terminate = hit & (invalid_hemi | self_isect | bad_pdf)

    new_direct_weight = torch.where(nee_done, smp.power_heuristic(pdf, light_pdf), 1.0)

    # next ray state (rayhit.rchit:792-796)
    offset_n = m3.faceforward(gn, -wi_world, gn)
    new_origin = m3.fma(offset_n, torch.full_like(offset_n, cfg.origin_epsilon), position)
    new_weight = state["weight"] * f * (now * _safe_inv(pdf))[..., None]

    cont = hit & (~terminate)
    out = dict(state)
    out["rays_traced"] = (
        state["rays_traced"] + alive.to(torch.int32) + nee_candidate.to(torch.int32)
    )
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

    # raygen side: firefly clamp + accumulate (raygen.rgen:60-63)
    keep = torch.all(emitted < cfg.firefly_clamp, dim=-1)
    out["radiance"] = state["radiance"] + torch.where((alive & keep)[..., None], emitted, 0.0)

    if grad_hook is not None:
        if cfg.nee and cfg.mis_mode == "exact":
            emit_w = torch.where((~ce) & (~wd), w_emit, 1.0)
        elif cfg.nee:
            emit_w = torch.where((~ce) & (~wd), state["direct_weight"], 1.0)
        else:
            emit_w = torch.ones_like(light_flag)
        bidx = bsdf_idx if fused else scene.tri_bsdf[torch.clamp(prim, min=0).long()]
        out = grad_hook(out, dict(
            depth=bounce, bidx=bidx, lhit=tri_lidx, weight=state["weight"], hit=hit,
            acc=alive & keep, cont=cont, nee_done=nee_done,
            nee_s=w_mis * nol * _safe_inv(light_pdf), f_light=f_light, lfront=lfront,
            lemit=lemit, lidx=lidx, emit_w=emit_w, light_flag=light_flag, e=emitted))

    # Russian roulette (raygen.rgen:66-71)
    if_rr = bounce > cfg.rr_start_depth
    q = torch.clamp(torch.amax(out["weight"], dim=-1), cfg.rr_clamp_min, 1.0)
    u_rr = rng.uniform(seed, bounce, CH_RR)
    rr_kill = if_rr & (u_rr > q)
    out["weight"] = torch.where(
        (if_rr & ~rr_kill)[..., None], out["weight"] / q[..., None], out["weight"]
    )
    out["done"] = out["done"] | rr_kill
    return out


def _fresh_state(origin, direction, seed):
    r = origin.shape[0]
    dev = origin.device
    f32 = torch.float32
    return dict(
        origin=origin,
        direction=direction,
        weight=torch.ones((r, 3), dtype=f32, device=dev),
        direct_weight=torch.ones((r,), dtype=f32, device=dev),
        prev_pdf=torch.ones((r,), dtype=f32, device=dev),
        prev_nee=torch.zeros((r,), dtype=torch.bool, device=dev),
        prev_nee_any=torch.zeros((r,), dtype=torch.bool, device=dev),
        was_delta=torch.zeros((r,), dtype=torch.bool, device=dev),
        count_emitted=torch.ones((r,), dtype=torch.bool, device=dev),  # raygen.rgen:43
        done=torch.zeros((r,), dtype=torch.bool, device=dev),
        radiance=torch.zeros((r, 3), dtype=f32, device=dev),
        rays_traced=torch.zeros((r,), dtype=torch.int32, device=dev),
        seed=seed,
    )


def _camera_rays(scene: SceneData, cfg: RenderConfig, pixel, seed):
    jitter = None
    if cfg.jitter:
        jitter = (
            rng.uniform(seed, 0xFFFF, CH_JITTER_X),
            rng.uniform(seed, 0xFFFF, CH_JITTER_Y),
        )
    return generate_rays(scene.camera, cfg.width, cfg.height, pixel, jitter)


def trace_rays(scene: SceneData, cfg: RenderConfig, origin, direction, seed,
               differentiable: bool = False):
    """Trace a batch of rays to completion: depth = 0 .. max_depth, stopping
    early once every lane is done (done lanes add nothing, so the early
    exit changes neither the radiance nor its gradient).  Returns
    (radiance (R,3), rays_traced (R,) int32: closest-hit plus shadow rays
    issued per lane).

    differentiable: the radiance carries autograd through the scene's
    parameters (bsdf_params, emission, ...); with cfg.grad_remat "bounce"
    each bounce runs under torch.utils.checkpoint and is replayed in the
    backward pass (path_tracer.py:749-755)."""
    from torch.utils.checkpoint import checkpoint

    tables = _tables(scene, cfg, "nearest")
    state = _fresh_state(origin, direction, rng.as_u32(seed))
    remat = differentiable and cfg.grad_remat == "bounce"
    bounce = 0
    while bounce < cfg.max_depth + 1 and not bool(torch.all(state["done"])):
        depth = torch.full_like(state["seed"], bounce)
        if remat:
            state = checkpoint(_bounce, scene, cfg, depth, state, tables, True,
                               use_reentrant=False)
        else:
            state = _bounce(scene, cfg, depth, state, tables, differentiable)
        bounce += 1
    return state["radiance"], state["rays_traced"]


def _bbox(scene: SceneData):
    lo = scene.bvh_node_min[0]
    return lo, torch.clamp(scene.bvh_node_max[0] - lo, min=1e-6)


def _expand_bits(v, masks):
    for shift, mask in masks:
        v = (v | (v << shift)) & mask
    return v


_EXPAND9 = ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249))
_EXPAND5 = _EXPAND9[1:]


def _ray_sort_key(scene: SceneData, origin, direction, done):
    """Coherence key (path_tracer.py:897-920): direction octant (3 bits) |
    origin Morton code (27 bits); done lanes sort to the end."""
    lo, extent = _bbox(scene)
    q = (torch.clamp((origin - lo) / extent, 0.0, 1.0) * 511.0).to(torch.int64)
    morton = ((_expand_bits(q[:, 0], _EXPAND9) << 2) | (_expand_bits(q[:, 1], _EXPAND9) << 1)
              | _expand_bits(q[:, 2], _EXPAND9))
    octant = (((direction[:, 0] < 0).long() << 2) | ((direction[:, 1] < 0).long() << 1)
              | (direction[:, 2] < 0).long())
    key = (octant << 27) | (morton & ((1 << 27) - 1))
    return torch.where(done, 1 << 30, key)


def _segment_sort_key(scene: SceneData, origin, endpoint, candidate):
    """Shadow-segment key (path_tracer.py:874-894): 15-bit Morton code of
    the endpoint (major) and of the origin; non-candidates sort last."""
    lo, extent = _bbox(scene)

    def m15(p):
        q = (torch.clamp((p - lo) / extent, 0.0, 1.0) * 31.0).to(torch.int64)
        return ((_expand_bits(q[:, 0], _EXPAND5) << 2) | (_expand_bits(q[:, 1], _EXPAND5) << 1)
                | _expand_bits(q[:, 2], _EXPAND5))

    key = (m15(endpoint) << 15) | m15(origin)
    return torch.where(candidate, key, 1 << 30)


def trace_wavefront(scene: SceneData, cfg: RenderConfig, pixel_index, timestamp0,
                    tex_mode: str = "nearest", grad_hook=None, hook_state=None,
                    bvh_isect=None):
    """Persistent-lane wavefront: each lane owns one pixel and runs its
    cfg.spp samples back to back, regenerating a fresh camera path the
    moment the previous one ends (path_tracer.py:770).  With cfg.sort_rays
    the lanes are re-ordered every cfg.sort_interval iterations by
    _ray_sort_key; each lane's pixel travels with it.

    tex_mode: "nearest" shades a textured hit with the texel at its uv (the
    wavefront's rule); "corners" with the barycentric blend of per-corner
    texels (the fused-BVH megakernel's rule, for its plain version).

    grad_hook / hook_state: the fused-gradient kernels' hook and its
    per-lane state tensors (leading axis R), carried with the lanes.
    bvh_isect: the BVH intersector pair of _bounce.

    Returns the final lane state: a dict of (R, ...) tensors, among them
    "radiance" (the sum over the lane's samples: divide by spp and scatter
    by "pixel"), "rays_traced", "pixel" and the keys of hook_state."""
    pixel_index = rng.as_u32(pixel_index)
    dev = pixel_index.device
    r = pixel_index.shape[0]
    t0 = int(timestamp0) & 0xFFFFFFFF
    tables = _tables(scene, cfg, tex_mode, bvh_isect)

    def fresh_ray(pixel, sample_idx):
        seed = rng.pixel_seed(pixel, (sample_idx + t0) & 0xFFFFFFFF)
        o, d = _camera_rays(scene, cfg, pixel, seed)
        return o, d, seed

    zeros = torch.zeros((r,), dtype=torch.int64, device=dev)
    o0, d0, seed0 = fresh_ray(pixel_index, zeros)
    state = _fresh_state(o0, d0, seed0)
    state["depth"] = zeros
    state["sample"] = zeros
    state["pixel"] = pixel_index
    state.update(hook_state or {})

    max_iters = cfg.spp * (cfg.max_depth + 1)
    it = 0
    while it < max_iters:
        if bool(torch.all(state["done"] & (state["sample"] + 1 >= cfg.spp))):
            break
        depth = state["depth"]
        st = _bounce(scene, cfg, depth, state, tables, grad_hook=grad_hook, bvh_isect=bvh_isect)
        st["depth"] = depth + 1
        st["done"] = st["done"] | (st["depth"] >= cfg.max_depth + 1)

        # regenerate finished lanes that still have samples left
        regen = st["done"] & (st["sample"] + 1 < cfg.spp)
        new_sample = torch.where(regen, st["sample"] + 1, st["sample"])
        o_n, d_n, seed_n = fresh_ray(st["pixel"], new_sample)
        rsel = regen[..., None]
        st["origin"] = torch.where(rsel, o_n, st["origin"])
        st["direction"] = torch.where(rsel, d_n, st["direction"])
        st["seed"] = torch.where(regen, seed_n, st["seed"])
        st["weight"] = torch.where(rsel, 1.0, st["weight"])
        st["direct_weight"] = torch.where(regen, 1.0, st["direct_weight"])
        st["prev_pdf"] = torch.where(regen, 1.0, st["prev_pdf"])
        st["prev_nee"] = torch.where(regen, False, st["prev_nee"])
        st["prev_nee_any"] = torch.where(regen, False, st["prev_nee_any"])
        st["was_delta"] = torch.where(regen, False, st["was_delta"])
        st["count_emitted"] = torch.where(regen, True, st["count_emitted"])
        st["depth"] = torch.where(regen, 0, st["depth"])
        st["sample"] = new_sample
        st["done"] = st["done"] & (~regen)
        if cfg.sort_rays and (it + 1) % cfg.sort_interval == 0:
            order = torch.argsort(
                _ray_sort_key(scene, st["origin"], st["direction"], st["done"]), stable=True)
            st = {k: v[order] for k, v in st.items()}
        state = st
        it += 1
    return state


def render_sample(scene: SceneData, cfg: RenderConfig, pixel_index, timestamp,
                  differentiable: bool = False):
    """Radiance of one sample per pixel index: (radiance (R,3),
    rays_traced (R,)); differentiable as in trace_rays.  `timestamp` is one
    int for every lane or a tensor of one per lane (several samples of a
    frame in one batch: lane i draws the sample of pixel_index[i] at
    timestamp[i])."""
    pixel_index = rng.as_u32(pixel_index)
    seed = rng.pixel_seed(pixel_index, rng.as_u32(timestamp, pixel_index.device))
    origin, direction = _camera_rays(scene, cfg, pixel_index, seed)
    return trace_rays(scene, cfg, origin, direction, seed, differentiable=differentiable)


def render_image_stats(scene: SceneData, cfg: RenderConfig, timestamp0=0, bvh_isect=None):
    """Render (H, W, 3) plus the total rays traced (a float).

    Mean of cfg.spp samples, batched over cfg.ray_batch lanes; every batch
    is full, so pixels past the last real one are traced (and their rays
    counted) as in the JAX package (path_tracer.py:948-965).  bvh_isect: the
    BVH intersector pair of _bounce."""
    n_pixels = cfg.width * cfg.height
    batch = min(cfg.ray_batch, n_pixels)
    n_batches = -(-n_pixels // batch)
    dev = scene.device
    parts = []
    nrays = 0.0
    for b in range(n_batches):
        pix = torch.arange(b * batch, (b + 1) * batch, dtype=torch.int64, device=dev)
        st = trace_wavefront(scene, cfg, pix, timestamp0, bvh_isect=bvh_isect)
        rad, rays, pixel = st["radiance"], st["rays_traced"], st["pixel"]
        if cfg.sort_rays:  # lanes permuted: scatter back to pixel order
            rad = torch.zeros_like(rad).index_copy(0, pixel - b * batch, rad)
        parts.append(rad / cfg.spp)
        nrays += float(rays.to(torch.float64).sum())
    radiance = torch.cat(parts, dim=0)[:n_pixels]
    return radiance.reshape(cfg.height, cfg.width, 3), nrays


def render_image(scene: SceneData, cfg: RenderConfig, timestamp0=0):
    """Render (H, W, 3); see render_image_stats."""
    return render_image_stats(scene, cfg, timestamp0)[0]
