"""SceneData: the device-side scene (port of gpuspectral_tpu/scene/data.py).

A frozen dataclass of tensors on one device.  The build is the reference's,
in numpy: every triangle pre-transformed to world space, per-triangle
material attributes gathered into dense arrays, every emitting triangle a
light, arrays padded to multiples of 128 with degenerate triangles, and the
triangles stored in the slot order of the SAH build (bvh/build.py, the
port's copy of the JAX package's numpy build), so prim ids equal the JAX package's bit for bit.  The build
carries the same BVH tables (implicit-tree node boxes, sweep bins, the
preorder walk that the traversal kernels follow), the texture atlas and the
environment map with its sampling tables.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..bsdf.table import BSDFTable
from ..utils.profiling import stage

PAD_MULTIPLE = 128
MEGA_MAX_TRIS = 2048  # gpuspectral_tpu/integrator/mega.py:MEGA_MAX_TRIS
TEX_RES = 256  # atlas resolution every texture is resampled to
_PAD_POS = 0.0

# The JAX package's table layout choices, copied as plain numbers so that
# the build picks the same bin size (and so the same triangle order).  They
# describe the TPU kernel's tables and VMEM budget, not a budget of the GPU.
_NA = 32  # mega_bvh.py:_NA, attribute rows of the fused-BVH table
_NA_TEX = 41  # mega_bvh.py:_NA_TEX, with per-corner texture colours
MEGA_BVH_TABLE_BYTES = 11 * 1024 * 1024  # mega_bvh.py: fine-band cap
MEGA_BVH_RESIDENT_BYTES = 100 * 1024 * 1024  # mega_bvh.py: mid-band cap
MEGA_BVH_MID_MAX_BINS = 2048  # mega_bvh.py
MEGA_BVH_STREAM_MAX_BINS = 4096  # mega_bvh.py


def table_bytes_for(n_bins: int, slots: int, na: int, n_lights: int) -> int:
    """gpuspectral_tpu/integrator/mega_bvh.py:table_bytes_for: the fused
    TPU kernel's table bytes for a bin layout (drives the band choice)."""
    n_rows = -(-(na + 12) // 8) * 8
    return 4 * (n_bins * slots * n_rows + n_bins * 128 * 2 + n_lights * 128)


# tensor fields of SceneData (scene_from_arrays / scene_to_arrays keys)
ARRAY_FIELDS = (
    "tri_pos", "tri_nrm", "tri_uv", "tri_bsdf", "tri_emission", "tri_twofaced",
    "tri_light_idx", "tri_woop", "tri_woop_t", "bsdf_kind", "bsdf_params",
    "textures", "bsdf_tex", "light_pos", "light_emission", "envmap",
    "envmap_rot", "envmap_cdf", "envmap_pdf", "light_cdf", "light_prob",
    "bvh_node_min", "bvh_node_max", "bvh_dfs_bounds", "bvh_dfs_meta",
    "bvh_bin_bounds", "cam_to_world", "cam_fov",
)
META_FIELDS = (
    "num_tris", "num_lights", "bvh_clusters", "bvh_leaf_size", "bvh_levels",
    "bvh_bins", "bvh_bin_slots", "kinds_present", "has_textures", "has_envmap",
    "has_area_lights",
)


@dataclasses.dataclass(frozen=True)
class CameraData:
    to_world: torch.Tensor  # (4,4) camera-to-world
    fov: torch.Tensor  # scalar, radians (vertical, as the reference uses it)


@dataclasses.dataclass(frozen=True)
class SceneData:
    # geometry (world space), padded to PAD_MULTIPLE, in BVH slot order
    tri_pos: torch.Tensor  # (T,3,3) float32
    tri_nrm: torch.Tensor  # (T,3,3) float32 per-corner shading normals
    tri_uv: torch.Tensor  # (T,3,2) float32
    # per-triangle material bindings
    tri_bsdf: torch.Tensor  # (T,) int32 row into bsdf tables
    tri_emission: torch.Tensor  # (T,3) float32
    tri_twofaced: torch.Tensor  # (T,) bool
    tri_light_idx: torch.Tensor  # (T,) int32 light row for emissive tris, else -1
    tri_woop: torch.Tensor  # (T,12) Woop transforms (ops/woop.py)
    tri_woop_t: torch.Tensor  # (12,T) transposed copy (kernel layout)
    # bsdf tables
    bsdf_kind: torch.Tensor  # (B,) int32
    bsdf_params: torch.Tensor  # (B,NUM_PARAMS) float32
    # texture atlas; bsdf_tex maps a bsdf row to its texture (-1: none)
    textures: torch.Tensor  # (N_tex, TEX_RES, TEX_RES, 3) float32, linear
    bsdf_tex: torch.Tensor  # (B,) int32
    # lights, padded to >= 1
    light_pos: torch.Tensor  # (L,3,3) float32 world-space vertices
    light_emission: torch.Tensor  # (L,3) float32 radiance
    # environment emitter: lat-long radiance map and its sampling tables
    envmap: torch.Tensor  # (He,We,3) float32; (1,1,3) zeros when absent
    envmap_rot: torch.Tensor  # (3,3) world->envmap rotation
    envmap_cdf: torch.Tensor  # (He*We,) texel CDF, last == 1
    envmap_pdf: torch.Tensor  # (He,We) solid-angle pdf per texel
    light_cdf: torch.Tensor  # (L,) power-proportional selection CDF
    light_prob: torch.Tensor  # (L,)
    # BVH: implicit-tree boxes, preorder walk with skip pointers, sweep bins
    bvh_node_min: torch.Tensor  # (2C-1,3)
    bvh_node_max: torch.Tensor  # (2C-1,3)
    bvh_dfs_bounds: torch.Tensor  # (6,N) f32: rows 0-2 lo, 3-5 hi
    bvh_dfs_meta: torch.Tensor  # (2,N) i32: [skip index, leaf slot | -1]
    bvh_bin_bounds: torch.Tensor  # (6, 24*ceil(bins/24)) f32
    # the rows K3, K4 and K6 walk (csrc/bvh.cuh), made from the boxes above
    # with the scene (scene_from_arrays); tri_woop holds their triangles
    bvh_pairs: torch.Tensor  # (P,16) f32: child-pair rows, breadth first
    # the bins' boxes as the rows K7a / K7b vote on (csrc/binned.cu)
    bvh_bin_rows: torch.Tensor  # (bins,8) f32: [lo xyz, 0, hi xyz, 0]
    camera: CameraData
    num_tris: int
    # 1 + the last slot that holds a triangle: every Woop row from it on is
    # zero, and K2 tests only the rows before it
    tri_rows: int
    num_lights: int
    bvh_clusters: int
    bvh_leaf_size: int
    bvh_levels: int
    bvh_bins: int
    bvh_bin_slots: int
    # which BSDF kinds occur: dispatch computes only these branches
    kinds_present: tuple
    has_textures: bool
    has_envmap: bool
    # whether any area lights exist (else one zero-radiance pad light)
    has_area_lights: bool
    bvh_root: int  # the code the pair walk starts from

    @property
    def padded_tris(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_pos.device

    def replace(self, **kw) -> "SceneData":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SceneBuilder:
    """Host-side accumulation of scene objects (data.py:134-235)."""

    tri_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_nrm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_bsdf: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_twofaced: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_light_idx: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdfs: BSDFTable = dataclasses.field(default_factory=BSDFTable)
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdf_tex: List[int] = dataclasses.field(default_factory=list)
    cam_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    envmap_image: Optional[np.ndarray] = None  # (He,We,3) linear radiance
    envmap_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    cam_fov: float = np.pi / 2
    film_width: int = 512
    film_height: int = 512
    film_spp: int = 64
    max_depth: int = 50

    def add_bsdf(self, kind_row, texture: Optional[np.ndarray] = None) -> int:
        """texture: optional (TEX_RES, TEX_RES, 3) linear float32 tile that
        modulates the bsdf's diffuse/reflectance colour."""
        idx = self.bsdfs.add(kind_row)
        if texture is not None:
            self.textures.append(np.asarray(texture, np.float32))
            self.bsdf_tex.append(len(self.textures) - 1)
        else:
            self.bsdf_tex.append(-1)
        return idx

    def add_object(
        self,
        positions: np.ndarray,  # (N,3,3) object space
        normals: np.ndarray,  # (N,3,3)
        uvs: Optional[np.ndarray],  # (N,3,2)
        transform: np.ndarray,  # (4,4) object-to-world
        bsdf_index: int,
        emission=(0.0, 0.0, 0.0),
        twofaced: bool = False,
    ) -> None:
        n = positions.shape[0]
        if n == 0:
            return
        transform = np.asarray(transform, np.float32)
        pos_h = positions @ transform[:3, :3].T + transform[:3, 3]
        inv_t = np.linalg.inv(transform[:3, :3]).T.astype(np.float32)
        nrm = normals @ inv_t.T
        if uvs is None:
            uvs = np.zeros((n, 3, 2), np.float32)
        if np.linalg.det(transform[:3, :3]) < 0.0:
            # mirrored transform: swap two corners so the winding normal
            # agrees with the transformed shading normals (data.py:193-205)
            pos_h = pos_h[:, [0, 2, 1]]
            nrm = nrm[:, [0, 2, 1]]
            uvs = np.asarray(uvs)[:, [0, 2, 1]]
        emission = np.asarray(emission, np.float32)
        self.tri_pos.append(pos_h.astype(np.float32))
        self.tri_nrm.append(nrm.astype(np.float32))
        self.tri_uv.append(np.asarray(uvs).astype(np.float32))
        self.tri_bsdf.append(np.full((n,), bsdf_index, np.int32))
        self.tri_emission.append(np.broadcast_to(emission, (n, 3)).copy())
        self.tri_twofaced.append(np.full((n,), twofaced, bool))
        if np.any(emission > 0.0):
            # every emitting triangle becomes a light (Loader.cpp:316-330)
            base = sum(x.shape[0] for x in self.light_pos)
            self.tri_light_idx.append(np.arange(base, base + n, dtype=np.int32))
            self.light_pos.append(pos_h.astype(np.float32))
            self.light_emission.append(np.broadcast_to(emission, (n, 3)).copy())
        else:
            self.tri_light_idx.append(np.full((n,), -1, np.int32))

    def set_envmap(self, image: np.ndarray, to_world=None, scale: float = 1.0) -> None:
        """Environment emitter: lat-long radiance map (a (1,1,3) image for
        Mitsuba's `constant` emitter)."""
        self.envmap_image = np.asarray(image, np.float32) * np.float32(scale)
        if to_world is not None:
            self.envmap_to_world = np.asarray(to_world, np.float32)

    def set_camera(self, to_world: np.ndarray, fov_radians: float) -> None:
        self.cam_to_world = np.asarray(to_world, np.float32)
        self.cam_fov = float(fov_radians)

    def build(self, device="cuda", order="sah") -> SceneData:
        return build_scene(self, device, order)


def _pad_to(x: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    shape = (pad,) + x.shape[1:]
    return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)


def _bvh_and_bins(pos, num_tris: int, na: int, n_lights_est: int, order: str):
    """The tree build in `order` in the JAX package's three bands of bin
    size (data.py:273-337): fine 128-slot bins while the fused table stays
    under MEGA_BVH_TABLE_BYTES, mid 256-slot under MEGA_BVH_RESIDENT_BYTES,
    fat 512-slot beyond; a band whose padded table overflows its cap drops
    to the next.  The band fixes the slot order of the triangles."""
    from ..bvh.tables import MAX_BINS, build_bins, sah

    bands = (
        (sah.BIN_TARGET, MAX_BINS, MEGA_BVH_TABLE_BYTES),
        (sah.BIN_TARGET_MID, MEGA_BVH_MID_MAX_BINS, MEGA_BVH_RESIDENT_BYTES),
        (sah.BIN_TARGET_STREAM, MEGA_BVH_STREAM_MAX_BINS, None),
    )
    raw_bytes = 4 * num_tris * (12 + na)

    def build(i):
        tgt, mx, _ = bands[i]
        tree = sah.build_bvh(pos, num_tris, order=order, bin_target=tgt)
        bounds, nb, ns = build_bins(
            tree.node_min, tree.node_max, tree.n_clusters, tree.n_clusters_real,
            tree.leaf_size, max_bins=mx, slots_per_bin=tgt if num_tris > 0 else 0)
        return tree, bounds, nb, ns

    band = next(i for i, (_, _, cap) in enumerate(bands) if cap is None or raw_bytes <= cap)
    tree, bounds, nb, ns = build(band)
    while (bands[band][2] is not None and num_tris > 0
           and table_bytes_for(nb, ns, na, n_lights_est) > bands[band][2]):
        band += 1
        tree, bounds, nb, ns = build(band)
    return tree, bounds, nb, ns


def _env_tables(image: Optional[np.ndarray]):
    """(envmap, cdf, pdf): flattened luminance x texel-solid-angle CDF and
    per-texel solid-angle pdf (data.py:386-408)."""
    if image is None:
        return (np.zeros((1, 1, 3), np.float32), np.ones((1,), np.float32),
                np.ones((1, 1), np.float32))
    em = np.asarray(image, np.float32)
    he, we = em.shape[0], em.shape[1]
    lum = em @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    th = np.pi * np.arange(he + 1, dtype=np.float64) / he
    omega_row = (2.0 * np.pi / we) * (np.cos(th[:-1]) - np.cos(th[1:]))
    wgt = (lum + 1e-10) * omega_row[:, None].astype(np.float32)
    p_texel = wgt / wgt.sum()
    env_cdf = np.cumsum(p_texel.ravel()).astype(np.float32)
    env_cdf[-1] = 1.0
    env_pdf = (p_texel / omega_row[:, None]).astype(np.float32)
    return em, env_cdf, env_pdf


def build_arrays(b: SceneBuilder, order: str = "sah") -> tuple[dict, dict]:
    """The scene's numpy tables and static metadata (data.py:245-471), the
    triangles in the slot order of a tree built in `order`: bvh/build.py's
    "sah" (the JAX package's build) or "morton"."""
    from ..bvh.tables import build_dfs_tables
    from ..ops.woop import woop_transform

    if b.tri_pos:
        pos = np.concatenate(b.tri_pos)
        nrm = np.concatenate(b.tri_nrm)
        uv = np.concatenate(b.tri_uv)
        bsdf_idx = np.concatenate(b.tri_bsdf)
        emission = np.concatenate(b.tri_emission)
        twofaced = np.concatenate(b.tri_twofaced)
        light_idx = np.concatenate(b.tri_light_idx)
    else:
        pos = np.zeros((0, 3, 3), np.float32)
        nrm = np.zeros((0, 3, 3), np.float32)
        uv = np.zeros((0, 3, 2), np.float32)
        bsdf_idx = np.zeros((0,), np.int32)
        emission = np.zeros((0, 3), np.float32)
        twofaced = np.zeros((0,), bool)
        light_idx = np.zeros((0,), np.int32)

    num_tris = pos.shape[0]
    padded = max(PAD_MULTIPLE, -(-num_tris // PAD_MULTIPLE) * PAD_MULTIPLE)
    pos = _pad_to(pos, padded, _PAD_POS)
    nrm = _pad_to(nrm, padded, 0.0)
    uv = _pad_to(uv, padded, 0.0)
    bsdf_idx = _pad_to(bsdf_idx, padded, 0)
    emission = _pad_to(emission, padded, 0.0)
    twofaced = _pad_to(twofaced, padded, False)
    light_idx = _pad_to(light_idx, padded, -1)

    na = _NA_TEX if b.textures else _NA
    n_lights_est = max(1, sum(x.shape[0] for x in b.light_pos))
    bvh, bin_bounds, n_bins, bin_slots = _bvh_and_bins(pos, num_tris, na, n_lights_est, order)

    perm = bvh.perm
    slots = perm.shape[0]
    if slots % PAD_MULTIPLE:
        perm = np.concatenate([perm, np.full(-slots % PAD_MULTIPLE, -1, perm.dtype)])
    empty = perm < 0
    safe = np.maximum(perm, 0)
    pos, nrm, uv = pos[safe], nrm[safe], uv[safe]
    bsdf_idx, emission, twofaced = bsdf_idx[safe], emission[safe], twofaced[safe]
    light_idx = light_idx[safe]
    pos[empty] = _PAD_POS
    emission[empty] = 0.0
    light_idx[empty] = -1

    woop = woop_transform(pos)
    woop[empty] = 0.0  # degenerate: the unit-triangle test can never pass

    dfs_bounds, dfs_meta = build_dfs_tables(
        bvh.node_min, bvh.node_max, bvh.n_clusters, bvh.n_clusters_real, bvh.leaf_size)

    if b.light_pos:
        lpos = np.concatenate(b.light_pos)
        lemit = np.concatenate(b.light_emission)
    else:
        lpos = np.zeros((1, 3, 3), np.float32)
        lemit = np.zeros((1, 3), np.float32)
    num_lights = max(1, lpos.shape[0])
    lpos = _pad_to(lpos, num_lights, 0.0)
    lemit = _pad_to(lemit, num_lights, 0.0)

    # emitted power per light: luminance-ish weight * triangle area
    areas = 0.5 * np.linalg.norm(
        np.cross(lpos[:, 1] - lpos[:, 0], lpos[:, 2] - lpos[:, 0]), axis=-1
    )
    power = lemit.sum(-1) * areas
    total = power.sum()
    prob = power / total if total > 0 else np.full((num_lights,), 1.0 / num_lights)
    cdf = np.cumsum(prob).astype(np.float32)
    cdf[-1] = 1.0

    envmap, env_cdf, env_pdf = _env_tables(b.envmap_image)

    kinds, params = b.bsdfs.pack()
    if b.textures:
        tex_atlas = np.stack(b.textures).astype(np.float32)
    else:
        tex_atlas = np.zeros((1, 1, 1, 3), np.float32)
    bsdf_tex = np.asarray(
        (b.bsdf_tex + [-1])[: len(kinds)] if b.bsdf_tex else [-1] * len(kinds), np.int32)
    if bsdf_tex.shape[0] < len(kinds):
        bsdf_tex = np.concatenate(
            [bsdf_tex, np.full((len(kinds) - bsdf_tex.shape[0],), -1, np.int32)])

    arrays = dict(
        tri_pos=pos, tri_nrm=nrm, tri_uv=uv, tri_bsdf=bsdf_idx, tri_emission=emission,
        tri_twofaced=twofaced, tri_light_idx=light_idx, tri_woop=woop,
        tri_woop_t=woop.T.copy(), bsdf_kind=kinds, bsdf_params=params,
        textures=tex_atlas, bsdf_tex=bsdf_tex, light_pos=lpos, light_emission=lemit,
        envmap=envmap,
        envmap_rot=np.linalg.inv(b.envmap_to_world[:3, :3]).astype(np.float32),
        envmap_cdf=env_cdf, envmap_pdf=env_pdf, light_cdf=cdf,
        light_prob=prob.astype(np.float32),
        bvh_node_min=bvh.node_min, bvh_node_max=bvh.node_max,
        bvh_dfs_bounds=dfs_bounds, bvh_dfs_meta=dfs_meta, bvh_bin_bounds=bin_bounds,
        cam_to_world=np.asarray(b.cam_to_world, np.float32),
        cam_fov=np.asarray(b.cam_fov, np.float32),
    )
    meta = dict(
        num_tris=int(num_tris),
        num_lights=int(lpos.shape[0]) if b.light_pos else 1,
        bvh_clusters=bvh.n_clusters,
        bvh_leaf_size=bvh.leaf_size,
        bvh_levels=bvh.n_levels,
        bvh_bins=n_bins,
        bvh_bin_slots=bin_slots,
        kinds_present=tuple(sorted(set(int(k) for k in kinds))),
        has_textures=bool(b.textures),
        has_envmap=b.envmap_image is not None,
        has_area_lights=bool(b.light_pos),
    )
    return arrays, meta


def check_device(device) -> torch.device:
    """The device a scene is built on.  Scenes live on the card by default;
    without a CUDA device that default raises rather than quietly build a
    CPU scene: the caller asks for the CPU (the plain versions) by name."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device for a scene on {device}: pass device="cpu" to '
                           "build it on the CPU (the kernels' plain versions)")
    return device


def build_scene(b: SceneBuilder, device="cuda", order="sah") -> SceneData:
    """The SceneData of `b` on `device`: the span "gst.scene.load"
    (utils/profiling) around _build_scene."""
    with stage("gst.scene.load"):
        return _build_scene(b, device, order)


def _build_scene(b: SceneBuilder, device, order: str) -> SceneData:
    """build_scene inside its span: the host tables ("gst.scene.bvh"), then
    the tensors on the device ("gst.scene.upload", where a first CUDA use
    pays for the context)."""
    device = check_device(device)
    with stage("gst.scene.bvh"):
        arrays, meta = build_arrays(b, order)
    with stage("gst.scene.upload"):
        return scene_from_arrays(arrays, meta, device)


def scene_from_arrays(arrays: dict, meta: dict, device="cuda") -> SceneData:
    """SceneData on `device` (check_device) from numpy tables and static
    metadata.

    `arrays` holds every name of ARRAY_FIELDS: the SceneData tensor fields
    plus `cam_to_world` and `cam_fov`; `meta` every name of META_FIELDS.
    Given `np.asarray` of each field of a gpuspectral_tpu SceneData and its
    static fields, it carries that scene across unchanged.  K2's count of
    the rows to test, `tri_rows`, is read off the Woop table here
    (bvh/tables.py:last_tri_row), as are the child-pair rows of the BVH walk
    and the bin rows of K7a / K7b (build_pair_rows, build_bin_rows); the
    tables are checked for what the cluster gates of K7d-g assume
    (bvh/tables.py:check_leaf_clusters, ValueError otherwise)."""
    from ..bvh.tables import (build_bin_rows, build_pair_rows, check_leaf_clusters,
                              last_tri_row)

    device = check_device(device)
    check_leaf_clusters(arrays["tri_woop"], arrays["bvh_node_min"], arrays["bvh_node_max"],
                        int(meta["bvh_clusters"]), int(meta["bvh_leaf_size"]),
                        arrays["bvh_dfs_meta"])
    t = {k: torch.as_tensor(np.array(arrays[k], copy=True), device=device)
         for k in ARRAY_FIELDS}
    fields = {k: t[k] for k in ARRAY_FIELDS if not k.startswith("cam_")}
    statics = {k: (tuple(int(x) for x in meta[k]) if k == "kinds_present"
                   else bool(meta[k]) if k.startswith("has_") else int(meta[k]))
               for k in META_FIELDS}
    pairs, root = build_pair_rows(arrays["bvh_node_min"], arrays["bvh_node_max"],
                                  statics["bvh_clusters"])
    return SceneData(camera=CameraData(to_world=t["cam_to_world"], fov=t["cam_fov"]),
                     bvh_pairs=torch.as_tensor(pairs, device=device), bvh_root=root,
                     bvh_bin_rows=torch.as_tensor(
                         build_bin_rows(arrays["bvh_bin_bounds"], statics["bvh_bins"]),
                         device=device),
                     tri_rows=last_tri_row(arrays["tri_woop"]), **fields, **statics)


def scene_to_arrays(scene: SceneData) -> tuple[dict, dict]:
    """Inverse of scene_from_arrays: (numpy tables, static metadata)."""
    arrays = {k: getattr(scene, k).cpu().numpy() for k in ARRAY_FIELDS
              if not k.startswith("cam_")}
    arrays["cam_to_world"] = scene.camera.to_world.cpu().numpy()
    arrays["cam_fov"] = scene.camera.fov.cpu().numpy()
    meta = {k: getattr(scene, k) for k in META_FIELDS}
    return arrays, meta
