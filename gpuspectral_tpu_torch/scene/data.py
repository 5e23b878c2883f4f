"""SceneData: the device-side scene (port of gpuspectral_tpu/scene/data.py).

A frozen dataclass of tensors on one device.  The build is the reference's,
in numpy: every triangle pre-transformed to world space, per-triangle
material attributes gathered into dense arrays, every emitting triangle a
light, arrays padded to multiples of 128 with degenerate triangles, and the
triangles stored in the order of the SAH build (gpuspectral_tpu.bvh.build,
numpy only) so prim ids equal the JAX package's bit for bit.

Covered here: scenes of at most MEGA_MAX_TRIS triangles, untextured, without
environment emitters.  Bigger scenes need BVH traversal, textures come with
the fused-BVH megakernel, environment emitters with the environment part of
the megakernel: all three are slice B of the port and raise
NotImplementedError until then.  The BVH and bin tables of the JAX SceneData
belong to slice B too and are not carried.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..bsdf.table import BSDFTable

PAD_MULTIPLE = 128
MEGA_MAX_TRIS = 2048  # gpuspectral_tpu/integrator/mega.py:MEGA_MAX_TRIS
_PAD_POS = 0.0

# tensor fields of SceneData (scene_from_arrays / scene_to_arrays keys)
ARRAY_FIELDS = (
    "tri_pos", "tri_nrm", "tri_bsdf", "tri_emission", "tri_twofaced",
    "tri_light_idx", "tri_woop", "tri_woop_t", "bsdf_kind", "bsdf_params",
    "light_pos", "light_emission", "light_cdf", "light_prob",
    "cam_to_world", "cam_fov",
)
META_FIELDS = ("num_tris", "num_lights", "kinds_present", "has_area_lights")


@dataclasses.dataclass(frozen=True)
class CameraData:
    to_world: torch.Tensor  # (4,4) camera-to-world
    fov: torch.Tensor  # scalar, radians (vertical, as the reference uses it)


@dataclasses.dataclass(frozen=True)
class SceneData:
    # geometry (world space), padded to PAD_MULTIPLE
    tri_pos: torch.Tensor  # (T,3,3) float32
    tri_nrm: torch.Tensor  # (T,3,3) float32 per-corner shading normals
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
    # lights, padded to >= 1
    light_pos: torch.Tensor  # (L,3,3) float32 world-space vertices
    light_emission: torch.Tensor  # (L,3) float32 radiance
    light_cdf: torch.Tensor  # (L,) power-proportional selection CDF
    light_prob: torch.Tensor  # (L,)
    camera: CameraData
    num_tris: int
    num_lights: int
    # which BSDF kinds occur: dispatch computes only these branches
    kinds_present: tuple
    # whether any area lights exist (else one zero-radiance pad light)
    has_area_lights: bool

    @property
    def padded_tris(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_pos.device

    def replace(self, **kw) -> "SceneData":
        return dataclasses.replace(self, **kw)


def check_slice(num_tris: int, has_textures: bool = False, has_envmap: bool = False) -> None:
    """Raise NotImplementedError for a scene this slice of the port does not
    cover, naming the slice that adds it."""
    if has_textures:
        raise NotImplementedError(
            "textured BSDFs: slice B of the port (fused-BVH megakernel)")
    if has_envmap:
        raise NotImplementedError(
            "environment emitters: slice B of the port (megakernel env path)")
    if num_tris > MEGA_MAX_TRIS:
        raise NotImplementedError(
            f"{num_tris} triangles: scenes above {MEGA_MAX_TRIS} need BVH "
            "traversal, slice B of the port")


@dataclasses.dataclass
class SceneBuilder:
    """Host-side accumulation of scene objects (data.py:134-235)."""

    tri_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_nrm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_bsdf: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_twofaced: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_light_idx: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdfs: BSDFTable = dataclasses.field(default_factory=BSDFTable)
    cam_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    cam_fov: float = np.pi / 2
    film_width: int = 512
    film_height: int = 512
    film_spp: int = 64
    max_depth: int = 50

    def add_bsdf(self, kind_row) -> int:
        return self.bsdfs.add(kind_row)

    def add_object(
        self,
        positions: np.ndarray,  # (N,3,3) object space
        normals: np.ndarray,  # (N,3,3)
        uvs: Optional[np.ndarray],  # (N,3,2), unused until textures
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
        if np.linalg.det(transform[:3, :3]) < 0.0:
            # mirrored transform: swap two corners so the winding normal
            # agrees with the transformed shading normals (data.py:193-205)
            pos_h = pos_h[:, [0, 2, 1]]
            nrm = nrm[:, [0, 2, 1]]
        emission = np.asarray(emission, np.float32)
        self.tri_pos.append(pos_h.astype(np.float32))
        self.tri_nrm.append(nrm.astype(np.float32))
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

    def set_camera(self, to_world: np.ndarray, fov_radians: float) -> None:
        self.cam_to_world = np.asarray(to_world, np.float32)
        self.cam_fov = float(fov_radians)

    def build(self, device="cpu") -> SceneData:
        return build_scene(self, device)


def _pad_to(x: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    shape = (pad,) + x.shape[1:]
    return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)


def build_arrays(b: SceneBuilder) -> tuple[dict, dict]:
    """The scene's numpy tables and static metadata (data.py:245-471, minus
    the BVH, bin, texture and environment tables)."""
    from gpuspectral_tpu.bvh.build import BIN_TARGET, build_bvh

    from ..ops.woop import woop_transform

    if b.tri_pos:
        pos = np.concatenate(b.tri_pos)
        nrm = np.concatenate(b.tri_nrm)
        bsdf_idx = np.concatenate(b.tri_bsdf)
        emission = np.concatenate(b.tri_emission)
        twofaced = np.concatenate(b.tri_twofaced)
        light_idx = np.concatenate(b.tri_light_idx)
    else:
        pos = np.zeros((0, 3, 3), np.float32)
        nrm = np.zeros((0, 3, 3), np.float32)
        bsdf_idx = np.zeros((0,), np.int32)
        emission = np.zeros((0, 3), np.float32)
        twofaced = np.zeros((0,), bool)
        light_idx = np.zeros((0,), np.int32)

    num_tris = pos.shape[0]
    check_slice(num_tris)
    padded = max(PAD_MULTIPLE, -(-num_tris // PAD_MULTIPLE) * PAD_MULTIPLE)
    pos = _pad_to(pos, padded, _PAD_POS)
    nrm = _pad_to(nrm, padded, 0.0)
    bsdf_idx = _pad_to(bsdf_idx, padded, 0)
    emission = _pad_to(emission, padded, 0.0)
    twofaced = _pad_to(twofaced, padded, False)
    light_idx = _pad_to(light_idx, padded, -1)

    # SAH triangle order.  Every scene of this slice is far under the JAX
    # build's fine-band byte budget (data.py:330-337), so its band is always
    # the fine one: bin_target=BIN_TARGET.
    perm = build_bvh(pos, num_tris, bin_target=BIN_TARGET).perm
    slots = perm.shape[0]
    if slots % PAD_MULTIPLE:
        perm = np.concatenate([perm, np.full(-slots % PAD_MULTIPLE, -1, perm.dtype)])
    empty = perm < 0
    safe = np.maximum(perm, 0)
    pos, nrm = pos[safe], nrm[safe]
    bsdf_idx, emission, twofaced = bsdf_idx[safe], emission[safe], twofaced[safe]
    light_idx = light_idx[safe]
    pos[empty] = _PAD_POS
    emission[empty] = 0.0
    light_idx[empty] = -1

    woop = woop_transform(pos)
    woop[empty] = 0.0  # degenerate: the unit-triangle test can never pass

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

    kinds, params = b.bsdfs.pack()
    arrays = dict(
        tri_pos=pos, tri_nrm=nrm, tri_bsdf=bsdf_idx, tri_emission=emission,
        tri_twofaced=twofaced, tri_light_idx=light_idx, tri_woop=woop,
        tri_woop_t=woop.T.copy(), bsdf_kind=kinds, bsdf_params=params,
        light_pos=lpos, light_emission=lemit, light_cdf=cdf,
        light_prob=prob.astype(np.float32),
        cam_to_world=np.asarray(b.cam_to_world, np.float32),
        cam_fov=np.asarray(b.cam_fov, np.float32),
    )
    meta = dict(
        num_tris=int(num_tris),
        num_lights=int(lpos.shape[0]) if b.light_pos else 1,
        kinds_present=tuple(sorted(set(int(k) for k in kinds))),
        has_area_lights=bool(b.light_pos),
    )
    return arrays, meta


def build_scene(b: SceneBuilder, device="cpu") -> SceneData:
    arrays, meta = build_arrays(b)
    return scene_from_arrays(arrays, meta, device)


def scene_from_arrays(arrays: dict, meta: dict, device="cpu") -> SceneData:
    """SceneData on `device` from numpy tables and static metadata.

    `arrays` holds every name of ARRAY_FIELDS: the SceneData tensor fields
    plus `cam_to_world` and `cam_fov`.  Given `np.asarray` of each field of
    a gpuspectral_tpu SceneData and its static fields, it carries that scene
    across unchanged (its BVH and bin tables are not read).  `meta` holds
    META_FIELDS; `has_textures` / `has_envmap` may be present and must be
    false."""
    check_slice(int(meta["num_tris"]), bool(meta.get("has_textures", False)),
                bool(meta.get("has_envmap", False)))
    t = {k: torch.as_tensor(np.array(arrays[k], copy=True), device=device)
         for k in ARRAY_FIELDS}
    return SceneData(
        tri_pos=t["tri_pos"], tri_nrm=t["tri_nrm"], tri_bsdf=t["tri_bsdf"],
        tri_emission=t["tri_emission"], tri_twofaced=t["tri_twofaced"],
        tri_light_idx=t["tri_light_idx"], tri_woop=t["tri_woop"],
        tri_woop_t=t["tri_woop_t"], bsdf_kind=t["bsdf_kind"],
        bsdf_params=t["bsdf_params"], light_pos=t["light_pos"],
        light_emission=t["light_emission"], light_cdf=t["light_cdf"],
        light_prob=t["light_prob"],
        camera=CameraData(to_world=t["cam_to_world"], fov=t["cam_fov"]),
        num_tris=int(meta["num_tris"]),
        num_lights=int(meta["num_lights"]),
        kinds_present=tuple(int(k) for k in meta["kinds_present"]),
        has_area_lights=bool(meta["has_area_lights"]),
    )


def scene_to_arrays(scene: SceneData) -> tuple[dict, dict]:
    """Inverse of scene_from_arrays: (numpy tables, static metadata)."""
    arrays = {k: getattr(scene, k).cpu().numpy() for k in ARRAY_FIELDS
              if not k.startswith("cam_")}
    arrays["cam_to_world"] = scene.camera.to_world.cpu().numpy()
    arrays["cam_fov"] = scene.camera.fov.cpu().numpy()
    meta = {k: getattr(scene, k) for k in META_FIELDS}
    return arrays, meta
