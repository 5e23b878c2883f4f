"""The reference's own scenes: built from the configuration's inputs with
numpy, never from the port's scene tables.

Two sources of geometry, named by a configuration's "scene" block:

  mitsuba_xml   a Mitsuba scene file of the subset the Cornell box uses
                (rectangle and cube shapes, diffuse and twosided BSDFs, area
                emitters, a perspective sensor given by a matrix, film,
                sampler and integrator); anything else raises, so a new
                configuration never renders silently wrong
  builtin       a scene generated by code: the module scene_<name> of this
                package, found by the name, holds build_builder(spec)
                (scene_sphere_field: a frozen copy of the sphere field of
                gpuspectral_tpu_torch/scene/zoo.py)

The triangles stay in the order the scene adds them (the port sorts them
into BVH slot order; only exact-t ties between two triangles can tell the
two orders apart).  `RefScene` holds what the plain path tracer reads:
triangle rows, Woop rows, the light table with its power CDF, the
environment map with its sampling tables and the texture atlas.
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
import torch

from . import bsdf_table as bt

TEX_RES = 256  # atlas resolution every texture is resampled to


# ---------------------------------------------------------------- builder


@dataclasses.dataclass
class Builder:
    """Host-side accumulation of a scene's objects (the port's SceneBuilder
    semantics: per-object transforms, mirrored transforms re-wound, every
    emitting triangle a light)."""

    tri_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_nrm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_bsdf: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_twofaced: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_light_idx: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdfs: bt.BSDFTable = dataclasses.field(default_factory=bt.BSDFTable)
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdf_tex: List[int] = dataclasses.field(default_factory=list)
    cam_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    cam_fov: float = np.pi / 2
    envmap_image: Optional[np.ndarray] = None

    def add_bsdf(self, kind_row, texture: Optional[np.ndarray] = None) -> int:
        idx = self.bsdfs.add(kind_row)
        if texture is not None:
            self.textures.append(np.asarray(texture, np.float32))
            self.bsdf_tex.append(len(self.textures) - 1)
        else:
            self.bsdf_tex.append(-1)
        return idx

    def add_object(self, positions, normals, uvs, transform, bsdf_index, emission=(0.0, 0.0, 0.0),
                   twofaced=False):
        n = positions.shape[0]
        transform = np.asarray(transform, np.float32)
        pos = positions @ transform[:3, :3].T + transform[:3, 3]
        inv_t = np.linalg.inv(transform[:3, :3]).T.astype(np.float32)
        nrm = normals @ inv_t.T
        if uvs is None:
            uvs = np.zeros((n, 3, 2), np.float32)
        if np.linalg.det(transform[:3, :3]) < 0.0:
            pos, nrm, uvs = pos[:, [0, 2, 1]], nrm[:, [0, 2, 1]], np.asarray(uvs)[:, [0, 2, 1]]
        emission = np.asarray(emission, np.float32)
        self.tri_pos.append(pos.astype(np.float32))
        self.tri_nrm.append(nrm.astype(np.float32))
        self.tri_uv.append(np.asarray(uvs, np.float32))
        self.tri_bsdf.append(np.full((n,), bsdf_index, np.int32))
        self.tri_emission.append(np.broadcast_to(emission, (n, 3)).copy())
        self.tri_twofaced.append(np.full((n,), twofaced, bool))
        if np.any(emission > 0.0):
            base = sum(x.shape[0] for x in self.light_pos)
            self.tri_light_idx.append(np.arange(base, base + n, dtype=np.int32))
            self.light_pos.append(pos.astype(np.float32))
            self.light_emission.append(np.broadcast_to(emission, (n, 3)).copy())
        else:
            self.tri_light_idx.append(np.full((n,), -1, np.int32))


def rectangle():
    v1, v2, v3, v4 = [-1, 1, 0], [1, 1, 0], [-1, -1, 0], [1, -1, 0]
    t1, t2, t3, t4 = [0, 1], [1, 1], [0, 0], [1, 0]
    pos = np.array([[v1, v3, v2], [v3, v4, v2]], np.float32)
    uv = np.array([[t1, t3, t2], [t3, t4, t2]], np.float32)
    n = np.broadcast_to(np.array([0, 0, 1], np.float32), (2, 3, 3)).copy()
    return pos, n, uv


def _cube():
    tris, nrms, uvs = [], [], []
    for axis in range(3):
        for sgn in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sgn
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            w = np.cross(n, u)
            q = [n + (-u - w), n + (u - w), n + (u + w), n + (-u + w)]
            tris += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
            nrms += [[n, n, n], [n, n, n]]
            uvs += [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]]
    return (np.asarray(tris, np.float32), np.asarray(nrms, np.float32),
            np.asarray(uvs, np.float32))


# ---------------------------------------------------------------- Mitsuba subset

_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _snake(name: str) -> str:
    return _CAMEL.sub("_", name).lower()


def _rgb(value: str) -> np.ndarray:
    parts = [float(x) for x in value.replace(",", " ").split()]
    return np.asarray((parts * 3)[:3] if len(parts) == 1 else parts[:3], np.float32)


def _matrix(elem: ET.Element) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    for child in elem:
        if child.tag != "matrix":
            raise ValueError(f"reference scene: transform <{child.tag}> is not supported")
        m = np.asarray([float(x) for x in child.get("value").split()], np.float32).reshape(4, 4) @ m
    return m


def _props(elem: ET.Element) -> dict:
    out = {}
    for child in elem:
        name = _snake(child.get("name", ""))
        if child.tag in ("float", "integer"):
            out[name] = float(child.get("value"))
        elif child.tag == "rgb":
            out[name] = _rgb(child.get("value"))
        elif child.tag == "transform":
            out[name] = _matrix(child)
    return out


def _bsdf_into(b: Builder, mat: dict, elem: ET.Element):
    kind = elem.get("type")
    if kind == "twosided":
        mat["twofaced"] = True
    elif kind == "diffuse":
        refl = _props(elem).get("reflectance", np.full(3, 0.5, np.float32))
        mat["bsdf"] = b.add_bsdf(bt.diffuse(refl))
    else:
        raise ValueError(f"reference scene: bsdf {kind!r} is not supported")
    for child in elem:
        if child.tag == "bsdf":
            _bsdf_into(b, mat, child)


def load_mitsuba_xml(path: str) -> tuple[Builder, dict]:
    """(Builder, film) of a Mitsuba file in the subset this module covers;
    film holds width, height, spp and max_depth as the file states them."""
    b = Builder()
    root = ET.parse(path).getroot()
    named = {e.get("id"): e for e in root if e.tag == "bsdf" and e.get("id")}
    film = {}
    for elem in root:
        if elem.tag == "shape":
            shapes = {"rectangle": rectangle, "cube": _cube}
            if elem.get("type") not in shapes:
                raise ValueError(f"reference scene: shape {elem.get('type')!r} is not supported")
            pos, nrm, uv = shapes[elem.get("type")]()
            xf = _props(elem).get("to_world", np.eye(4, dtype=np.float32))
            mat = dict(twofaced=False, bsdf=None, emission=np.zeros(3, np.float32))
            for child in elem:
                if child.tag == "ref":
                    _bsdf_into(b, mat, named[child.get("id")])
                elif child.tag == "bsdf":
                    _bsdf_into(b, mat, child)
                elif child.tag == "emitter":
                    if child.get("type") != "area":
                        raise ValueError("reference scene: only area emitters on shapes")
                    mat["emission"] = _props(child)["radiance"]
            if mat["bsdf"] is None:
                mat["bsdf"] = b.add_bsdf(bt.diffuse((0.5, 0.5, 0.5)))
            b.add_object(pos, nrm, uv, xf, mat["bsdf"], mat["emission"], mat["twofaced"])
        elif elem.tag == "sensor":
            if elem.get("type") != "perspective":
                raise ValueError("reference scene: only a perspective sensor")
            p = _props(elem)
            b.cam_to_world = p.get("to_world", np.eye(4, dtype=np.float32))
            b.cam_fov = float(p.get("fov", 45.0)) * np.pi / 180.0
            for child in elem:
                cp = _props(child)
                if child.tag == "film":
                    film.update(width=int(cp["width"]), height=int(cp["height"]))
                elif child.tag == "sampler":
                    film["spp"] = int(cp["sample_count"])
        elif elem.tag == "integrator":
            film["max_depth"] = int(_props(elem).get("max_depth", 50))
        elif elem.tag == "emitter":
            raise ValueError("reference scene: scene-level emitters are not supported")
    return b, film


# ---------------------------------------------------------------- tables


def woop_transform(tri_pos: np.ndarray) -> np.ndarray:
    """(T,3,3) triangles -> (T,12) [M rows x,y,z | b = -M v0]: the affine
    map of each triangle onto the unit triangle."""
    t = tri_pos.shape[0]
    v0 = tri_pos[:, 0]
    mat = np.stack([tri_pos[:, 1] - v0, tri_pos[:, 2] - v0,
                    np.cross(tri_pos[:, 1] - v0, tri_pos[:, 2] - v0)], axis=-1)
    ok = np.abs(np.linalg.det(mat)) > 1e-18
    safe = mat.copy()
    safe[~ok] = np.eye(3)
    minv = np.linalg.inv(safe)
    minv[~ok] = 0.0
    b = -np.einsum("tij,tj->ti", minv, v0)
    b[~ok] = 0.0
    return np.concatenate([minv.reshape(t, 9), b], axis=1).astype(np.float32)


def _env_tables(image):
    if image is None:
        return (np.zeros((1, 1, 3), np.float32), np.ones((1,), np.float32),
                np.ones((1, 1), np.float32))
    em = np.asarray(image, np.float32)
    he, we = em.shape[:2]
    lum = em @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    th = np.pi * np.arange(he + 1, dtype=np.float64) / he
    omega_row = (2.0 * np.pi / we) * (np.cos(th[:-1]) - np.cos(th[1:]))
    wgt = (lum + 1e-10) * omega_row[:, None].astype(np.float32)
    p_texel = wgt / wgt.sum()
    cdf = np.cumsum(p_texel.ravel()).astype(np.float32)
    cdf[-1] = 1.0
    return em, cdf, (p_texel / omega_row[:, None]).astype(np.float32)


@dataclasses.dataclass
class RefScene:
    """What the plain path tracer reads, as torch tensors on `device`."""

    tri_pos: torch.Tensor
    tri_nrm: torch.Tensor
    tri_uv: torch.Tensor
    tri_bsdf: torch.Tensor
    tri_emission: torch.Tensor
    tri_twofaced: torch.Tensor
    tri_light_idx: torch.Tensor
    woop: torch.Tensor
    bsdf_kind: torch.Tensor
    bsdf_params: torch.Tensor
    textures: torch.Tensor
    bsdf_tex: torch.Tensor
    light_pos: torch.Tensor
    light_emission: torch.Tensor
    light_cdf: torch.Tensor
    light_prob: torch.Tensor
    envmap: torch.Tensor
    envmap_rot: torch.Tensor
    envmap_cdf: torch.Tensor
    envmap_pdf: torch.Tensor
    cam_to_world: torch.Tensor
    cam_fov: torch.Tensor
    num_tris: int
    num_lights: int
    kinds_present: tuple
    has_textures: bool
    has_envmap: bool
    has_area_lights: bool

    @property
    def device(self):
        return self.tri_pos.device

    def replace(self, **kw) -> "RefScene":
        return dataclasses.replace(self, **kw)


def build(b: Builder, device) -> RefScene:
    """The reference's tables of a Builder, on `device`."""
    pos = np.concatenate(b.tri_pos)
    lpos = np.concatenate(b.light_pos) if b.light_pos else np.zeros((1, 3, 3), np.float32)
    lemit = np.concatenate(b.light_emission) if b.light_emission else np.zeros((1, 3), np.float32)
    areas = 0.5 * np.linalg.norm(np.cross(lpos[:, 1] - lpos[:, 0], lpos[:, 2] - lpos[:, 0]),
                                 axis=-1)
    power = lemit.sum(-1) * areas
    n_l = lpos.shape[0]
    prob = power / power.sum() if power.sum() > 0 else np.full((n_l,), 1.0 / n_l)
    cdf = np.cumsum(prob).astype(np.float32)
    cdf[-1] = 1.0
    env, env_cdf, env_pdf = _env_tables(b.envmap_image)
    kinds, params = b.bsdfs.pack()
    tex = (np.stack(b.textures).astype(np.float32) if b.textures
           else np.zeros((1, 1, 1, 3), np.float32))
    bsdf_tex = np.asarray(b.bsdf_tex[:len(kinds)] + [-1] * (len(kinds) - len(b.bsdf_tex)),
                          np.int32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return RefScene(
        tri_pos=t(pos), tri_nrm=t(np.concatenate(b.tri_nrm)), tri_uv=t(np.concatenate(b.tri_uv)),
        tri_bsdf=t(np.concatenate(b.tri_bsdf)), tri_emission=t(np.concatenate(b.tri_emission)),
        tri_twofaced=t(np.concatenate(b.tri_twofaced)),
        tri_light_idx=t(np.concatenate(b.tri_light_idx)), woop=t(woop_transform(pos)),
        bsdf_kind=t(kinds), bsdf_params=t(params), textures=t(tex), bsdf_tex=t(bsdf_tex),
        light_pos=t(lpos), light_emission=t(lemit), light_cdf=t(cdf),
        light_prob=t(prob.astype(np.float32)), envmap=t(env),
        envmap_rot=t(np.eye(3, dtype=np.float32)), envmap_cdf=t(env_cdf), envmap_pdf=t(env_pdf),
        cam_to_world=t(np.asarray(b.cam_to_world, np.float32)),
        cam_fov=t(np.asarray(b.cam_fov, np.float32)),
        num_tris=int(pos.shape[0]), num_lights=int(n_l),
        kinds_present=tuple(sorted(set(int(k) for k in kinds))),
        has_textures=bool(b.textures), has_envmap=b.envmap_image is not None,
        has_area_lights=bool(b.light_pos))


def scene_from_spec(spec: dict, root: str, device) -> RefScene:
    """The RefScene of a configuration's "scene" block; `root` is the
    checkout that relative paths start from.  A builtin scene's builder is
    the module `scene_<name>` of this package, found by the name."""
    import importlib
    import os

    kind = spec["kind"]
    if kind == "mitsuba_xml":
        b, _ = load_mitsuba_xml(os.path.join(root, spec["reference_file"]))
    elif kind == "builtin":
        module = f"{__package__}.scene_{spec['name']}"
        try:
            mod = importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
            raise ValueError(f"reference scene: no builder for builtin {spec['name']!r} "
                             f"(a module {module} with build_builder(spec))") from None
        b = mod.build_builder(spec)
    else:
        raise ValueError(f"reference scene: no builder for {spec}")
    return build(b, device)
