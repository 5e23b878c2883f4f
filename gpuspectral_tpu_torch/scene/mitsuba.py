"""Mitsuba-XML scene importer (pure Python, no third-party parser).

Covers exactly the plugin surface the reference consumes through
TinyParser-Mitsuba (engine/Loader.cpp:145-234,253-349):

  shapes     obj | rectangle | cube | disk | sphere  (Loader.cpp:272-279;
             sphere is beyond the reference's set)
  bsdfs      twosided | diffuse | roughplastic | dielectric | conductor |
             plastic | roughconductor             (Loader.cpp:147-227)
  emitters   area (per-shape)                     (Loader.cpp:301-307)
             envmap | constant (scene level; the reference parses and
             drops them, here they shade)
  textures   bitmap | checkerboard bound to a diffuse reflectance or a
             roughplastic diffuse_reflectance (the reference leaves them
             unbound, Loader.cpp:122-143)
  sensor     perspective (fov, to_world)          (Loader.cpp:331-337)
  film       width/height; sampler sample_count; integrator max_depth
             (parsed — the reference parses but ignores these; we honor them)

Property names are normalized camelCase -> snake_case the way
TinyParser-Mitsuba does ("intIOR" -> "int_ior"), and `<ref id=.../>`
resolution + nested-bsdf recursion match the reference loader.

A port of gpuspectral_tpu/scene/mitsuba.py that builds this package's
SceneData.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from ..bsdf import table as bt
from ..utils.profiling import stage
from .data import SceneBuilder, _build_scene, check_device
from .obj import load_obj, make_cube, make_disk, make_rectangle

_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


def _parse_rgb(value: str) -> np.ndarray:
    parts = [float(x) for x in value.replace(",", " ").split()]
    if len(parts) == 1:
        parts = parts * 3
    return np.asarray(parts[:3], np.float32)


class _Props:
    """Normalized property bag for one XML element."""

    def __init__(self, elem: ET.Element):
        self.floats: Dict[str, float] = {}
        self.ints: Dict[str, int] = {}
        self.bools: Dict[str, bool] = {}
        self.strings: Dict[str, str] = {}
        self.rgbs: Dict[str, np.ndarray] = {}
        self.transforms: Dict[str, np.ndarray] = {}
        self.vectors: Dict[str, np.ndarray] = {}
        for child in elem:
            name = _snake(child.get("name", ""))
            tag = child.tag
            if tag == "float":
                self.floats[name] = float(child.get("value"))
            elif tag == "integer":
                self.ints[name] = int(child.get("value"))
            elif tag == "boolean":
                self.bools[name] = child.get("value", "false").lower() == "true"
            elif tag == "string":
                self.strings[name] = child.get("value", "")
            elif tag in ("rgb", "spectrum", "color"):
                self.rgbs[name] = _parse_rgb(child.get("value", "0"))
            elif tag == "transform":
                self.transforms[name] = _parse_transform(child)
            elif tag in ("point", "vector"):
                if child.get("value") is not None:
                    self.vectors[name] = _parse_rgb(child.get("value"))
                else:
                    self.vectors[name] = np.asarray(
                        [float(child.get(a, 0.0)) for a in "xyz"], np.float32
                    )

    def number(self, name: str, default: Optional[float] = None) -> Optional[float]:
        if name in self.floats:
            return self.floats[name]
        if name in self.ints:
            return float(self.ints[name])
        return default

    def color(self, name: str, default=(0.0, 0.0, 0.0)) -> np.ndarray:
        if name in self.rgbs:
            return self.rgbs[name]
        if name in self.floats:  # scalar-valued reflectance
            return np.full((3,), self.floats[name], np.float32)
        return np.asarray(default, np.float32)


def _rotation_matrix(axis: np.ndarray, angle_deg: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-20)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ],
        np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    return m


def _parse_transform(elem: ET.Element) -> np.ndarray:
    """Compose child ops in document order: each later op applies after
    (left-multiplies) the earlier ones, Mitsuba semantics."""
    m = np.eye(4, dtype=np.float32)
    for child in elem:
        tag = child.tag
        op = np.eye(4, dtype=np.float32)
        if tag == "matrix":
            vals = [float(x) for x in child.get("value").split()]
            op = np.asarray(vals, np.float32).reshape(4, 4)  # row-major
        elif tag == "translate":
            for i, a in enumerate("xyz"):
                op[i, 3] = float(child.get(a, 0.0))
            if child.get("value") is not None:
                op[:3, 3] = _parse_rgb(child.get("value"))
        elif tag == "scale":
            if child.get("value") is not None:
                v = _parse_rgb(child.get("value"))
                for i in range(3):
                    op[i, i] = v[i]
            else:
                for i, a in enumerate("xyz"):
                    op[i, i] = float(child.get(a, 1.0))
        elif tag == "rotate":
            axis = np.asarray([float(child.get(a, 0.0)) for a in "xyz"], np.float32)
            op = _rotation_matrix(axis, float(child.get("angle", 0.0)))
        elif tag == "lookat" or tag == "look_at":
            origin = _parse_rgb(child.get("origin"))
            target = _parse_rgb(child.get("target"))
            up = _parse_rgb(child.get("up", "0, 1, 0"))
            fwd = target - origin
            fwd = fwd / max(np.linalg.norm(fwd), 1e-20)
            left = np.cross(up / max(np.linalg.norm(up), 1e-20), fwd)
            left = left / max(np.linalg.norm(left), 1e-20)
            new_up = np.cross(fwd, left)
            op[:3, 0], op[:3, 1], op[:3, 2], op[:3, 3] = left, new_up, fwd, origin
        m = op @ m
    return m


class _MaterialSpec:
    """Mirrors the reference's Material{emission, twofaced, bsdf}."""

    def __init__(self):
        self.twofaced = False
        self.bsdf_index: Optional[int] = None
        self.emission = np.zeros(3, np.float32)
        self.face_normals = False


def _texture_for(elem: ET.Element, prop_name: str, parent_dir: str):
    """Load the <texture> child bound to `prop_name`, if any
    (mitsuba.py:167-175)."""
    from .texture import load_texture_element

    for child in elem:
        if child.tag == "texture" and _snake(child.get("name", "")) == prop_name:
            return load_texture_element(child, parent_dir)
    return None


def _load_bsdf_into(
    builder: SceneBuilder, mat: _MaterialSpec, elem: ET.Element, parent_dir: str = "."
) -> None:
    """Recursive translation of <bsdf> elements (Loader.cpp:145-234)."""
    btype = elem.get("type", "")
    props = _Props(elem)
    if btype == "twosided":
        mat.twofaced = True
    elif btype == "diffuse":
        mat.bsdf_index = builder.add_bsdf(
            bt.diffuse(props.color("reflectance", (0.5, 0.5, 0.5))),
            texture=_texture_for(elem, "reflectance", parent_dir),
        )
    elif btype == "roughplastic":
        ior = props.number("int_ior", 1.3)
        r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        alpha = props.number("alpha", 0.1)
        mat.bsdf_index = builder.add_bsdf(
            bt.rough_plastic(
                props.color("diffuse_reflectance", (0.5, 0.5, 0.5)),
                ior_in=ior,
                ior_out=1.0,
                r0=r0,
                # the reference widens alpha by sqrt(2) (Loader.cpp:179)
                alpha=float(np.sqrt(2.0)) * alpha,
            ),
            texture=_texture_for(elem, "diffuse_reflectance", parent_dir),
        )
    elif btype == "dielectric":
        mat.bsdf_index = builder.add_bsdf(
            bt.smooth_dielectric(
                ior_in=props.number("int_ior", 1.5046),
                ior_out=props.number("ext_ior", 1.0),
            )
        )
    elif btype == "conductor":
        mat.bsdf_index = builder.add_bsdf(
            bt.smooth_conductor(ior_in=props.number("eta", 0.0), ior_out=1.0)
        )
    elif btype == "plastic":
        ior = props.number("int_ior", 1.3)
        r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        mat.bsdf_index = builder.add_bsdf(
            bt.smooth_plastic(
                props.color("diffuse_reflectance", (0.5, 0.5, 0.5)),
                ior_in=ior,
                ior_out=1.0,
                r0=r0,
            )
        )
    elif btype == "roughconductor":
        alpha = props.number("alpha", 0.1)
        mat.bsdf_index = builder.add_bsdf(
            bt.rough_conductor(
                eta=props.color("eta", (0.0, 0.0, 0.0)),
                k=props.color("k", (1.0, 1.0, 1.0)),
                reflectance=props.color("specular_reflectance", (1.0, 1.0, 1.0)),
                alpha=float(np.sqrt(2.0)) * alpha,
            )
        )
    # recurse into nested bsdfs (e.g. twosided wrappers), Loader.cpp:229-233
    for child in elem:
        if child.tag == "bsdf":
            _load_bsdf_into(builder, mat, child, parent_dir)


def load_mitsuba_scene(
    path: str,
    builder: Optional[SceneBuilder] = None,
    build: bool = True,
    device="cuda",
):
    """Parse a Mitsuba scene XML into a SceneBuilder, or into
    (SceneData on `device`, SceneBuilder) when `build`.  The parse is the
    span "gst.scene.parse" (utils/profiling); with `build` the call is the
    span "gst.scene.load", which holds it and the build's spans."""
    if not build:
        with stage("gst.scene.parse"):
            return _parse(path, builder or SceneBuilder())
    check_device(device)  # before the parse: no CUDA device raises at once
    with stage("gst.scene.load"):
        with stage("gst.scene.parse"):
            b = _parse(path, builder or SceneBuilder())
        return _build_scene(b, device, "sah"), b


def _parse(path: str, b: SceneBuilder) -> SceneBuilder:
    """The scene XML's shapes, sensor, integrator and environment emitters
    added to the SceneBuilder b."""
    parent = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()

    named_bsdfs: Dict[str, ET.Element] = {}

    for elem in root:
        if elem.tag == "bsdf" and elem.get("id"):
            named_bsdfs[elem.get("id")] = elem

    for elem in root:
        if elem.tag == "shape":
            stype = elem.get("type", "")
            props = _Props(elem)
            if stype == "obj":
                fname = os.path.join(parent, props.strings.get("filename", ""))
                if (not os.path.exists(fname)
                        and os.path.basename(fname) == "sphere.obj"):
                    # The reference ships scenes referencing a sphere.obj
                    # that is absent from its assets (test3/scene.xml:165-178
                    # — its loader imports an empty mesh and the two glossy
                    # spheres silently vanish, Loader.cpp:29-35).  Substitute
                    # the native unit-sphere tessellation at the same
                    # to_world so the dielectric + roughconductor spheres
                    # actually render.  Dense enough that the pair
                    # contributes >= 18k glossy triangles (config-3 scale).
                    pos, nrm, uv = _make_sphere(props, lat=48, lon=96)
                else:
                    pos, nrm, uv = load_obj(fname)
            elif stype == "rectangle":
                pos, nrm, uv = make_rectangle()
            elif stype == "cube":
                pos, nrm, uv = make_cube()
            elif stype == "disk":
                pos, nrm, uv = make_disk()
            elif stype == "sphere":
                pos, nrm, uv = _make_sphere(props)
            else:
                continue

            transform = props.transforms.get("to_world", np.eye(4, dtype=np.float32))
            if "center" in props.vectors:  # Loader.cpp:287-293
                transform = transform.copy()
                transform[:3, 3] = props.vectors["center"]

            mat = _MaterialSpec()
            mat.face_normals = props.bools.get("face_normals", False)
            for child in elem:
                if child.tag == "ref":
                    ref = named_bsdfs.get(child.get("id"))
                    if ref is not None:
                        _load_bsdf_into(b, mat, ref, parent)
                elif child.tag == "bsdf":
                    _load_bsdf_into(b, mat, child, parent)
                elif child.tag == "emitter" and child.get("type") == "area":
                    mat.emission = _Props(child).color("radiance")

            if mat.bsdf_index is None:
                mat.bsdf_index = b.add_bsdf(bt.diffuse((0.5, 0.5, 0.5)))

            b.add_object(
                pos,
                nrm,
                uv,
                transform,
                mat.bsdf_index,
                emission=mat.emission,
                twofaced=mat.twofaced,
            )
        elif elem.tag == "sensor":
            props = _Props(elem)
            fov_deg = props.number("fov", 45.0)
            to_world = props.transforms.get("to_world", np.eye(4, dtype=np.float32))
            b.set_camera(to_world, fov_deg * np.pi / 180.0)
            for child in elem:
                cprops = _Props(child)
                if child.tag == "film":
                    b.film_width = cprops.ints.get("width", b.film_width)
                    b.film_height = cprops.ints.get("height", b.film_height)
                elif child.tag == "sampler":
                    b.film_spp = cprops.ints.get("sample_count", b.film_spp)
        elif elem.tag == "integrator":
            props = _Props(elem)
            b.max_depth = props.ints.get("max_depth", b.max_depth)
        elif elem.tag == "emitter":
            # scene-level environment emitters (mitsuba.py:334-363)
            props = _Props(elem)
            etype = elem.get("type", "")
            if etype == "constant":
                rad = props.rgbs.get("radiance", np.asarray([1, 1, 1], np.float32))
                b.set_envmap(np.broadcast_to(rad, (1, 1, 3)))
            elif etype == "envmap":
                fname = os.path.join(parent, props.strings.get("filename", ""))
                img = None
                if fname.endswith(".exr"):
                    from ..io.exr import read_exr

                    img = read_exr(fname)
                elif fname.endswith(".pfm"):
                    from ..io.image import read_pfm

                    img = read_pfm(fname)
                elif os.path.exists(fname):
                    from .texture import load_bitmap

                    img = load_bitmap(fname, gamma=1.0)
                if img is not None:
                    b.set_envmap(
                        img[..., :3],
                        to_world=props.transforms.get("to_world"),
                        scale=props.number("scale", 1.0),
                    )

    return b


def _make_sphere(props: _Props, lat: int = 32, lon: int = 64):
    """UV-sphere tessellation for `sphere` shapes (the reference routes these
    through missing .obj files; we support them natively)."""
    radius = props.number("radius", 1.0)
    us = np.linspace(0.0, np.pi, lat + 1)
    vs = np.linspace(0.0, 2 * np.pi, lon + 1)
    tris, nrms = [], []
    for i in range(lat):
        for j in range(lon):
            def pt(ti, pj):
                st, ct = np.sin(us[ti]), np.cos(us[ti])
                sp, cp = np.sin(vs[pj]), np.cos(vs[pj])
                return np.array([st * cp, ct, st * sp], np.float32)

            p00, p01 = pt(i, j), pt(i, j + 1)
            p10, p11 = pt(i + 1, j), pt(i + 1, j + 1)
            # wind CCW seen from OUTSIDE (cross(e1, e2) must agree with the
            # outward shading normals: one-sided area-emitter gating and the
            # backface tests follow the winding normal — an inside-out sphere
            # emits inward and its lamp renders black, which is exactly how
            # this bug originally presented on living-room)
            if i > 0:
                tris.append([p00 * radius, p01 * radius, p10 * radius])
                nrms.append([p00, p01, p10])
            if i < lat - 1:
                tris.append([p01 * radius, p11 * radius, p10 * radius])
                nrms.append([p01, p11, p10])
    return (
        np.asarray(tris, np.float32),
        np.asarray(nrms, np.float32),
        np.zeros((len(tris), 3, 2), np.float32),
    )
