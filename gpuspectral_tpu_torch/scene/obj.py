"""Wavefront OBJ loading -> flat triangle soup (numpy).

A copy of gpuspectral_tpu/scene/obj.py (that package's scene/ imports JAX);
the native parser comes through the port's own loader, _native.py.

Matches the reference's import semantics (engine/Loader.cpp:19-64): every
face-vertex becomes its own vertex (unindexed soup), positions/normals/uvs
are pulled through the OBJ index triplets, polygons are fan-triangulated
(tinyobjloader's default).  Missing normals are filled with the geometric
face normal; missing uvs with 0.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

_MESH_CACHE: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


def load_obj(path: str, cache: bool = True):
    """-> (positions (N,3,3), normals (N,3,3), uvs (N,3,2)) float32,
    N = triangle count, second axis = triangle corner.

    Uses the native parser (native/obj_parser.cpp) when built — ~20x faster
    on the big interior scenes — with this pure-Python fallback."""
    key = os.path.abspath(path)
    if cache and key in _MESH_CACHE:
        return _MESH_CACHE[key]

    if os.path.exists(path):
        native = _load_obj_native(path)
        if native is not None:
            if cache:
                _MESH_CACHE[key] = native
            return native

    vs: list = []
    vts: list = []
    vns: list = []
    face_corners: list = []  # list of per-face lists of (vi, ti, ni)

    if not os.path.exists(path):
        # match the reference's tolerance: tinyobj fails, a warning prints,
        # and the shape imports as an empty mesh (Loader.cpp:29-35)
        import sys

        print(f"WARN: missing OBJ file {path}; importing empty mesh", file=sys.stderr)
        return (
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 2), np.float32),
        )

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                vns.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = int(comp[0])
                    ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                    ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
                    corners.append((vi, ti, ni))
                face_corners.append(corners)

    v = np.asarray(vs, np.float32).reshape(-1, 3)
    vt = np.asarray(vts, np.float32).reshape(-1, 2) if vts else np.zeros((0, 2), np.float32)
    vn = np.asarray(vns, np.float32).reshape(-1, 3) if vns else np.zeros((0, 3), np.float32)

    def _resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    tri_pos, tri_nrm, tri_uv = [], [], []
    for corners in face_corners:
        # fan triangulation
        for a, b in zip(range(1, len(corners) - 1), range(2, len(corners))):
            tri = [corners[0], corners[a], corners[b]]
            p = np.stack([v[_resolve(c[0], len(v))] for c in tri])
            if all(c[2] for c in tri) and len(vn):
                n = np.stack([vn[_resolve(c[2], len(vn))] for c in tri])
            else:
                g = np.cross(p[1] - p[0], p[2] - p[0])
                g = g / max(np.linalg.norm(g), 1e-20)
                n = np.broadcast_to(g, (3, 3)).copy()
            if all(c[1] for c in tri) and len(vt):
                t = np.stack([vt[_resolve(c[1], len(vt))] for c in tri])
            else:
                t = np.zeros((3, 2), np.float32)
            tri_pos.append(p)
            tri_nrm.append(n)
            tri_uv.append(t)

    if tri_pos:
        out = (
            np.stack(tri_pos).astype(np.float32),
            np.stack(tri_nrm).astype(np.float32),
            np.stack(tri_uv).astype(np.float32),
        )
    else:
        out = (
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 2), np.float32),
        )
    if cache:
        _MESH_CACHE[key] = out
    return out


def _load_obj_native(path: str):
    import ctypes

    from .._native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    n = lib.obj_parse(path.encode(), ctypes.byref(handle))
    if n < 0:
        return None
    pos = np.empty((n, 3, 3), np.float32)
    nrm = np.empty((n, 3, 3), np.float32)
    uv = np.empty((n, 3, 2), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.obj_fill(
        handle,
        pos.ctypes.data_as(fp),
        nrm.ctypes.data_as(fp),
        uv.ctypes.data_as(fp),
    )
    lib.obj_free(handle)
    return pos, nrm, uv


def _soup(pos, nrm, uv=None):
    pos = np.asarray(pos, np.float32)
    nrm = np.asarray(nrm, np.float32)
    if uv is None:
        uv = np.zeros(pos.shape[:-1] + (2,), np.float32)
    return pos, nrm, np.asarray(uv, np.float32)


def make_rectangle():
    """Unit rectangle in [-1,1]^2 at z=0, +z normal — the geometry the
    reference ships as assets/rect.obj for the `rectangle` shape plugin
    (same winding and vt layout)."""
    v1, v2, v3, v4 = [-1, 1, 0], [1, 1, 0], [-1, -1, 0], [1, -1, 0]
    t1, t2, t3, t4 = [0, 1], [1, 1], [0, 0], [1, 0]
    pos = np.array([[v1, v3, v2], [v3, v4, v2]], np.float32)
    uv = np.array([[t1, t3, t2], [t3, t4, t2]], np.float32)
    n = np.broadcast_to(np.array([0, 0, 1], np.float32), (2, 3, 3)).copy()
    return _soup(pos, n, uv)


def make_cube():
    """Axis-aligned [-1,1]^3 cube (12 tris, outward normals) — the geometry
    behind the `cube` shape plugin (assets/box.obj)."""
    tris, nrms, uvs = [], [], []
    for axis in range(3):
        for sgn in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sgn
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            w = np.cross(n, u)
            c = n  # face center
            q = [c + (-u - w), c + (u - w), c + (u + w), c + (-u + w)]
            # wind CCW as seen from outside
            tris.append([q[0], q[1], q[2]])
            tris.append([q[0], q[2], q[3]])
            nrms += [[n, n, n], [n, n, n]]
            uvs += [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]]
    return _soup(np.asarray(tris), np.asarray(nrms), np.asarray(uvs, np.float32))


def make_disk(segments: int = 64):
    """Unit disk at z=0 (+z normal) — the `disk` shape plugin."""
    tris, nrms = [], []
    n = np.array([0, 0, 1], np.float32)
    for i in range(segments):
        a0 = 2 * np.pi * i / segments
        a1 = 2 * np.pi * (i + 1) / segments
        p0 = [np.cos(a0), np.sin(a0), 0.0]
        p1 = [np.cos(a1), np.sin(a1), 0.0]
        tris.append([[0.0, 0.0, 0.0], p0, p1])
        nrms.append([n, n, n])
    return _soup(np.asarray(tris), np.asarray(nrms))
