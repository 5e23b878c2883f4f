"""Texture loading (port of gpuspectral_tpu/scene/texture.py, numpy only).

Every texture is resampled to one fixed-resolution linear-light RGB tile, so
a scene's textures form one dense atlas (SceneData.textures) and a shaded
hit reads one texel.  Bitmaps load through PIL, imported only when a bitmap
is read.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .data import TEX_RES


def load_bitmap(path: str, gamma: float = 2.2) -> np.ndarray:
    """-> (TEX_RES, TEX_RES, 3) float32 linear.  LDR images are sRGB-decoded
    (Mitsuba semantics).  Row 0 is v = 1 (the top)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((TEX_RES, TEX_RES), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr**gamma


def make_checkerboard(
    color0=(0.4, 0.4, 0.4), color1=(0.2, 0.2, 0.2), uscale: float = 1.0, vscale: float = 1.0
) -> np.ndarray:
    """Procedural checkerboard (the reference's createCheckerboard analogue,
    Loader.cpp:128-139)."""
    u = (np.arange(TEX_RES) + 0.5) / TEX_RES
    v = (np.arange(TEX_RES) + 0.5) / TEX_RES
    uu, vv = np.meshgrid(u, 1.0 - v)
    cell = (np.floor(uu * 2 * uscale) + np.floor(vv * 2 * vscale)) % 2
    c0 = np.asarray(color0, np.float32)
    c1 = np.asarray(color1, np.float32)
    return np.where(cell[..., None] > 0.5, c0, c1).astype(np.float32)


def missing_texture() -> np.ndarray:
    """Neutral white tile for an unresolvable texture file: modulation 1.0
    renders the material as if untextured, as the reference (which never
    samples textures) does."""
    return np.ones((TEX_RES, TEX_RES, 3), np.float32)


def load_texture_element(elem, parent_dir: str) -> np.ndarray | None:
    """Translate a Mitsuba <texture> element into an atlas tile."""
    ttype = elem.get("type", "")
    if ttype == "bitmap":
        fn = None
        for child in elem:
            if child.tag == "string" and child.get("name") == "filename":
                fn = child.get("value")
        if not fn:
            return None
        path = os.path.join(parent_dir, fn)
        if not os.path.exists(path):
            print(f"WARN: missing texture {path}; using placeholder", file=sys.stderr)
            return missing_texture()
        try:
            return load_bitmap(path)
        except (ImportError, OSError, ValueError) as e:  # no PIL, or an unreadable image
            print(f"WARN: cannot read texture {path} ({e}); using placeholder", file=sys.stderr)
            return missing_texture()
    if ttype == "checkerboard":
        def color(name, default):
            for child in elem:
                if child.get("name") == name and child.tag in ("rgb", "spectrum", "color"):
                    parts = [float(x) for x in child.get("value").replace(",", " ").split()]
                    if len(parts) == 1:
                        parts *= 3
                    return tuple(parts[:3])
            return default

        def number(name, default):
            for child in elem:
                if child.get("name") == name and child.tag in ("float", "integer"):
                    return float(child.get("value"))
            return default

        return make_checkerboard(
            color("color0", (0.4, 0.4, 0.4)),
            color("color1", (0.2, 0.2, 0.2)),
            number("uscale", 1.0),
            number("vscale", 1.0),
        )
    return None
