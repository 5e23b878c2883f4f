"""OpenEXR scanline reader (NO/ZIPS/ZIP/PIZ compression).

The port's copy of gpuspectral_tpu/io/exr.py (numpy only); PIZ goes through
the port's own loader of the native library (gpuspectral_tpu_torch/_native.py).

PIZ decoding runs through the native library (native/exr_piz.cpp); ZIP/none
are pure Python.  Supports the subset our golden files use: single-part
scanline images, HALF or FLOAT channels, increasing-y line order — enough to
read the reference's TungstenRender.exr ground truths.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_PIXELTYPE_SIZE = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}


def _cstr(data: bytes, pos: int) -> Tuple[str, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin1"), end + 1


def _parse_channels(raw: bytes) -> List[Tuple[str, int]]:
    out = []
    pos = 0
    while raw[pos] != 0:
        name, pos = _cstr(raw, pos)
        ptype, _flags, _xs, _ys = struct.unpack_from("<iiii", raw, pos)
        pos += 16
        out.append((name, ptype))
    return out


def _unzip_predictor(payload: bytes, raw_len: int) -> bytes:
    if len(payload) == raw_len:
        return payload
    inter = np.frombuffer(zlib.decompress(payload), np.uint8)
    half = (len(inter) + 1) // 2
    d = np.empty_like(inter)
    d[0::2] = inter[:half]
    d[1::2] = inter[half:]
    dd = d.astype(np.int32)
    s = (np.cumsum(np.concatenate([[int(d[0])], dd[1:] - 128])) % 256).astype(np.uint8)
    return s.tobytes()


def read_exr(path: str) -> np.ndarray:
    """-> (H, W, 3) float32 RGB (missing channels zero-filled)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<II", data, 0)
    if magic != 20000630:
        raise ValueError(f"not an EXR file: {path}")
    pos = 8
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while True:
        name, pos = _cstr(data, pos)
        if not name:
            break
        typ, pos = _cstr(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size

    channels = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if comp not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"compression {comp} unsupported")
    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = -(-h // lpb)
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    chan_arrays = {
        name: np.zeros((h, w), np.float32) for name, _ in channels
    }

    if comp == 4:
        from .._native import get_lib

        lib = get_lib()
        if lib is None:
            raise RuntimeError("PIZ EXR requires the native library (make -C native)")
        if any(pt != 1 for _, pt in channels):
            raise NotImplementedError("PIZ reader supports HALF channels only")
        import ctypes

        n_ch = len(channels)
        for off in offsets:
            y, size = struct.unpack_from("<ii", data, off)
            payload = data[off + 8 : off + 8 + size]
            lines = min(lpb, y1 - y + 1)
            out = np.empty((n_ch, lines, w), np.uint16)
            rc = lib.piz_decode(
                payload,
                len(payload),
                n_ch,
                w,
                lines,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            )
            if rc != 0:
                raise RuntimeError(f"piz_decode failed at y={y}: {rc}")
            yy = y - y0
            for ci, (name, _) in enumerate(channels):
                chan_arrays[name][yy : yy + lines] = (
                    out[ci].view(np.float16).astype(np.float32)
                )
    else:
        for off in offsets:
            y, size = struct.unpack_from("<ii", data, off)
            payload = data[off + 8 : off + 8 + size]
            lines = min(lpb, y1 - y + 1)
            row_bytes = sum(_PIXELTYPE_SIZE[pt] for _, pt in channels) * w
            raw = _unzip_predictor(payload, row_bytes * lines) if comp else payload
            p = 0
            for li in range(lines):
                for name, pt in channels:
                    nbytes = _PIXELTYPE_SIZE[pt] * w
                    seg = raw[p : p + nbytes]
                    p += nbytes
                    if pt == 1:
                        vals = np.frombuffer(seg, np.float16).astype(np.float32)
                    elif pt == 2:
                        vals = np.frombuffer(seg, "<f4")
                    else:
                        vals = np.frombuffer(seg, "<u4").astype(np.float32)
                    chan_arrays[name][y - y0 + li] = vals

    img = np.zeros((h, w, 3), np.float32)
    for i, ch in enumerate("RGB"):
        if ch in chan_arrays:
            img[:, :, i] = chan_arrays[ch]
    return img
