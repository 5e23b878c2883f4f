"""ctypes bindings for the repo's native IO library (native/*.cpp: a fast
OBJ parser and the EXR PIZ decoder).

The port's counterpart of gpuspectral_tpu/_native: `get_lib()` returns the
loaded library, or None when it cannot be built or loaded, and callers then
take their pure-Python paths.  The library is built at first use with g++
from the top-level native/ sources (the flags of native/Makefile) into
build/native/ beside the package (gitignored); GST_NATIVE_BUILD_DIR
overrides the directory.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

_REPO = pathlib.Path(__file__).resolve().parent.parent
_SRC = _REPO / "native"
_SOURCES = ("obj_parser.cpp", "exr_piz.cpp")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_tried = False


def _so_path() -> pathlib.Path:
    root = os.environ.get("GST_NATIVE_BUILD_DIR") or str(_REPO / "build" / "native")
    return pathlib.Path(root) / "libgsnative.so"


def _build(so: pathlib.Path) -> bool:
    srcs = [_SRC / s for s in _SOURCES]
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or not all(s.exists() for s in srcs):
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.so")
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), *map(str, srcs)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def get_lib():
    """The native library (built first if needed), or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.obj_parse.restype = ctypes.c_long
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.obj_fill.restype = None
    lib.obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_float)] * 3
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.piz_decode.restype = ctypes.c_int
    lib.piz_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
    _lib = lib
    return lib
