"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles every source under csrc/ into one shared library with a plain
C interface, loaded with ctypes (no PyTorch headers: a build takes seconds,
not minutes).  One nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -shared -o libgst_kernels.so *.o

--fmad=false keeps every multiply and add separately rounded, as PyTorch's
elementwise kernels are, so the kernels can be held to their plain torch
versions bit for bit where the arithmetic is the same; no --use_fast_math.

The build runs at first use, into build/kernels/<hash of the sources and
flags>/ beside the package (GST_KERNEL_BUILD_DIR overrides the parent), so
an unchanged tree reuses it.  `build_info()` reports the build seconds and
ptxas's register and spill lines per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from .utils import profiling

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_lib = None
_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    "gst_closest": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P],
    "gst_any": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P],
    "gst_mega": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "gst_bvh_closest": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "gst_bvh_any": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "gst_bvh_walk_count": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P],
    "gst_bvh_count": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "gst_cluster_votes": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P],
    "gst_cluster_closest": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _I,
                            _P, _I, _P, _P, _P, _P, _P, _P],
    "gst_cluster_any": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _I, _P,
                        _P],
    "gst_dfs_closest": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                        _P, _P, _P],
    "gst_dfs_any": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _P],
    "gst_binned_closest": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "gst_binned_any": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    "gst_binned_count": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P],
    "gst_traverse_closest": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "gst_traverse_any": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P],
    "gst_traverse_shape": [_I, _P],
    "gst_traverse_count": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                           _P, _P, _P],
    "gst_mega_bvh": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                     _P, _P, _P, _P, _P],
    "gst_mega_grad": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _P, _P, _P, _P, _P, _P, _I, _P],
    "gst_mega_bvh_grad": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
}


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels need the CUDA toolkit")


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    root = os.environ.get("GST_KERNEL_BUILD_DIR") or str(_PKG.parent / "build" / "kernels")
    return pathlib.Path(root) / h.hexdigest()[:16]


def _ptxas_summary(log: str) -> dict:
    """{kernel: "N registers, M bytes spill stores, K bytes spill loads"}."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line
        elif current and "bytes spill stores" in line:
            out[current] = line.split(":", 1)[-1].strip()
        elif current and "Used" in line and "registers" in line:
            out[current] = (out.get(current, "") + "; " + line.split(":", 1)[-1].strip()).strip("; ")
    return out


def load():
    """The loaded kernel library, building it first if needed.  The first
    call is the span "gst.kernels.load" (utils/profiling), and counts
    "kernels.built" when nvcc ran."""
    global _lib
    if _lib is not None:
        return _lib
    with profiling.stage("gst.kernels.load") as span:
        out_dir = _build_dir()
        so = out_dir / "libgst_kernels.so"
        log_path = out_dir / "ptxas.log"
        built_now = not so.exists()
        if built_now:
            _compile(out_dir, so, log_path)
            profiling.count("kernels.built")
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        log = log_path.read_text() if log_path.exists() else ""
    _info.update(
        path=str(so),
        built_now=built_now,
        seconds=span.seconds,
        ptxas=_ptxas_summary(log),
    )
    _lib = lib
    return lib


def _compile(out_dir: pathlib.Path, so: pathlib.Path, log_path: pathlib.Path) -> None:
    """nvcc: every csrc/*.cu to an object, all started together, then one
    link into `so`; ptxas's lines into `log_path`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs, procs = [], []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)], cwd=str(_CSRC),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{out[-6000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libgst_kernels.{tag}.so"
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, cwd=str(_CSRC))
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    for obj in objs:
        obj.unlink()
    log_path.write_text("\n".join(logs))
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file


def build_info() -> dict:
    """Build seconds, library path and ptxas register/spill lines (after
    `load()`)."""
    return dict(_info)


def check_aligned(what: str, **tables) -> None:
    """Raise ValueError unless every table is contiguous float32 starting on
    a 16-byte boundary: the kernels read them with 128-bit loads (float4
    __ldg), which fault on a misaligned address.  A fresh allocation is
    aligned; a view at an odd offset need not be."""
    for name, x in tables.items():
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{what}: {name}: want contiguous float32, got {x.dtype}")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (128-bit loads), got "
                             f"address {x.data_ptr():#x}")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
