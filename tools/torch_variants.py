"""What the port's kernel-variant tools share (tools/torch_cluster_variants.py,
torch_binned_variants.py, torch_dfs_variants.py, torch_mega_bvh_variants.py,
torch_mega_variants.py, torch_traverse_variants.py, torch_dfs_block.py):
chip_smoke.py loaded from this checkout, the card's name and power limit,
copies of csrc/ sources with their constants set per variant, built with the
flags of gpuspectral_tpu_torch/_build.py and loaded with ctypes, and the
checks and timings of a set of calls on each build in turns.

Import it from a tool under tools/ (run as `python3 tools/<tool>.py`, so this
directory is on sys.path).  The port itself comes from PYTHONPATH.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib.util
import pathlib
import re
import subprocess

import torch

TOOL_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", TOOL_ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)  # its imports of the port are lazy: PYTHONPATH's


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def checksum(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def results(work) -> dict:
    """{name: the outputs of work[name]() as a list}."""
    out = {}
    for name, fn in work.items():
        got = fn()
        out[name] = [got] if isinstance(got, torch.Tensor) else list(got)
    torch.cuda.synchronize()
    return out


def same(got, want) -> bool:
    return len(got) == len(want) and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b for a, b in zip(got, want))


def variant_sources(sources, consts: dict) -> dict:
    """{file name: text} of csrc/`sources`, each `constexpr <type> <name> =
    ...;` that a file declares set to consts[name].  Raises if a file
    declares a constant twice or no file declares one."""
    from gpuspectral_tpu_torch import _build

    files, found = {}, set()
    for src in sources:
        text = (_build._CSRC / src).read_text()
        for name, value in consts.items():
            text, n = re.subn(rf"constexpr (\w+) {name} = [^;]+;",
                              rf"constexpr \g<1> {name} = {value};", text)
            if n > 1:
                raise RuntimeError(f"csrc/{src} declares {name} {n} times")
            found |= {name} if n else set()
        files[src] = text
    if found != set(consts):
        raise RuntimeError(f"no source of {sources} declares {set(consts) - found}")
    return files


def build(subdir: str, variants: dict, entry_points, show=lambda kern: True) -> dict:
    """{variant: the loaded library}.  `variants` maps a name to {file name:
    text} (variant_sources); the files go to build/<subdir>/<name>/ and
    their .cu files are compiled into one library there, the variant's
    directory ahead of csrc/ on the include path.  Every nvcc is started
    before the first is waited for; ptxas's line of each kernel that `show`
    accepts is printed."""
    from gpuspectral_tpu_torch import _build

    procs = {}
    for name, files in variants.items():
        out = TOOL_ROOT / "build" / subdir / name
        out.mkdir(parents=True, exist_ok=True)
        for file, text in files.items():
            (out / file).write_text(text)
        procs[name] = (out / "libvariant.so", subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-I", str(out), "-I", str(_build._CSRC),
             *[str(out / f) for f in files if f.endswith(".cu")], "-o", str(out / "libvariant.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        for kern, line in _build._ptxas_summary(log).items():
            if show(kern):
                print(f"ptxas {name} {kern}: {line}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn in entry_points:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def launching(lib):
    """While on, the port's wrappers launch `lib` (None: the tree's own
    build)."""
    from gpuspectral_tpu_torch import _build

    real = _build.load
    _build.load = real if lib is None else (lambda: lib)
    try:
        yield
    finally:
        _build.load = real


def check_builds(libs: dict, work: dict, ref: dict) -> None:
    """Raise unless every build's outputs of `work` equal `ref`'s."""
    for name, lib in libs.items():
        with launching(lib):
            got = results(work)
        for key, want in ref.items():
            if not same(got[key], want):
                raise AssertionError(f"{name}: {key} differs from the tree's kernels")


def time_in_turns(builds: dict, work: dict, reps, timer=None) -> dict:
    """{build: {call: [ms, ms]}}: each build's calls timed with CUDA events
    (`timer`, chip_smoke.cuda_ms unless given; `reps` a count or {call:
    count}), the builds in order and again in reverse order."""
    timer = timer or chip_smoke.cuda_ms
    times = {name: {key: [] for key in work} for name in builds}
    order = list(builds)
    for name in order + order[::-1]:
        with launching(builds[name]):
            for key, fn in work.items():
                n = reps[key] if isinstance(reps, dict) else reps
                times[name][key].append(timer(fn, reps=n))
    return times
