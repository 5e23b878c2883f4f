"""PyTorch port: it imports nothing of JAX or of the JAX package, and its
copies of the JAX package's numpy-only modules (bvh/build.py, bvh/sah.py,
io/image.py, io/exr.py, io/checkpoint.py, the native-library loader) give
the JAX modules' results bit for bit."""

import ast
import pathlib

import numpy as np
import pytest

from gpuspectral_tpu.bvh import build as jbuild
from gpuspectral_tpu.bvh import sah as jsah
from gpuspectral_tpu.io import checkpoint as jckpt
from gpuspectral_tpu.io import exr as jexr
from gpuspectral_tpu.io import image as jimage
from gpuspectral_tpu_torch import _native
from gpuspectral_tpu_torch.bvh import build as tbuild
from gpuspectral_tpu_torch.bvh import sah as tsah
from gpuspectral_tpu_torch.io import checkpoint as tckpt
from gpuspectral_tpu_torch.io import exr as texr
from gpuspectral_tpu_torch.io import image as timage

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "gpuspectral_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "gpuspectral_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, 3, (n, 1, 3)) + rng.normal(scale=0.2, size=(n, 3, 3))).astype(np.float32)


def _fields(tree):
    return {k: v for k, v in vars(tree).items()}


@pytest.mark.parametrize("n,threshold,bin_target", [
    (300, 2048, 128), (3000, 2048, 128), (3000, 2048, 512), (700, 8, 128)],
    ids=["dense300", "slot3000", "slot3000_b512", "slot_lowered"])
def test_bvh_build_equal(n, threshold, bin_target, monkeypatch):
    monkeypatch.setattr(jbuild, "SLOT_DENSE_THRESHOLD", threshold)
    monkeypatch.setattr(tbuild, "SLOT_DENSE_THRESHOLD", threshold)
    pos = _soup(n, n)
    padded = -(-n // 128) * 128
    pos = np.concatenate([pos, np.zeros((padded - n, 3, 3), np.float32)])
    a = _fields(jbuild.build_bvh(pos, n, bin_target=bin_target))
    b = _fields(tbuild.build_bvh(pos, n, bin_target=bin_target))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_sah_orders_equal():
    pos = _soup(1500, 3)
    np.testing.assert_array_equal(jsah.sah_dfs_order(pos, 1500), tsah.sah_dfs_order(pos, 1500))
    ja, tb = jsah.sah_cuts(pos, 1500), tsah.sah_cuts(pos, 1500)
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _img(seed=0, h=5, w=7):
    return np.random.default_rng(seed).uniform(0, 4, (h, w, 3)).astype(np.float32)


def test_pfm_png_exr_bytes_equal(tmp_path):
    img = _img()
    for ext, jw, tw in (("pfm", jimage.write_pfm, timage.write_pfm),
                        ("exr", jimage.write_exr, timage.write_exr),
                        ("png", lambda p, x: jimage.write_png(p, x, tonemap=True),
                         lambda p, x: timage.write_png(p, x, tonemap=True))):
        pj, pt = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
        jw(str(pj), img)
        tw(str(pt), img)
        assert pj.read_bytes() == pt.read_bytes(), ext
    np.testing.assert_array_equal(timage.read_pfm(str(tmp_path / "j.pfm")),
                                  jimage.read_pfm(str(tmp_path / "t.pfm")))
    for compress in (True, False):
        p = tmp_path / f"c{int(compress)}.exr"
        jimage.write_exr(str(p), img, compress=compress)
        np.testing.assert_array_equal(texr.read_exr(str(p)), jexr.read_exr(str(p)))


def test_checkpoint_round_trip(tmp_path):
    state = dict(params=_img(1), light_emission=_img(2)[0], step=np.int64(7),
                 loss=np.float64(0.25))
    tckpt.save_checkpoint(str(tmp_path / "ckpt_000007.npz"), state)
    jckpt.save_checkpoint(str(tmp_path / "j" / "ckpt_000007.npz"), state)
    a = jckpt.load_checkpoint(str(tmp_path / "ckpt_000007.npz"))
    b = tckpt.load_checkpoint(str(tmp_path / "j" / "ckpt_000007.npz"))
    for k, v in state.items():
        np.testing.assert_array_equal(a[k], v)
        np.testing.assert_array_equal(b[k], v)
    tckpt.save_checkpoint(str(tmp_path / "ckpt_000012.npz"), state)
    assert tckpt.latest_checkpoint(str(tmp_path)) == jckpt.latest_checkpoint(str(tmp_path))


def test_native_obj_parser_equal(tmp_path, monkeypatch):
    """The port builds native/*.cpp itself (into its own build directory)
    and parses an OBJ as the JAX package's loader does."""
    from gpuspectral_tpu.scene import obj as jobj
    from gpuspectral_tpu_torch.scene import obj as tobj

    monkeypatch.setenv("GST_NATIVE_BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    if _native.get_lib() is None:
        pytest.skip("no C++ compiler to build native/*.cpp")
    assert (tmp_path / "native" / "libgsnative.so").exists()
    p = tmp_path / "m.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\n"
                 "f 1/1/1 2/2/1 3/3/1 4/1/1\nf -1 -2 -3\n")
    got = tobj._load_obj_native(str(p))
    ref = jobj.load_obj(str(p), cache=False)
    assert got is not None
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)


def test_isolation_walks_the_new_modules():
    """The walk above covers the traversal, the Moller-Trumbore scans and
    the dfs sweep as it covers every module of the port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"gpuspectral_tpu_torch/ops/intersect.py", "gpuspectral_tpu_torch/bvh/traverse.py",
            "gpuspectral_tpu_torch/bvh/dfs_sweep.py", "chip_smoke.py"} <= names
