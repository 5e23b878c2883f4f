"""PyTorch port: scene loading.  The port's loader produces exactly the
tables of the JAX loader (triangle permutation and Woop table included),
scene_from_arrays carries a JAX scene across unchanged, RenderConfig has
the same fields and defaults, and the package runs without JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpuspectral_tpu.scene import load_mitsuba_scene as jax_load
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.scene import data as tdata
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import (build_sphere_field, build_zoo,
                                             populate_sphere_field, populate_zoo)
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import CORNELL_XML, REPO, jax_scene_arrays


@pytest.fixture(scope="module")
def scenes():
    return {
        "cornell": (jax_load(str(CORNELL_XML))[0], load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]),
        "zoo": (populate_zoo(JaxBuilder()).build(), build_zoo("cpu")),
    }


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_loader_tables_equal_jax(scenes, name):
    js, ts = scenes[name]
    arrays, meta = jax_scene_arrays(js)
    got, got_meta = tdata.scene_to_arrays(ts)
    assert set(got) == set(arrays)
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype, k
        assert got[k].shape == arrays[k].shape, k
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    for k in tdata.META_FIELDS:
        assert got_meta[k] == meta[k], k


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_scene_from_arrays_round_trip(scenes, name):
    js, ts = scenes[name]
    arrays, meta = jax_scene_arrays(js)
    carried = tdata.scene_from_arrays(arrays, meta, "cpu")
    a2, m2 = tdata.scene_to_arrays(carried)
    for k in arrays:
        np.testing.assert_array_equal(a2[k], arrays[k], err_msg=k)
    assert m2 == {k: meta[k] for k in tdata.META_FIELDS}
    # and the port's own tables survive the trip unchanged
    a3, m3 = tdata.scene_to_arrays(tdata.scene_from_arrays(*tdata.scene_to_arrays(ts), "cpu"))
    for k in a3:
        np.testing.assert_array_equal(a3[k], a2[k], err_msg=k)


def test_zoo_has_every_kind(scenes):
    assert scenes["zoo"][1].kinds_present == tuple(range(8))


def test_render_config_fields_and_defaults_equal():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert jf == tf
    assert RenderConfig(spp=3).replace(width=7) == RenderConfig(spp=3, width=7)


def test_scenes_outside_the_slice_raise(tmp_path):
    # environment emitters, scenes above MEGA_MAX_TRIS and textures all load
    # now; what stays outside the port raises where it is asked for
    from gpuspectral_tpu_torch.integrator import mega_bvh

    xml = tmp_path / "env.xml"
    xml.write_text('<scene version="0.5.0"><emitter type="constant">'
                   '<rgb name="radiance" value="1, 1, 1"/></emitter></scene>')
    scene, _ = load_mitsuba_scene(str(xml), device="cpu")
    assert scene.has_envmap and scene.num_tris == 0
    b = tdata.SceneBuilder()
    pos = np.random.default_rng(0).normal(size=(tdata.MEGA_MAX_TRIS + 1, 3, 3)).astype(np.float32)
    b.add_object(pos, pos, None, np.eye(4, dtype=np.float32), b.add_bsdf((0, np.zeros(12, np.float32))))
    big = b.build("cpu")
    assert big.num_tris == tdata.MEGA_MAX_TRIS + 1 and big.bvh_bins > 1
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1, use_bvh=True, debug_rounds_cap=2)
    pix = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="debug_rounds_cap"):
        mega_bvh.render_mega_bvh_rows(big, cfg, pix)


def test_package_runs_without_jax():
    code = (
        "import sys, torch\n"
        "from gpuspectral_tpu_torch.scene import load_mitsuba_scene\n"
        "from gpuspectral_tpu_torch.integrator import render_image_stats_auto\n"
        "from gpuspectral_tpu_torch.integrator import envmap, mega_bvh\n"
        "from gpuspectral_tpu_torch.bvh import ftb\n"
        "from gpuspectral_tpu_torch.scene import texture\n"
        "from gpuspectral_tpu_torch.scene.zoo import build_sphere_field\n"
        "from gpuspectral_tpu_torch.utils import RenderConfig\n"
        f"scene, _ = load_mitsuba_scene({str(CORNELL_XML)!r}, device='cpu')\n"
        "img, rays = render_image_stats_auto(scene, RenderConfig(width=8, height=8, spp=2, max_depth=3))\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all()) and rays > 0\n"
        "sf = build_sphere_field('cpu', n_side=2, segs=8, rings=4, sky_hw=(4, 8))\n"
        "assert sf.has_textures and sf.has_envmap and sf.bvh_dfs_bounds.shape[1] > 0\n"
        "cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, use_bvh=True)\n"
        "img, rays = mega_bvh.render_mega_bvh(sf, cfg)\n"
        "assert bool(torch.isfinite(img).all()) and rays > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_scene_tensors_follow_the_device_argument():
    s = load_mitsuba_scene(str(CORNELL_XML), device=torch.device("cpu"))[0]
    assert s.device.type == "cpu"
    assert s.tri_woop_t.shape == (12, s.padded_tris) and s.tri_woop_t.is_contiguous()


_SMALL_FIELD = dict(n_side=2, segs=8, rings=4, sky_hw=(4, 8))


def _small_builder():
    return populate_sphere_field(tdata.SceneBuilder(), **_SMALL_FIELD)


# the six scene constructors, each with its own arguments but `device`
SCENE_CONSTRUCTORS = {
    "SceneBuilder.build": lambda **kw: _small_builder().build(**kw),
    "build_scene": lambda **kw: tdata.build_scene(_small_builder(), **kw),
    "scene_from_arrays": lambda **kw: tdata.scene_from_arrays(
        *tdata.build_arrays(_small_builder()), **kw),
    "load_mitsuba_scene": lambda **kw: load_mitsuba_scene(str(CORNELL_XML), **kw)[0],
    "build_zoo": lambda **kw: build_zoo(**kw),
    "build_sphere_field": lambda **kw: build_sphere_field(**_SMALL_FIELD, **kw),
}


@pytest.mark.parametrize("name", sorted(SCENE_CONSTRUCTORS))
def test_scene_constructors_default_to_the_card(name):
    """Scenes live on the card unless the caller asks for the CPU: without a
    CUDA device the default raises (naming device="cpu") rather than quietly
    build a CPU scene, and device="cpu" builds one on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no CUDA device")
    make = SCENE_CONSTRUCTORS[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make(device="cuda")
    assert make(device="cpu").device.type == "cpu"
