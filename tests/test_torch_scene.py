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
from gpuspectral_tpu_torch.scene.zoo import build_zoo, populate_zoo
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import CORNELL_XML, REPO, jax_scene_arrays


@pytest.fixture(scope="module")
def scenes():
    return {
        "cornell": (jax_load(str(CORNELL_XML))[0], load_mitsuba_scene(str(CORNELL_XML))[0]),
        "zoo": (populate_zoo(JaxBuilder()).build(), build_zoo()),
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
    a3, m3 = tdata.scene_to_arrays(tdata.scene_from_arrays(*tdata.scene_to_arrays(ts)))
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
    xml = tmp_path / "env.xml"
    xml.write_text('<scene version="0.5.0"><emitter type="constant">'
                   '<rgb name="radiance" value="1, 1, 1"/></emitter></scene>')
    with pytest.raises(NotImplementedError, match="slice B"):
        load_mitsuba_scene(str(xml))
    b = tdata.SceneBuilder()
    pos = np.random.default_rng(0).normal(size=(tdata.MEGA_MAX_TRIS + 1, 3, 3)).astype(np.float32)
    b.add_object(pos, pos, None, np.eye(4, dtype=np.float32), b.add_bsdf((0, np.zeros(12, np.float32))))
    with pytest.raises(NotImplementedError, match="BVH"):
        b.build()
    arrays, meta = tdata.scene_to_arrays(build_zoo())
    with pytest.raises(NotImplementedError, match="textured"):
        tdata.scene_from_arrays(arrays, dict(meta, has_textures=True))


def test_package_runs_without_jax():
    code = (
        "import sys, torch\n"
        "from gpuspectral_tpu_torch.scene import load_mitsuba_scene\n"
        "from gpuspectral_tpu_torch.integrator import render_image_stats_auto\n"
        "from gpuspectral_tpu_torch.utils import RenderConfig\n"
        f"scene, _ = load_mitsuba_scene({str(CORNELL_XML)!r}, device='cpu')\n"
        "img, rays = render_image_stats_auto(scene, RenderConfig(width=8, height=8, spp=2, max_depth=3))\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all()) and rays > 0\n"
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
