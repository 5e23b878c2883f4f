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


def _k1_scenes():
    """Every kind of scene the port's tests build, by name: the loaders',
    the zoo's, tests/torch_common.py's and chip_smoke.py's soups."""
    from chip_smoke import soup_scene
    from torch_common import env_box, mixed_bsdf_scene, sky, textured_diffuse_scene, textured_floor

    grad = np.broadcast_to(np.linspace(0, 1, tdata.TEX_RES, dtype=np.float32)[None, :, None],
                           (tdata.TEX_RES, tdata.TEX_RES, 3)).copy()
    return dict(
        cornell=load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0], zoo=build_zoo("cpu"),
        sphere_field_small=build_sphere_field("cpu", n_side=2, segs=16, rings=8),
        env_const=env_box(tdata.SceneBuilder(), True).build("cpu"),
        env_image=env_box(tdata.SceneBuilder(), True, sky(32, 64)).build("cpu"),
        textured=textured_floor(tdata.SceneBuilder(), grad).build("cpu"),
        mixed=mixed_bsdf_scene(tdata.SceneBuilder())[0].build("cpu"),
        textured_diffuse=textured_diffuse_scene(tdata.SceneBuilder()).build("cpu"),
        soup=soup_scene(2048, 7, "cpu"), soup_morton=soup_scene(2048, 8, "cpu", order="morton"),
        soup_ties=soup_scene(1024, 9, "cpu", ties=True),
        soup_light=soup_scene(300, 5, "cpu", light=True))


def test_tri_rows_counts_the_rows_that_hold_triangles(scenes):
    """K2 tests the first tri_rows slots: 1 + the last slot of a triangle,
    every row from it on zero.  Cornell 36 and the zoo 90, of 128 slots;
    JAX's tables carried across give the same count."""
    for name, rows in (("cornell", 36), ("zoo", 90)):
        js, ts = scenes[name]
        woop = ts.tri_woop.numpy()
        assert ts.tri_rows == rows == ts.num_tris and woop.shape[0] == 128, name
        assert woop[:rows].any(1).all() and not woop[rows:].any(), name
        carried = tdata.scene_from_arrays(*jax_scene_arrays(js), "cpu")
        assert carried.tri_rows == rows, name
        assert tdata.scene_from_arrays(*tdata.scene_to_arrays(ts), "cpu").tri_rows == rows


def test_tri_rows_on_the_sphere_field():
    """The sphere field's slots hold zero rows between its clusters, so only
    the trailing ones are cut."""
    f = build_sphere_field("cpu")
    woop = f.tri_woop.numpy()
    assert f.tri_woop.shape[0] == 262144 and f.num_tris < f.tri_rows <= 262144
    assert woop[f.tri_rows - 1].any() and not woop[f.tri_rows:].any()
    assert not woop[:f.tri_rows].any(1).all()  # zero rows inside the count


def test_tri_rows_equals_num_tris_on_every_k1_scene():
    """On every scene the tests build that K1 takes (mega_eligible), the
    count is num_tris: K1's own cut, mega.woop_rows = tri_woop[:num_tris],
    drops no triangle."""
    from gpuspectral_tpu_torch.integrator import mega

    eligible = []
    for name, ts in _k1_scenes().items():
        if mega.mega_eligible(ts, RenderConfig()):
            eligible.append(name)
            assert ts.tri_rows == ts.num_tris, name
    assert {"cornell", "zoo", "soup", "soup_ties"} <= set(eligible)


def test_scene_from_arrays_raises_on_a_triangle_past_tri_rows(scenes):
    """The count is read off the Woop table (last_tri_row), so it covers
    the last non-zero row wherever that lies; on the zoo a triangle past its
    90 rows sits in an empty cluster, which scene_from_arrays refuses."""
    from gpuspectral_tpu_torch.bvh.tables import last_tri_row

    arrays, meta = tdata.build_arrays(populate_zoo(tdata.SceneBuilder()))
    assert "tri_rows" not in meta
    assert tdata.scene_from_arrays(arrays, meta, "cpu").tri_rows == 90
    row = arrays["tri_woop"][0]
    assert last_tri_row(np.zeros_like(arrays["tri_woop"])) == 0
    for slot in (0, 1, 89, 90, 100, 127):
        woop = arrays["tri_woop"].copy()
        woop[slot + 1:] = 0
        woop[slot] = row
        assert last_tri_row(woop) == slot + 1, slot
    woop = arrays["tri_woop"].copy()
    woop[100] = row
    with pytest.raises(ValueError, match="empty cluster"):
        tdata.scene_from_arrays(dict(arrays, tri_woop=woop), meta, "cpu")
