"""PyTorch port: K4's launch tables, packed once a scene
(integrator/mega_bvh.launch_tables).

On the CPU, on a small sphere field (textures, a sky and two area lights of
unequal power, so the uniform and power pick columns differ): the held
tables equal, bit for bit, a fresh pack_attr / _pack_tables / pack_env /
walk_tables in both light modes; a second call hands back the same tensors
and counts a reuse; scene.replace(...) and an in-place edit of a source
tensor get a new pack; a source that requires grad, or was made under
inference mode, is packed anew on every call and nothing is held; the held tables die with their scene.  K4 on the
card served from these tables: tests/test_torch_cuda.py.

This file imports neither JAX nor the JAX package.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from gpuspectral_tpu_torch.bsdf import table as bt
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.integrator import mega, mega_bvh
from gpuspectral_tpu_torch.scene import SceneBuilder
from gpuspectral_tpu_torch.scene.data import CameraData
from gpuspectral_tpu_torch.scene.obj import make_rectangle
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field
from gpuspectral_tpu_torch.utils import profiling

import torch_common  # noqa: F401  (one torch thread a test worker)

PACKED, REUSED = "mega_bvh.tables.packed", "mega_bvh.tables.reused"


@pytest.fixture(scope="module")
def scene():
    b = populate_sphere_field(SceneBuilder(), n_side=2, segs=8, rings=4)
    pos, nrm, uv = make_rectangle()
    xf = np.array([[0.3, 0, 0, 1.0], [0, 0, -1, 2.5], [0, 0.3, 0, 0.5], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, xf, b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0))),
                 emission=(3.0, 2.0, 1.0))
    return b.build(device="cpu")


def _copy(scene):
    """A scene object of its own whose bsdf_params and camera can be edited
    in place without touching `scene`."""
    cam = scene.camera
    return scene.replace(bsdf_params=scene.bsdf_params.clone(),
                         camera=CameraData(cam.to_world.clone(), cam.fov.clone()))


def _bits(x):
    """x's bit patterns: the pair rows hold NaN boxes, which torch.equal
    would call unequal to themselves."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_fresh(tab, scene, mode):
    _, attr, light, camv = mega._pack_tables(scene)
    pairs, woop, walk_ip = ftb.walk_tables(scene)
    want = dict(pairs=pairs, woop=woop, walk_ip=walk_ip, attr=mega_bvh.pack_attr(scene, mode),
                light=light, camv=camv, env=mega.pack_env(scene),
                light_cdf=scene.light_cdf, light_prob=scene.light_prob)
    for name, x in want.items():
        got = getattr(tab, name)
        assert got.dtype == x.dtype and torch.equal(_bits(got), _bits(x)), name
        assert got.is_contiguous(), name
    assert torch.equal(tab.attr[:, :31], attr[:, :31])


@pytest.mark.parametrize("mode", ["uniform", "power"])
def test_held_tables_equal_a_fresh_pack(scene, mode):
    s = scene.replace()
    tab = mega_bvh.launch_tables(s, mode)
    _assert_fresh(tab, s, mode)
    assert tab.attr.shape == (s.padded_tris, 41) and s.has_textures and s.has_envmap
    assert mega_bvh.launch_tables(s, mode) is tab
    _assert_fresh(tab, s, mode)


def test_the_light_mode_is_part_of_the_key(scene):
    """Two emitters of unequal power: the pick columns differ, and each mode
    holds its own set."""
    s = scene.replace()
    uni, pow_ = (mega_bvh.launch_tables(s, m) for m in ("uniform", "power"))
    lit = s.tri_light_idx >= 0
    assert s.num_lights > 2 and bool(lit.any())
    assert not torch.equal(uni.attr[lit, 31], pow_.attr[lit, 31])
    assert torch.equal(pow_.attr[lit, 31], s.light_prob[s.tri_light_idx[lit].long()])
    assert mega_bvh.launch_tables(s, "uniform") is uni
    assert mega_bvh.launch_tables(s, "power") is pow_


def test_second_call_is_a_reuse(scene):
    s = scene.replace()
    profiling.reset()
    first = mega_bvh.launch_tables(s, "uniform")
    assert profiling.calls(PACKED) == 1 and profiling.calls(REUSED) == 0
    second = mega_bvh.launch_tables(s, "uniform")
    assert profiling.calls(PACKED) == 1 and profiling.calls(REUSED) == 1
    assert all(a is b for a, b in zip(first, second))


def test_replace_gets_a_new_pack(scene):
    s = scene.replace()
    old = mega_bvh.launch_tables(s, "power")
    s2 = s.replace(bsdf_params=s.bsdf_params * 0.5 + 0.125)
    profiling.reset()
    new = mega_bvh.launch_tables(s2, "power")
    assert profiling.calls(PACKED) == 1 and profiling.calls(REUSED) == 0
    assert new.attr is not old.attr and not torch.equal(new.attr, old.attr)
    _assert_fresh(new, s2, "power")
    assert mega_bvh.launch_tables(s, "power") is old


@pytest.mark.parametrize("edit", ["bsdf_params", "to_world"])
def test_in_place_edit_gets_a_new_pack(scene, edit):
    s = _copy(scene)
    old = mega_bvh.launch_tables(s, "uniform")
    if edit == "bsdf_params":
        s.bsdf_params.mul_(0.5)
    else:
        s.camera.to_world[0, 3] += 1.0
    profiling.reset()
    new = mega_bvh.launch_tables(s, "uniform")
    assert profiling.calls(PACKED) == 1 and profiling.calls(REUSED) == 0
    assert not torch.equal(new.attr if edit == "bsdf_params" else new.camv,
                           old.attr if edit == "bsdf_params" else old.camv)
    _assert_fresh(new, s, "uniform")
    assert mega_bvh.launch_tables(s, "uniform") is new


def test_requires_grad_bypasses_the_cache(scene):
    s = scene.replace(bsdf_params=scene.bsdf_params.clone().requires_grad_())
    profiling.reset()
    tab = mega_bvh.launch_tables(s, "uniform")
    assert tab.attr.requires_grad
    with torch.no_grad():
        _assert_fresh(tab, s, "uniform")
    dead = weakref.ref(tab.attr)
    again = mega_bvh.launch_tables(s, "uniform")
    assert again.attr is not tab.attr
    del tab
    gc.collect()
    assert dead() is None  # nothing held the first set
    assert profiling.calls(PACKED) == 2 and profiling.calls(REUSED) == 0


def test_inference_tensors_bypass_the_cache(scene):
    """A source made under torch.inference_mode has no version counter: its
    scene is packed anew on every call and nothing is held."""
    with torch.inference_mode():
        params = scene.bsdf_params.clone()
    s = scene.replace(bsdf_params=params)
    profiling.reset()
    tab = mega_bvh.launch_tables(s, "power")
    _assert_fresh(tab, s, "power")
    assert mega_bvh.launch_tables(s, "power").attr is not tab.attr
    assert profiling.calls(PACKED) == 2 and profiling.calls(REUSED) == 0
    assert "power" not in vars(s)["_k4_tables"]


def test_a_held_set_is_dropped_once_a_source_requires_grad(scene):
    s = _copy(scene)
    dead = weakref.ref(mega_bvh.launch_tables(s, "uniform").attr)
    s.bsdf_params.requires_grad_()
    assert mega_bvh.launch_tables(s, "uniform").attr.requires_grad
    gc.collect()
    assert dead() is None


def test_held_tables_die_with_their_scene(scene):
    s = scene.replace()
    tab = mega_bvh.launch_tables(s, "power")
    dead = [weakref.ref(tab.attr), weakref.ref(tab.env), weakref.ref(tab.camv)]
    del tab, s
    gc.collect()
    assert all(d() is None for d in dead)
