"""PyTorch port: BVH scene tables and the plain K3 (bvh/ftb.py).

The port's build equals the JAX package's bit for bit (prim order, bins,
preorder tables, texture atlas, environment tables) on Cornell, random
soups, a slot-mode build and the small sphere field; the plain K3 is held
to JAX ftb_closest / ftb_any (interpret mode) under the gates of
tests/test_ftb.py and to the JAX brute-force scan; the CLI renders a
BVH-scale scene with its defaults (use_bvh, sort_rays, light_block=256).
The CUDA kernels K3a / K3b against the plain version: tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.bvh import build as bvh_build
from gpuspectral_tpu.bvh.ftb import ftb_any as jax_ftb_any
from gpuspectral_tpu.bvh.ftb import ftb_closest as jax_ftb_closest
from gpuspectral_tpu.ops.intersect import intersect_any, intersect_closest
from gpuspectral_tpu.scene import load_mitsuba_scene as jax_load
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu_torch.bvh import build as port_bvh_build
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.scene import data as tdata
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field

from test_binned import _random_rays, _random_scene
from torch_common import CORNELL_XML, jax_scene_arrays

SMALL_FIELD = dict(n_side=2, segs=16, rings=8, sky_hw=(8, 16))


def _soup_builder(builder, n_tris, seed=0, spread=2.0, size=0.4):
    """tests/test_binned.py:_random_scene's soup, into any SceneBuilder."""
    from gpuspectral_tpu_torch.bsdf.table import diffuse

    rng = np.random.RandomState(seed)
    base = rng.uniform(-spread, spread, (n_tris, 1, 3))
    tris = (base + rng.uniform(-size, size, (n_tris, 3, 3))).astype(np.float32)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    nrm = np.repeat(nrm[:, None, :], 3, axis=1).astype(np.float32)
    builder.add_object(tris, nrm, None, np.eye(4, dtype=np.float32),
                       builder.add_bsdf(diffuse((0.5, 0.5, 0.5))))
    builder.set_camera(np.eye(4, dtype=np.float32), 0.7)
    return builder


def _pair(name, monkeypatch=None):
    """(JAX SceneData, the port's SceneData) built from the same inputs."""
    if name == "cornell":
        return jax_load(str(CORNELL_XML))[0], load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]
    if name == "slot_mode":
        # the JAX megakernel module checks the dense threshold when first
        # imported (the JAX loader imports it): import it before lowering it
        import gpuspectral_tpu.integrator.mega  # noqa: F401

        # the port builds with its own copy of the module: lower both
        monkeypatch.setattr(bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        monkeypatch.setattr(port_bvh_build, "SLOT_DENSE_THRESHOLD", 8)
        return jax_load(str(CORNELL_XML))[0], load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0]
    if name == "sphere_field":
        return (populate_sphere_field(JaxBuilder(), **SMALL_FIELD).build(),
                populate_sphere_field(tdata.SceneBuilder(), **SMALL_FIELD).build("cpu"))
    n = int(name[len("soup"):])
    return (_random_scene(n),
            _soup_builder(tdata.SceneBuilder(), n).build("cpu"))


@pytest.mark.parametrize("name", ["cornell", "soup300", "soup3000", "slot_mode", "sphere_field"])
def test_scene_tables_equal_jax(name, monkeypatch):
    js, ts = _pair(name, monkeypatch)
    arrays, meta = jax_scene_arrays(js)
    got, got_meta = tdata.scene_to_arrays(ts)
    for k in tdata.ARRAY_FIELDS:
        assert got[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    assert got_meta == meta
    if name == "slot_mode":
        assert (np.asarray(js.tri_woop) == 0).all(axis=1).any()  # -1 slots exist
    if name == "sphere_field":
        assert ts.has_textures and ts.has_envmap and ts.envmap.shape == (8, 16, 3)


def _soup_pair(n):
    js = _random_scene(n)
    return js, tdata.scene_from_arrays(*jax_scene_arrays(js), "cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("n_tris,n_rays", [(300, 257), (3000, 1000)])
def test_plain_k3_closest_matches_jax_ftb(n_tris, n_rays):
    js, ts = _soup_pair(n_tris)
    o, d = _random_rays(n_rays)
    t_j, prim_j, u_j, v_j, attrs_j = jax_ftb_closest(js, o, d, interpret=True)
    t, prim, u, v, attrs = ftb.ftb_closest(ts, _t(o), _t(d))
    # tests/test_ftb.py:16-31 gates
    hit_j = np.asarray(prim_j) >= 0
    hit = prim.numpy() >= 0
    np.testing.assert_array_equal(hit, hit_j)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_j)[hit], rtol=1e-5, atol=1e-6)
    same = prim.numpy()[hit] == np.asarray(prim_j)[hit]
    assert same.mean() > 0.99, same.mean()
    np.testing.assert_allclose(u.numpy()[hit][same], np.asarray(u_j)[hit][same],
                               rtol=2e-4, atol=2e-5)
    # attrs: the same rows as the JAX fused gather (geometric normal and
    # area within a float rounding of XLA's fused arithmetic)
    np.testing.assert_allclose(attrs.numpy()[hit][same], np.asarray(attrs_j)[hit][same],
                               rtol=1e-6, atol=1e-6)
    # and the JAX brute-force scan: the same fused Woop arithmetic
    t_b, prim_b, u_b, v_b = intersect_closest(o, d, js.tri_pos, woop=js.tri_woop)
    assert int((prim.numpy() != np.asarray(prim_b)).sum()) <= 1
    np.testing.assert_array_equal(t.numpy()[hit], np.asarray(t_b)[hit])


def test_plain_k3_respects_active_and_tmax():
    js, ts = _soup_pair(500)
    o, d = _random_rays(400)
    active = torch.arange(400) % 3 != 0
    t, prim, u, v, attrs = ftb.ftb_closest(ts, _t(o), _t(d), active=active)
    assert (prim[~active] == -1).all() and (t[~active] == 1e30).all()
    assert (attrs[~active] == 0).all() and (u[~active] == 0).all()
    t2, prim2, _, _, _ = ftb.ftb_closest(ts, _t(o), _t(d), t_max=torch.full((400,), 2.0))
    h2 = prim2 >= 0
    assert (t2[h2] < 2.0).all()
    keep = (prim >= 0) & (t < 2.0 - 1e-5) & active
    assert h2[keep].all()
    # the JAX kernel on the same active / t_max
    t_j, prim_j, _, _, _ = jax_ftb_closest(js, o, d, active=jnp.asarray(active.numpy()),
                                           interpret=True)
    np.testing.assert_array_equal(prim.numpy() >= 0, np.asarray(prim_j) >= 0)


def test_walk_tests_need_the_card():
    """ftb_walk_tests counts the work of the kernels' walk: there is no walk
    on the CPU (the plain versions scan every slot), so it refuses."""
    _, ts = _soup_pair(50)
    o, d = _random_rays(8)
    with pytest.raises(ValueError, match="CUDA"):
        ftb.ftb_walk_tests(ts, _t(o), _t(d), torch.zeros(8), torch.full((8,), 1e30), False)


@pytest.mark.parametrize("n_tris", [300, 3000])
def test_plain_k3_any_matches_jax_ftb(n_tris):
    js, ts = _soup_pair(n_tris)
    o, d = _random_rays(800, seed=3)
    t_max = np.full((800,), 4.0, np.float32)
    occ_j = jax_ftb_any(js, o, d, t_min=1e-3, t_max=jnp.asarray(t_max), interpret=True)
    occ_b = intersect_any(o, d, js.tri_pos, t_min=1e-3, t_max=jnp.asarray(t_max),
                          woop=js.tri_woop)
    occ = ftb.ftb_any(ts, _t(o), _t(d), 1e-3, _t(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_b))
    active = torch.arange(800) % 2 == 0
    occ_a = ftb.ftb_any(ts, _t(o), _t(d), 1e-3, _t(t_max), active=active)
    assert not occ_a[~active].any() and torch.equal(occ_a[active], occ[active])


def test_unpack_meta_round_trip():
    js, ts = _pair("sphere_field")
    attr = ftb.attr_table(ts)
    assert attr.shape == (ts.padded_tris, 20)
    bsdf, light, twofaced = ftb.unpack_meta(attr[:, 13])
    np.testing.assert_array_equal(bsdf.numpy(), ts.tri_bsdf.numpy())
    np.testing.assert_array_equal(light.numpy(), ts.tri_light_idx.numpy())
    np.testing.assert_array_equal(twofaced.numpy(), ts.tri_twofaced.numpy())
    # bsdf row 0 with an even light index: a meta that is an exact multiple
    # of 4096, which round-half-to-even would misread
    bsdf, light, twofaced = ftb.unpack_meta(torch.tensor([4096.0, 3 * 4096.0, 2.0**23 + 5 * 4096 + 7]))
    assert bsdf.tolist() == [0, 0, 7] and light.tolist() == [0, 2, 4]
    assert twofaced.tolist() == [False, False, True]


def test_cli_render_bvh_scene_with_defaults(tmp_path, monkeypatch):
    """`render` on a scene above MEGA_MAX_TRIS with the CLI's defaults
    (use_bvh, sort_rays, light_block=256): textured floor, constant
    environment, area light, two 4k-triangle spheres, on the CPU."""
    from gpuspectral_tpu_torch.cli import main as cli
    from gpuspectral_tpu_torch.integrator import path_tracer

    xml = tmp_path / "field.xml"
    xml.write_text("""<scene version="0.5.0">
  <sensor type="perspective"><float name="fov" value="45"/>
    <transform name="to_world"><lookat origin="0, 2, 6" target="0, 0, 0" up="0, 1, 0"/></transform>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="0.3, 0.4, 0.5"/></emitter>
  <shape type="sphere"><point name="center" x="-1" y="0.5" z="0"/><float name="radius" value="0.5"/>
    <bsdf type="roughconductor"/></shape>
  <shape type="sphere"><point name="center" x="1" y="0.5" z="0"/><float name="radius" value="0.5"/>
    <bsdf type="dielectric"/></shape>
  <shape type="rectangle">
    <transform name="to_world"><scale value="4"/><rotate x="1" angle="-90"/></transform>
    <bsdf type="diffuse"><texture name="reflectance" type="checkerboard"/></bsdf></shape>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="90"/><translate y="3"/></transform>
    <emitter type="area"><rgb name="radiance" value="8, 8, 8"/></emitter></shape>
</scene>""")
    seen = {}
    real = path_tracer.trace_wavefront

    def spy(scene, cfg, *a, **kw):
        seen.update(use_bvh=cfg.use_bvh, sort_rays=cfg.sort_rays, light_block=cfg.light_block,
                    tris=scene.num_tris, textured=scene.has_textures, env=scene.has_envmap)
        return real(scene, cfg, *a, **kw)

    monkeypatch.setattr(path_tracer, "trace_wavefront", spy)
    out = tmp_path / "out.pfm"
    rc = cli.main(["render", str(xml), "-o", str(out), "--size", "8x8", "--spp", "1",
                   "--depth", "2", "--device", "cpu"])
    assert rc == 0 and out.exists()
    assert seen == dict(use_bvh=True, sort_rays=True, light_block=256, tris=seen["tris"],
                        textured=True, env=True)
    assert seen["tris"] > tdata.MEGA_MAX_TRIS
    from gpuspectral_tpu.io.image import read_pfm

    img = read_pfm(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0


def test_cli_builtin_sphere_field(tmp_path, monkeypatch):
    """`builtin:sphere_field` names the in-repo BVH scene (here shrunk to
    its small instance); an unknown name is a friendly error."""
    from gpuspectral_tpu_torch.cli import main as cli
    from gpuspectral_tpu_torch.scene import zoo

    assert cli.main(["render", "builtin:nope", "--device", "cpu"]) == 2
    monkeypatch.setitem(zoo.BUILTIN, "sphere_field",
                        lambda b: populate_sphere_field(b, **SMALL_FIELD))
    out = tmp_path / "field.pfm"
    rc = cli.main(["render", "builtin:sphere_field", "-o", str(out), "--size", "8x8",
                   "--spp", "1", "--depth", "2", "--bvh", "--device", "cpu"])
    from gpuspectral_tpu.io.image import read_pfm

    img = read_pfm(str(out))
    assert rc == 0 and img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
