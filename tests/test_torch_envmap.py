"""PyTorch port: environment emitters (integrator/envmap.py, the loader's
`constant` and `envmap` emitters, the wavefront's environment branches).

The environment functions are compared with the JAX package's run op by op
(eagerly, no fusion): equal bit for bit.  The environment wavefront is held
to the JAX wavefront under the gates of tests/test_mega.py (XLA fuses
multiply-adds the port rounds separately, and sin/cos come from another
libm).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.integrator import envmap as jenv
from gpuspectral_tpu.integrator.path_tracer import render_image_stats as jax_render_stats
from gpuspectral_tpu.io.image import write_pfm
from gpuspectral_tpu.scene import load_mitsuba_scene as jax_load
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.integrator import envmap as tenv
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.scene import data as tdata
from gpuspectral_tpu_torch.scene import load_mitsuba_scene

from torch_common import assert_mega_gates, env_box, jax_scene_arrays, sky as _sky


def env_pair(with_light, envmap=None):
    js = env_box(JaxBuilder(), with_light, envmap).build()
    return js, tdata.scene_from_arrays(*jax_scene_arrays(js), "cpu")


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]  # poles and seams
    return d


def test_acos_fast_bitwise():
    x = np.concatenate([np.linspace(-1, 1, 4001), [-1.0, -0.0, 0.0, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(tenv.acos_fast(torch.as_tensor(x)).numpy(),
                                  np.asarray(jenv.acos_fast(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(1, 1), (8, 16), (32, 64)])
def test_envmap_functions_bitwise(shape):
    env = np.random.default_rng(1).uniform(0.1, 2.0, size=shape + (3,)).astype(np.float32)
    js, ts = env_pair(False, env)
    d = _dirs(2048, 2)
    got = tenv.eval_envmap(ts.envmap, ts.envmap_rot, torch.as_tensor(d)).numpy()
    want = np.asarray(jenv.eval_envmap(js.envmap, js.envmap_rot, jnp.asarray(d)))
    np.testing.assert_array_equal(got, want)
    got = tenv.envmap_pdf(ts.envmap_pdf, ts.envmap_rot, torch.as_tensor(d)).numpy()
    want = np.asarray(jenv.envmap_pdf(js.envmap_pdf, js.envmap_rot, jnp.asarray(d)))
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(3)
    u1, u2 = rng.uniform(size=(2, 2048)).astype(np.float32)
    u1[:3] = [0.0, 1.0, np.float32(np.asarray(ts.envmap_cdf)[0])]  # edges and a CDF step
    dg, pg = tenv.sample_envmap(ts.envmap, ts.envmap_rot, ts.envmap_cdf, ts.envmap_pdf,
                                torch.as_tensor(u1), torch.as_tensor(u2))
    dw, pw = jenv.sample_envmap(js.envmap, js.envmap_rot, js.envmap_cdf, js.envmap_pdf,
                                jnp.asarray(u1), jnp.asarray(u2))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(pw))
    # sin / cos of the sampled azimuth come from torch's and XLA's libm
    np.testing.assert_allclose(dg.numpy(), np.asarray(dw), rtol=0, atol=2e-6)


def test_constant_and_envmap_emitters_parse(tmp_path):
    sky = _sky()
    write_pfm(str(tmp_path / "sky.pfm"), sky)
    for body in ('<emitter type="constant"><rgb name="radiance" value="0.25 0.5 0.75"/></emitter>',
                 '<emitter type="envmap"><string name="filename" value="sky.pfm"/>'
                 '<float name="scale" value="2"/>'
                 '<transform name="to_world"><rotate y="1" angle="90"/></transform></emitter>'):
        xml = tmp_path / "scene.xml"
        xml.write_text(f'<scene version="2.0.0">{body}<sensor type="perspective">'
                       '<float name="fov" value="90"/></sensor></scene>')
        js, _ = jax_load(str(xml))
        ts, _ = load_mitsuba_scene(str(xml), device="cpu")
        assert ts.has_envmap and js.has_envmap
        for k in ("envmap", "envmap_rot", "envmap_cdf", "envmap_pdf"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), k)
    assert ts.envmap.shape == (8, 16, 3)


def _render_both(js, ts, **kw):
    base = dict(width=16, height=16, spp=2, max_depth=3, ray_batch=256)
    base.update(kw)
    ref, rays_ref = jax_render_stats(js, JaxConfig(**base), jnp.uint32(0))
    got, rays_got = pt.render_image_stats(ts, tdata_cfg(**base), 0)
    return np.asarray(ref), float(rays_ref), got.numpy(), rays_got


def tdata_cfg(**kw):
    from gpuspectral_tpu_torch.utils import RenderConfig

    return RenderConfig(**kw)


@pytest.mark.parametrize("kind,with_light,opts", [
    ("constant", False, {}),
    ("constant", True, dict(mis_mode="exact")),
    ("image", True, {}),
    ("image", False, dict(nee=False)),
    ("image", True, dict(use_bvh=True, intersector="pallas", sort_rays=True)),
], ids=["const", "const_light_exact", "image_light", "image_no_nee", "image_bvh"])
def test_environment_wavefront_matches_jax(kind, with_light, opts):
    js, ts = env_pair(with_light, _sky() if kind == "image" else None)
    ref, rays_ref, got, rays_got = _render_both(js, ts, **opts)
    assert ref.max() > 0
    assert_mega_gates(ref, got, rays_ref, rays_got)


def test_camera_rays_that_miss_see_the_environment():
    js, ts = env_pair(False)
    ref, _, got, _ = _render_both(js, ts, max_depth=0, nee=False, spp=1)
    # XLA fuses the bilinear blend's multiply-adds: an ulp of the radiance
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)
    assert np.isclose(got, np.float32([1.5, 0.8, 0.4]), rtol=1e-6, atol=0).all(-1).any()
