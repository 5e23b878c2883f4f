"""PyTorch port: the plain versions of K5 and K6 (the torch wavefront with
the fused-gradient hook, integrator/mega_grad.py) against the JAX package's
render_mega_diff / render_mega_bvh_diff in interpret mode, at the shapes of
tests/test_mega_grad.py: the image, the albedo and emission gradients with
that file's exclusions (kd = 0 rows, non-emissive triangles), and the
eligibility rules.  Each JAX reference is computed once per module.  The
CUDA kernels against these plain versions: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.integrator import mega_grad as jmg
from gpuspectral_tpu.bvh import build as jbuild
from gpuspectral_tpu.scene import load_mitsuba_scene as jax_load
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.integrator import mega, mega_grad as mg
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.utils import RenderConfig

from torch_common import (CORNELL_XML, env_box, jax_scene_arrays, launches,
                          mixed_bsdf_scene, textured_diffuse_scene)

# The same estimator and draws on both sides; gradients differ by float
# rounding and by paths that cross a seam on it.  2e-3 of the gradient's
# scale is tests/test_mega_grad.py's tolerance (measured here: ~1e-7).
GRAD_TOL = 2e-3
IMG_TOL = 1e-5
W = np.arange(3.0, dtype=np.float32)  # the asymmetric channel weighting of the JAX tests


def _kw(**kw):
    base = dict(width=24, height=24, spp=2, max_depth=3, ray_batch=576)
    base.update(kw)
    return base


def _port(js):
    return scene_from_arrays(*jax_scene_arrays(js), "cpu")


def _jax_grads(js, kw, bvh):
    def loss(bp, te, le):
        sc = js.replace(bsdf_params=bp, tri_emission=te, light_emission=le)
        f = jmg.render_mega_bvh_diff if bvh else jmg.render_mega_diff
        img = f(sc, JaxConfig(**kw), 0, interpret=True)
        return jnp.sum(img * jnp.asarray(W)), img

    (_, img), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        js.bsdf_params, js.tri_emission, js.light_emission)
    return np.asarray(img), [np.asarray(x) for x in g]


def _port_grads(ts, kw, bvh):
    p = [x.clone().requires_grad_(True)
         for x in (ts.bsdf_params, ts.tri_emission, ts.light_emission)]
    sc = ts.replace(bsdf_params=p[0], tri_emission=p[1], light_emission=p[2])
    f = mg.render_mega_bvh_diff if bvh else mg.render_mega_diff
    img = f(sc, RenderConfig(**kw), 0)
    (img * torch.as_tensor(W)).sum().backward()
    return img.detach().numpy(), [x.grad.numpy() for x in p]


CASES = {
    "k5_cornell": (False, {}),
    "k5_jitter_exact": (False, dict(jitter=True, mis_mode="exact")),
    "k6_slot_cornell": (True, dict(use_bvh=True)),
    "k6_mixed": (True, dict(use_bvh=True, max_depth=4)),
    "k6_textured": (True, dict(use_bvh=True)),
}


@pytest.fixture(scope="module")
def results(cornell_scene):
    """{case: (JAX scene, port scene, kw, JAX (img, grads), port (img, grads))}."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jbuild, "SLOT_DENSE_THRESHOLD", 8)
        import gpuspectral_tpu.integrator.mega  # noqa: F401  (checks the threshold at import)
        slot = jax_load(str(CORNELL_XML))[0]
        mixed = mixed_bsdf_scene(JaxBuilder())[0].build()
        textured = textured_diffuse_scene(JaxBuilder()).build()
    finally:
        mp.undo()
    scenes = dict(k5_cornell=cornell_scene, k5_jitter_exact=cornell_scene,
                  k6_slot_cornell=slot, k6_mixed=mixed, k6_textured=textured)
    out = {}
    for name, (bvh, extra) in CASES.items():
        js = scenes[name]
        ts = _port(js)
        kw = _kw(**extra)
        out[name] = (js, ts, kw, _jax_grads(js, kw, bvh), _port_grads(ts, kw, bvh))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_image_matches_jax(results, name):
    _, _, _, (img_ref, _), (img, _) = results[name]
    assert img.shape == img_ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img, img_ref, atol=IMG_TOL, rtol=IMG_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax(results, name):
    js, ts, _, (_, g_ref), (_, g) = results[name]
    kd = np.asarray(js.bsdf_params)[:, 0:3]
    # kd exactly 0 is the estimator's removable singularity: 0 on both sides
    assert (g[0][:, 0:3][kd == 0] == 0).all()
    checks = [(g[0], g_ref[0], "bsdf_params")]
    emissive = np.asarray(js.tri_light_idx) >= 0
    checks += [(g[1][emissive], g_ref[1][emissive], "tri_emission"),
               (g[2], g_ref[2], "light_emission")]
    for got, ref, tag in checks:
        scale = max(np.abs(ref).max(), 1e-12)
        assert np.abs(got - ref).max() <= GRAD_TOL * scale, (tag, np.abs(got - ref).max(), scale)
    assert np.abs(g_ref[0]).max() > 0


def test_forward_equals_k1_plain(results):
    """The fused render's image is the megakernel's (mega_grad.py:59-68)."""
    _, ts, kw, _, (img, _) = results["k5_cornell"]
    ref, _ = mega.render_mega(ts, RenderConfig(**kw), 0)
    assert abs(float((img * W).sum()) - float((ref.numpy() * W).sum())) < 1e-5 * abs(
        float((ref.numpy() * W).sum()))


def test_mixed_rows(results):
    _, ts, _, _, (_, g) = results["k6_mixed"]
    kd, mirror, light = 0, 1, 2
    rows = mg.mega_bvh_grad_rows(ts)
    assert kd in rows and light in rows and mirror not in rows
    assert (g[0][mirror] == 0).all() and (g[0][:, 3:] == 0).all()


def test_fd_matches_fused_grad(results):
    """Central differences of the same fused forward (plain K5) against its
    gradient, on the kd entry with the largest gradient
    (tests/test_mega_grad.py:115-140)."""
    _, ts, _, _, _ = results["k5_cornell"]
    cfg = RenderConfig(**_kw(spp=1, max_depth=2))

    def loss(bp):
        with torch.no_grad():
            return float((mg.render_mega_diff(ts.replace(bsdf_params=bp), cfg, 0)
                          * torch.as_tensor(W)).sum())

    bp = ts.bsdf_params.clone().requires_grad_(True)
    (mg.render_mega_diff(ts.replace(bsdf_params=bp), cfg, 0) * torch.as_tensor(W)).sum().backward()
    gkd = bp.grad[:, 0:3].numpy()
    b, c = np.unravel_index(np.abs(gkd).argmax(), gkd.shape)
    h = 1e-3
    e = torch.zeros_like(ts.bsdf_params)
    e[b, c] = h
    fd = (loss(ts.bsdf_params + e) - loss(ts.bsdf_params - e)) / (2 * h)
    assert abs(gkd[b, c] - fd) < 2e-2 * max(abs(fd), 1e-6), (gkd[b, c], fd)


def test_eligibility(results, cornell_scene):
    js, ts, kw, _, _ = results["k5_cornell"]
    cfg = RenderConfig(**kw)
    assert mg.mega_grad_eligible(ts, cfg) == jmg.mega_grad_eligible(js, JaxConfig(**kw)) is True
    assert not mg.mega_grad_eligible(ts, cfg.replace(max_depth=20))
    assert not mg.mega_grad_eligible(ts, cfg.replace(use_bvh=True))
    env = _port(env_box(JaxBuilder(), True).build())
    assert not mg.mega_grad_eligible(env, cfg)
    assert not mg.mega_bvh_grad_eligible(env, cfg.replace(use_bvh=True))
    for name in ("k6_slot_cornell", "k6_mixed", "k6_textured"):
        js, ts, kw, _, _ = results[name]
        assert mg.mega_bvh_grad_eligible(ts, RenderConfig(**kw))
        assert jmg.mega_bvh_grad_eligible(js, JaxConfig(**kw))
        assert mg.mega_bvh_grad_rows(ts) == jmg.mega_bvh_grad_rows(js)
        assert not mg.mega_grad_eligible(ts, RenderConfig(**kw))
    with pytest.raises(ValueError, match="eligible"):
        mg.render_mega_diff(ts, cfg.replace(max_depth=20))
    with pytest.raises(ValueError, match="eligible"):
        mg.render_mega_bvh_diff(ts, cfg.replace(use_bvh=True, max_depth=20))


def test_plane_layout(results):
    _, ts, kw, _, _ = results["k5_cornell"]
    B, L = ts.bsdf_kind.shape[0], ts.num_lights
    assert mg.grad_plane_keys(B, L) == jmg.grad_plane_keys(B, L)
    pix = mg.pix_rows(RenderConfig(**kw), "cpu")
    out = mg.render_mega_fwdgrad_rows(ts, RenderConfig(**kw), pix, 0)
    assert out[4].shape == (3 * B + 6 * L, pix.shape[0], mega.LANES)
    assert launches(mg.render_mega_fwdgrad_rows) == 0
