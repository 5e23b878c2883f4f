"""PyTorch port: the Moller-Trumbore scans (ops/intersect.py) and the BVH
packet traversal (bvh/traverse.py) against the JAX package's, on the soups
and rays of tests/test_bvh.py and the cases of tests/test_intersect.py; the
wavefront with intersector "woop" / "mt" against the JAX wavefront; and the
megakernels' plain versions, which keep the plain K3 scans.

Both packages get the same numpy inputs.  XLA-CPU fuses the
Moller-Trumbore test's cross and dot products into FMAs, and the port
fuses the same ones in the same association, so t, u and v agree bit for
bit, prim and occ exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuspectral_tpu.bvh import traverse as jtr
from gpuspectral_tpu.bvh.build import build_bvh
from gpuspectral_tpu.diff import gradcheck as jgc
from gpuspectral_tpu.integrator.path_tracer import render_sample as jax_render_sample
from gpuspectral_tpu.ops import intersect as jis
from gpuspectral_tpu.ops import woop as jwoop
from gpuspectral_tpu.scene.data import SceneBuilder as JaxBuilder
from gpuspectral_tpu.utils.config import RenderConfig as JaxConfig
from gpuspectral_tpu_torch.bvh import ftb
from gpuspectral_tpu_torch.bvh import kernels as tk
from gpuspectral_tpu_torch.bvh import traverse as ttr
from gpuspectral_tpu_torch.diff import gradcheck as tgc
from gpuspectral_tpu_torch.integrator import mega_bvh, mega_grad
from gpuspectral_tpu_torch.integrator import path_tracer as pt
from gpuspectral_tpu_torch.ops import intersect as tis
from gpuspectral_tpu_torch.ops import woop as twoop
from gpuspectral_tpu_torch.scene.data import scene_from_arrays
from gpuspectral_tpu_torch.scene.zoo import populate_sphere_field
from gpuspectral_tpu_torch.utils import RenderConfig

from test_gradients import _glossy_box_scene
from test_torch_bvh import SMALL_FIELD
from torch_common import assert_mega_gates, jax_scene_arrays


def _soup(n_tris, seed=3):
    """tests/test_bvh.py:_random_soup, padded to 128 and Morton-sorted, with
    its BVH."""
    rs = np.random.default_rng(seed)
    tris = (rs.uniform(-4.0, 4.0, size=(n_tris, 1, 3))
            + rs.uniform(-0.3, 0.3, size=(n_tris, 3, 3))).astype(np.float32)
    pad = -(-n_tris // 128) * 128 - n_tris
    padded = np.concatenate([tris, np.zeros((pad, 3, 3), np.float32)])
    bvh = build_bvh(padded, n_tris)
    return padded[bvh.perm], bvh


def _rays(r, seed=7):
    """tests/test_bvh.py's ray origins, aimed at points of the soup's box so
    that many hit, with windows and an active mask."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-6, 6, size=(r, 3)).astype(np.float32)
    d = rs.uniform(-4, 4, size=(r, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.where(rs.uniform(size=r) < 0.5, 0.0, rs.uniform(0, 2, r)).astype(np.float32)
    t_max = np.where(rs.uniform(size=r) < 0.5, 1e30, rs.uniform(3, 9, r)).astype(np.float32)
    return o, d, t_min, t_max, rs.uniform(size=r) < 0.9


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _assert_equal(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_tris", [50, 700])
def test_mt_scans_match_jax(n_tris):
    tris, _ = _soup(n_tris)
    o, d, t_min, t_max, active = _rays(300)
    for kw in (dict(), dict(t_min=t_min, t_max=t_max, active=active)):
        ref = jis.intersect_closest(o, d, tris, tri_chunk=128,
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tis.intersect_closest(_t(o), _t(d), _t(tris), tri_chunk=128,
                                    **{k: _t(v) for k, v in kw.items()})
        assert got[1].dtype == torch.int32 and int((got[1] >= 0).sum()) > 5
        _assert_equal(got, ref)
    occ_ref = jis.intersect_any(o, d, tris, jnp.asarray(t_min), jnp.asarray(t_max),
                                active=jnp.asarray(active), tri_chunk=128)
    occ = tis.intersect_any(_t(o), _t(d), _t(tris), _t(t_min), _t(t_max), active=_t(active),
                            tri_chunk=128)
    assert int(occ.sum()) > 5
    _assert_equal([occ], [occ_ref])
    # JAX's woop= branch is the port's Woop scans (ops/woop.py), bit for bit
    w = jwoop.woop_transform(tris)
    ref = jis.intersect_closest(o, d, tris, active=jnp.asarray(active), woop=jnp.asarray(w),
                                tri_chunk=128)
    t_max_w = torch.where(_t(active), 1e30, -1e30)
    got = twoop.closest_scan(_t(o), _t(d), _t(w), torch.zeros(300), t_max_w, 128)
    _assert_equal(got, ref)
    occ = twoop.any_scan(_t(o), _t(d), _t(w), torch.full((300,), 0.0), torch.full((300,), 5.0),
                         128)
    _assert_equal([occ], [jis.intersect_any(o, d, tris, 0.0, 5.0, woop=jnp.asarray(w),
                                            tri_chunk=128)])


def test_mt_analytic_cases():
    """tests/test_intersect.py's cases: hit and miss, barycentrics, the
    closest of many across chunks, the window, inactive rays, padding."""
    tri = torch.tensor([[[0, 0, 1], [2, 0, 1], [0, 2, 1]]], dtype=torch.float32)
    o = torch.tensor([[0.5, 0.5, 0.0], [5.0, 5.0, 0.0], [0.5, 0.5, 2.0]])
    d = torch.tensor([[0, 0, 1.0]] * 3)
    t, prim, u, v = tis.intersect_closest(o, d, tri)
    assert prim.tolist() == [0, -1, -1] and abs(float(t[0]) - 1.0) < 1e-6
    t, prim, u, v = tis.intersect_closest(torch.tensor([[0.5, 0.25, 0.0]]), d[:1], tri)
    assert abs(float(u[0]) - 0.25) < 1e-6 and abs(float(v[0]) - 0.125) < 1e-6
    zs = np.linspace(1.0, 10.0, 37)
    many = np.zeros((37, 3, 3), np.float32)
    for i, z in enumerate(zs):
        many[i] = [[-1, -1, z], [3, -1, z], [-1, 3, z]]
    perm = np.random.default_rng(1).permutation(37)
    t, prim, _, _ = tis.intersect_closest(torch.zeros((1, 3)), d[:1], _t(many[perm]),
                                          tri_chunk=8)
    assert abs(float(t[0]) - 1.0) < 1e-6 and int(prim[0]) == int(np.where(perm == 0)[0][0])
    o1 = o[:1]
    assert int(tis.intersect_closest(o1, d[:1], tri, t_min=torch.tensor(1.5))[1][0]) == -1
    assert int(tis.intersect_closest(o1, d[:1], tri, t_max=torch.tensor(0.5))[1][0]) == -1
    assert bool(tis.intersect_any(o1, d[:1], tri, 0.0, 2.0)[0])
    assert not bool(tis.intersect_any(o1, d[:1], tri, 1.5, 2.0)[0])
    off = torch.tensor([False])
    assert int(tis.intersect_closest(o1, d[:1], tri, active=off)[1][0]) == -1
    assert not bool(tis.intersect_any(o1, d[:1], tri, 0.0, 10.0, active=off)[0])
    padded = torch.cat([tri, torch.zeros((7, 3, 3))])
    assert int(tis.intersect_closest(torch.tensor([[0.0, 0.0, -1.0]]), d[:1], padded)[1][0]) == 0


def _tree(bvh):
    return (jnp.asarray(bvh.node_min), jnp.asarray(bvh.node_max), bvh.n_clusters, bvh.leaf_size,
            bvh.n_levels)


def _port_tree(tris, bvh):
    """The port's traversal takes the packed leaf rows in place of the
    triangles, cluster count and leaf size."""
    return (tk.pack_tris(_t(tris), bvh.n_clusters, bvh.leaf_size), _t(bvh.node_min),
            _t(bvh.node_max), bvh.n_levels)


@pytest.mark.parametrize("n_tris,packet_size", [(50, 64), (700, 64), (700, 1024), (3000, 256)])
def test_traversal_matches_jax(n_tris, packet_size):
    """Closest and any hit: t, prim, u, v and occ equal, bit for bit, with
    windows, an active mask and a ragged last packet."""
    tris, bvh = _soup(n_tris)
    o, d, t_min, t_max, active = _rays(700)
    ref = jtr.intersect_closest_bvh(o, d, jnp.asarray(tris), *_tree(bvh),
                                    t_min=jnp.asarray(t_min), t_max=jnp.asarray(t_max),
                                    active=jnp.asarray(active), packet_size=packet_size)
    got = ttr.intersect_closest_bvh(_t(o), _t(d), *_port_tree(tris, bvh), t_min=_t(t_min),
                                    t_max=_t(t_max), active=_t(active), packet_size=packet_size)
    assert got[1].dtype == torch.int32 and int((got[1] >= 0).sum()) > 10
    _assert_equal(got, ref)
    occ_ref = jtr.intersect_any_bvh(o, d, jnp.asarray(tris), *_tree(bvh), t_min=0.01,
                                    t_max=8.0, active=jnp.asarray(active),
                                    packet_size=packet_size)
    occ = ttr.intersect_any_bvh(_t(o), _t(d), *_port_tree(tris, bvh), t_min=0.01, t_max=8.0,
                                active=_t(active), packet_size=packet_size)
    assert int(occ.sum()) > 5
    _assert_equal([occ], [occ_ref])
    # and the brute-force scan of the same arithmetic (tests/test_bvh.py)
    brute = tis.intersect_closest(_t(o), _t(d), _t(tris), t_min=_t(t_min), t_max=_t(t_max),
                                  active=_t(active), tri_chunk=128)
    for a, b in zip(got, brute):
        assert torch.equal(a, b)


def test_traversal_active_mask_and_window():
    tris, bvh = _soup(100, seed=9)
    o = torch.zeros((4, 3))
    d = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]], dtype=torch.float32)
    _, prim, _, _ = ttr.intersect_closest_bvh(o, d, *_port_tree(tris, bvh),
                                              active=torch.tensor([True, False, True, False]),
                                              packet_size=4)
    assert int(prim[1]) == -1 and int(prim[3]) == -1
    assert ttr.intersect_closest_bvh(o[:0], d[:0], *_port_tree(tris, bvh))[1].shape == (0,)


def test_traversal_carries_autograd():
    """d(t, u, v)/d(origin, direction) through the traversal equals the
    same derivative through the brute-force scan."""
    tris, bvh = _soup(700)
    o, d, _, _, _ = _rays(256, seed=4)
    w = _t(np.random.default_rng(5).normal(size=(3, 256)).astype(np.float32))
    grads = []
    for fn in (lambda oo, dd: ttr.intersect_closest_bvh(oo, dd, *_port_tree(tris, bvh),
                                                        packet_size=64),
               lambda oo, dd: tis.intersect_closest(oo, dd, _t(tris), tri_chunk=128)):
        oo, dd = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
        t, prim, u, v = fn(oo, dd)
        hit = prim >= 0
        loss = torch.where(hit, w[0] * t + w[1] * u + w[2] * v, 0.0).sum()
        grads.append(torch.autograd.grad(loss, (oo, dd)))
    assert float(grads[0][1].abs().max()) > 0
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def scenes(cornell_scene):
    """(JAX scene, the port's scene from the same tables) by name."""
    field = populate_sphere_field(JaxBuilder(), **SMALL_FIELD).build()
    return {name: (js, scene_from_arrays(*jax_scene_arrays(js), "cpu"))
            for name, js in (("cornell", cornell_scene), ("sphere_field", field))}


@pytest.mark.parametrize("name,kw", [
    ("cornell", dict(use_bvh=True, intersector="woop")),
    ("cornell", dict(use_bvh=True)),
    ("cornell", dict(use_bvh=True, intersector="mt")),
    ("cornell", dict(intersector="mt")),
    ("sphere_field", dict(use_bvh=True, intersector="woop")),
], ids=["cornell_bvh_woop", "cornell_bvh_auto", "cornell_bvh_mt", "cornell_mt",
        "sphere_field_bvh_woop"])
def test_wavefront_matches_jax(scenes, name, kw, monkeypatch):
    """render_sample (16x16, depth 3) against the JAX one under the
    tests/test_mega.py gates: with cfg.use_bvh both run the packet
    traversal, without it the Moller-Trumbore scan.  The BVH kernels' plain
    versions are never called."""
    js, ts = scenes[name]
    calls = []
    for fn in ("intersect_closest_bvh", "intersect_any_bvh"):
        real = getattr(ttr, fn)
        monkeypatch.setattr(ttr, fn, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    for fn in ("ftb_closest_ref", "ftb_any_ref", "ftb_closest", "ftb_any"):
        monkeypatch.setattr(ftb, fn, lambda *a, **k: pytest.fail("a BVH kernel's wrapper ran"))
    base = dict(width=16, height=16, max_depth=3, **kw)
    pix = np.arange(256, dtype=np.uint32)
    ref, rays_ref = jax_render_sample(js, JaxConfig(**base), jnp.asarray(pix), jnp.uint32(3))
    got, rays_got = pt.render_sample(ts, RenderConfig(**base),
                                     torch.as_tensor(pix.astype(np.int64)), 3)
    assert bool(calls) == bool(kw.get("use_bvh"))
    assert_mega_gates(np.asarray(ref)[:, None], got.numpy()[:, None],
                      float(np.asarray(rays_ref).sum()), float(rays_got.sum()))


def test_alpha_grad_through_traversal_matches_jax():
    """GGX alpha through the packet traversal (use_bvh, intersector "woop")
    against jax.grad through the JAX wavefront's Moller-Trumbore scan (the
    same leaf arithmetic, the same hits: the JAX traversal itself is a
    lax.while_loop, which reverse-mode autodiff refuses), within 1e-4 of the
    gradient's scale, the tolerance of tests/test_torch_gradients.py."""
    js, row = _glossy_box_scene()
    ts = scene_from_arrays(*jax_scene_arrays(js), "cpu")
    cfg = dict(width=24, height=24, spp=8, max_depth=3, ray_batch=576, jitter=False)
    target = np.random.default_rng(3).uniform(0, 1, (576, 3)).astype(np.float32)
    _, g_ref = jgc._loss_and_grad(js, JaxConfig(intersector="mt", **cfg), js.bsdf_params,
                                  jnp.asarray(target))
    _, g = tgc._loss_and_grad(ts, RenderConfig(use_bvh=True, intersector="woop", **cfg),
                              ts.bsdf_params, target)
    g_ref, g = np.asarray(g_ref), g.numpy()
    assert abs(g_ref[row, 9]) > 0 and np.isfinite(g).all()
    assert np.abs(g - g_ref).max() <= 1e-4 * np.abs(g_ref).max()


def test_megakernel_plain_versions_keep_the_plain_k3(scenes, monkeypatch):
    """K4's and K6's plain versions run the plain K3 scans (which K4 and K6
    equal), not the packet traversal that intersector "woop" now names."""
    _, ts = scenes["sphere_field"]
    for fn in ("intersect_closest_bvh", "intersect_any_bvh"):
        monkeypatch.setattr(ttr, fn, lambda *a, **k: pytest.fail("the traversal ran"))
    cfg = RenderConfig(width=16, height=8, spp=1, max_depth=2, use_bvh=True)
    pix = torch.arange(128, dtype=torch.int32).reshape(1, 128)
    rad = mega_bvh.render_mega_bvh_rows_ref(ts, cfg, pix, 0)
    ref = pt.trace_wavefront(ts, cfg.replace(light_block=0, sort_rays=False, shadow_sort=False),
                             pix.reshape(-1), 0, tex_mode="corners", bvh_isect=pt.PLAIN_K3)
    assert torch.equal(torch.stack(rad[:3], -1).reshape(-1, 3), ref["radiance"])
    out = mega_grad.render_mega_bvh_fwdgrad_rows_ref(ts, cfg.replace(max_depth=2), pix, 0)
    assert all(bool(torch.isfinite(x).all()) for x in out)
