"""PyTorch port: brute-force intersection.  The plain torch scans
(closest_ref / any_ref, the plain versions of kernel K2) against the JAX
Pallas kernels closest_pallas / any_pallas in interpret mode (the CUDA
kernels against the plain versions: tests/test_torch_cuda.py).

XLA on the CPU fuses the Woop test's multiply-adds into FMAs; the port
fuses the same ones in the same association (m3.fma in torch, fmaf in
CUDA), so t and prim agree bitwise, ties going to the lowest prim id."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.ops.pallas_isect import any_pallas, closest_pallas
from gpuspectral_tpu_torch.ops import cuda_isect as ci
from gpuspectral_tpu_torch.ops.woop import woop_transform
from gpuspectral_tpu_torch.scene import load_mitsuba_scene
from gpuspectral_tpu_torch.scene.zoo import build_zoo

from torch_common import CORNELL_XML, launches

R = 1024


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, size=(n, 1, 3))
    tris = (centers + rng.normal(scale=0.3, size=(n, 3, 3))).astype(np.float32)
    return woop_transform(tris).T.copy()


def _tables():
    cornell = load_mitsuba_scene(str(CORNELL_XML), device="cpu")[0].tri_woop_t.numpy()
    zoo = build_zoo("cpu").tri_woop_t.numpy()
    return {"cornell": cornell, "zoo": zoo, "soup256": _soup(256, 1)}


TABLES = _tables()


def _rays(seed, r=R, lo=-1.5, hi=2.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rng.uniform(size=r) < 0.5, 0.0, rng.uniform(0, 0.5, size=r)).astype(np.float32)
    t_max = np.where(rng.uniform(size=r) < 0.5, 1e30, rng.uniform(0.5, 6.0, size=r)).astype(np.float32)
    return o, d, t_min, t_max


@pytest.mark.parametrize("name", sorted(TABLES))
def test_closest_ref_matches_pallas(name):
    w = TABLES[name]
    rays = _rays(sorted(TABLES).index(name))
    t_j, p_j = closest_pallas(*map(jnp.asarray, rays[:2]), jnp.asarray(w),
                              *map(jnp.asarray, rays[2:]), interpret=True)
    t_t, p_t = ci.closest_ref(*map(torch.as_tensor, rays[:2]), torch.as_tensor(w),
                              *map(torch.as_tensor, rays[2:]))
    t_j, p_j = np.asarray(t_j), np.asarray(p_j)
    assert (p_j >= 0).sum() > R // 10
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    np.testing.assert_array_equal(t_t.numpy(), t_j)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_any_ref_matches_pallas(name):
    w = TABLES[name]
    rays = _rays(10 + sorted(TABLES).index(name))
    occ_j = any_pallas(*map(jnp.asarray, rays[:2]), jnp.asarray(w),
                       *map(jnp.asarray, rays[2:]), interpret=True)
    occ_t = ci.any_ref(*map(torch.as_tensor, rays[:2]), torch.as_tensor(w),
                       *map(torch.as_tensor, rays[2:]))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


def test_closest_tie_takes_lowest_id():
    # two identical triangles: every hit is an exact t tie
    w = _soup(1, 5)
    w2 = np.concatenate([w, w, np.zeros((12, 126), np.float32)], axis=1)
    o = np.zeros((64, 3), np.float32)
    o[:] = [0.0, 0.0, -5.0]
    rng = np.random.default_rng(2)
    d = (rng.normal(scale=0.05, size=(64, 3)) + [0, 0, 1]).astype(np.float32)
    tri = np.linalg.inv(w[:9, 0].reshape(3, 3))  # columns e1 e2 n
    v0 = -tri @ w[9:12, 0]
    target = v0 + 0.3 * tri[:, 0] + 0.3 * tri[:, 1]
    d[:] = (target - o[0]) / np.linalg.norm(target - o[0])
    t, prim = ci.closest_ref(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(w2),
                             torch.zeros(64), torch.full((64,), 1e30))
    assert (prim == 0).all() and torch.isfinite(t).all()


def test_wrappers_validate_and_use_plain_version_on_cpu():
    w = torch.as_tensor(TABLES["cornell"])
    o, d, lo, hi = map(torch.as_tensor, _rays(3, r=16))
    before = (launches(ci.closest_cuda), launches(ci.any_cuda))
    t, prim = ci.closest_cuda(o, d, w, lo, hi)
    t_r, prim_r = ci.closest_ref(o, d, w, lo, hi)
    assert torch.equal(t, t_r) and torch.equal(prim, prim_r)
    assert torch.equal(ci.any_cuda(o, d, w, lo, hi), ci.any_ref(o, d, w, lo, hi))
    assert (launches(ci.closest_cuda), launches(ci.any_cuda)) == before  # no kernel ran
    with pytest.raises(ValueError, match="woop_t"):
        ci.closest_cuda(o, d, w[:, :100].contiguous(), lo, hi)
    with pytest.raises(ValueError, match="origin"):
        ci.any_cuda(o.double(), d, w, lo, hi)
    with pytest.raises(ValueError, match="direction"):
        ci.closest_cuda(o, d[:, :2], w, lo, hi)


def test_wrappers_take_the_rows_to_test():
    """n_rows: the leading slots tested, 0 <= n_rows <= T (0: every ray
    misses); the plain versions test the same rows, so a cut past the last
    triangle changes nothing and a cut before it drops the rows after."""
    w = torch.as_tensor(TABLES["soup256"])
    o, d, lo, hi = map(torch.as_tensor, _rays(4, r=512))
    full = ci.closest_cuda(o, d, w, lo, hi), ci.any_cuda(o, d, w, lo, hi)
    assert int((full[0][1] >= 128).sum()) > 0 and bool(full[1].any())
    assert all(torch.equal(a, b) for a, b in zip(ci.closest_cuda(o, d, w, lo, hi, 256), full[0]))
    t, prim = ci.closest_cuda(o, d, w, lo, hi, n_rows=128)
    t_r, prim_r = ci.closest_ref(o, d, w[:, :128].contiguous(), lo, hi)
    assert torch.equal(t, t_r) and torch.equal(prim, prim_r) and int(prim.max()) < 128
    assert torch.equal(ci.any_cuda(o, d, w, lo, hi, n_rows=128),
                       ci.any_ref(o, d, w[:, :128].contiguous(), lo, hi))
    t, prim = ci.closest_cuda(o, d, w, lo, hi, n_rows=0)
    assert bool((t == 1e30).all()) and bool((prim == -1).all())
    assert not bool(ci.any_cuda(o, d, w, lo, hi, n_rows=0).any())
    for bad in (-1, 257):
        with pytest.raises(ValueError, match="n_rows"):
            ci.closest_cuda(o, d, w, lo, hi, n_rows=bad)
        with pytest.raises(ValueError, match="n_rows"):
            ci.any_cuda(o, d, w, lo, hi, n_rows=bad)
