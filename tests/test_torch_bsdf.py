"""PyTorch port: the 8 BSDF sample/eval pairs against
gpuspectral_tpu/bsdf/dispatch.py on the same random inputs.

Tolerance rtol=1e-5, atol=1e-6: the two run the same float32 operations in
the same order, but XLA-CPU and torch-CPU take sin, cos, exp and log from
different libm implementations (ulp-level differences).

f and pdf are compared on the samples a path continues with: wi above the
surface, or any wi of the transmitting dielectric.  A reflective lobe that
samples wi below the horizon is terminated by the integrator
(path_tracer: invalid_hemi) and its f / pdf are discarded; there wi is
close to -wo, wh = normalize(wi + wo) is ill-conditioned, and one ulp of
libm difference moves f by up to 20%.

wi is a unit vector, so its tolerance is taken against its length
(atol + rtol * |wi| per component), not against each component: a small
component of a reflected direction carries the absolute error of the
whole vector."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.bsdf import dispatch as jd
from gpuspectral_tpu_torch.bsdf import dispatch as td
from gpuspectral_tpu_torch.bsdf import table as bt

N = 2048
RTOL, ATOL = 1e-5, 1e-6

ROWS = {
    bt.BSDF_DIFFUSE: bt.diffuse((0.7, 0.5, 0.3)),
    bt.BSDF_SMOOTH_DIELECTRIC: bt.smooth_dielectric(1.5),
    bt.BSDF_SMOOTH_CONDUCTOR: bt.smooth_conductor(1.3),
    bt.BSDF_SMOOTH_PLASTIC: bt.smooth_plastic((0.6, 0.2, 0.2), 1.5),
    bt.BSDF_ROUGH_CONDUCTOR: bt.rough_conductor((1.66, 0.88, 0.52), (9.2, 6.3, 4.8), (1, 1, 1), 0.2),
    bt.BSDF_SMOOTH_FLOOR: bt.smooth_floor((0.3, 0.5, 0.7), 0.04),
    bt.BSDF_ROUGH_FLOOR: bt.rough_floor((0.7, 0.5, 0.3), 0.04, 0.3),
    bt.BSDF_ROUGH_PLASTIC: bt.rough_plastic((0.2, 0.6, 0.2), 1.5, alpha=0.2),
}
KINDS = sorted(ROWS)


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    if kind != bt.BSDF_SMOOTH_DIELECTRIC:  # only the dielectric sees wo.z < 0
        wo[:, 2] = np.abs(wo[:, 2])
    wo[:, 2] = np.maximum(np.abs(wo[:, 2]), 0.05) * np.sign(wo[:, 2] + 1e-9)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u = rng.uniform(size=(3, N)).astype(np.float32)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi[:, 2] = np.abs(wi[:, 2]) + 0.05
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    params = np.broadcast_to(ROWS[kind][1], (N, bt.NUM_PARAMS)).copy()
    kinds = np.full((N,), kind, np.int32)
    return params, kinds, wo, u, wi


def _close(ref, got, mask=None):
    ref = np.asarray(ref)
    if mask is not None:
        ref, got = ref[mask], got[mask]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _close_dir(ref, got):
    ref = np.asarray(ref)
    bound = ATOL + RTOL * np.linalg.norm(ref, axis=-1, keepdims=True)
    err = np.abs(got - ref)
    assert (err <= bound).all(), float((err - bound).max())


def _continued(wi, kinds):
    """Samples the integrator continues: wi.z > 0, or transmission."""
    wi = np.asarray(wi)
    return (wi[:, 2] > 0.0) | (np.asarray(kinds) == bt.BSDF_SMOOTH_DIELECTRIC)


@pytest.mark.parametrize("kind", KINDS, ids=bt.BSDF_NAMES)
def test_sample_matches_jax(kind):
    p, k, wo, u, _ = _inputs(kind, kind)
    ref = jd.sample_bsdf(jnp.asarray(p), jnp.asarray(k), jnp.asarray(wo),
                         *map(jnp.asarray, u), present=(kind,))
    got = td.sample_bsdf(torch.as_tensor(p), torch.as_tensor(k), torch.as_tensor(wo),
                         *map(torch.as_tensor, u), present=(kind,))
    _close_dir(ref[0], got[0].numpy())
    cont = _continued(ref[0], k)
    assert cont.mean() > 0.5
    for r, g in zip(ref[1:3], got[1:3]):
        _close(r, g.numpy(), cont)
    np.testing.assert_array_equal(np.asarray(ref[3]), got[3].numpy())


@pytest.mark.parametrize("kind", KINDS, ids=bt.BSDF_NAMES)
def test_eval_matches_jax(kind):
    p, k, wo, _, wi = _inputs(kind, 100 + kind)
    ref = jd.eval_bsdf(jnp.asarray(p), jnp.asarray(k), jnp.asarray(wo), jnp.asarray(wi),
                       present=(kind,))
    got = td.eval_bsdf(torch.as_tensor(p), torch.as_tensor(k), torch.as_tensor(wo),
                       torch.as_tensor(wi), present=(kind,))
    for r, g in zip(ref[:2], got[:2]):
        _close(r, g.numpy())
    np.testing.assert_array_equal(np.asarray(ref[2]), got[2].numpy())


def test_mixed_kind_dispatch_matches_jax():
    # all 8 kinds in one batch, selected per lane (present=None: every branch)
    parts = [_inputs(kind, 200 + kind) for kind in KINDS]
    p, k, wo, u, wi = (np.concatenate([x[i] for x in parts], axis=1 if i == 3 else 0)
                       for i in range(5))
    ref = jd.sample_bsdf(jnp.asarray(p), jnp.asarray(k), jnp.asarray(wo), *map(jnp.asarray, u))
    got = td.sample_bsdf(torch.as_tensor(p), torch.as_tensor(k), torch.as_tensor(wo),
                         *map(torch.as_tensor, u))
    _close_dir(ref[0], got[0].numpy())
    cont = _continued(ref[0], k)
    for r, g in zip(ref[1:3], got[1:3]):
        _close(r, g.numpy(), cont)
    np.testing.assert_array_equal(np.asarray(ref[3]), got[3].numpy())
    ref_e = jd.eval_bsdf(jnp.asarray(p), jnp.asarray(k), jnp.asarray(wo), jnp.asarray(wi))
    got_e = td.eval_bsdf(torch.as_tensor(p), torch.as_tensor(k), torch.as_tensor(wo),
                         torch.as_tensor(wi))
    for r, g in zip(ref_e[:2], got_e[:2]):
        _close(r, g.numpy())


def test_is_transmission_only_dielectric():
    k = torch.arange(8)
    assert td.is_transmission(k).tolist() == [x == bt.BSDF_SMOOTH_DIELECTRIC for x in range(8)]
