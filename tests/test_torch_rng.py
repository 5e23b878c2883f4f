"""PyTorch port: counter-based RNG bit-equal to gpuspectral_tpu/ops/rng.py on
random uint32 inputs (the torch version carries uint32 in int64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpuspectral_tpu.ops import rng as jrng
from gpuspectral_tpu_torch.ops import rng as trng

N = 4096


def _u32(seed, n=N):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


def _t(x):
    return torch.as_tensor(x.astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.uint64)


def test_pcg_hash_bit_equal():
    v = _u32(0)
    np.testing.assert_array_equal(_np(jrng.pcg_hash(jnp.asarray(v))), _np(trng.pcg_hash(_t(v))))


def test_tea_bit_equal():
    a, b = _u32(1), _u32(2)
    np.testing.assert_array_equal(
        _np(jrng.tea(jnp.asarray(a), jnp.asarray(b))), _np(trng.tea(_t(a), _t(b))))


def test_pixel_seed_bit_equal():
    a, b = _u32(3), _u32(4)
    np.testing.assert_array_equal(
        _np(jrng.pixel_seed(jnp.asarray(a), jnp.asarray(b))), _np(trng.pixel_seed(_t(a), _t(b))))


@pytest.mark.parametrize("scalar_counters", [False, True])
def test_random_bits_bit_equal(scalar_counters):
    s, b, c = _u32(5), _u32(6), _u32(7)
    if scalar_counters:  # the integrators' form: int bounce / channel
        jb, jc, tb, tc = 0xFFFF, 8, 0xFFFF, 8
    else:
        jb, jc, tb, tc = jnp.asarray(b), jnp.asarray(c), _t(b), _t(c)
    np.testing.assert_array_equal(
        _np(jrng.random_bits(jnp.asarray(s), jb, jc)), _np(trng.random_bits(_t(s), tb, tc)))


def test_uniform_bit_equal():
    s, b = _u32(8), _u32(9)
    for ch in range(12):
        ref = np.asarray(jrng.uniform(jnp.asarray(s), jnp.asarray(b), ch))
        got = trng.uniform(_t(s), _t(b), ch).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 12, 100, 255, 257, 1023, 40000])
def test_bits_mod_n_equal(n):
    # the uniform light pick: bits % num_lights (test_mega.py:86 n list)
    s = _u32(10)
    bits_j = jrng.random_bits(jnp.asarray(s), 3, 3)
    bits_t = trng.random_bits(_t(s), 3, 3)
    np.testing.assert_array_equal(
        _np(bits_j % jnp.uint32(n)), _np(bits_t % n))
