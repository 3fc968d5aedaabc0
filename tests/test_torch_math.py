"""The port's torus math (concrete_tpu_torch.math, .torus) held bit for bit
against concrete_tpu.math on the same inputs, including values next to the
2^32 wrap and rotation degrees over the whole of [0, 2N]."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from concrete_tpu.math import decomposition as dec_jax
from concrete_tpu.math import polynomial as poly_jax
from concrete_tpu_torch import torus
from concrete_tpu_torch.math import decomposition as dec_t
from concrete_tpu_torch.math import polynomial as poly_t

DECOMPS = [(7, 2), (8, 2), (6, 3), (2, 8), (4, 3)]
EDGES = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF,
         0xFFFF8000, 0xFE000000, 0x01FFFFFF]


def _torus_values(seed, n=512):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    x[:len(EDGES)] = EDGES
    return x


def _t(x):
    return torus.from_numpy(x)


@pytest.mark.parametrize("base_log,levels", DECOMPS)
def test_closest_representable(base_log, levels):
    x = _torus_values(1)
    want = np.asarray(dec_jax.closest_representable(jnp.asarray(x), base_log, levels))
    got = torus.to_numpy(dec_t.closest_representable(_t(x), base_log, levels))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("base_log,levels", DECOMPS)
def test_decompose_levels_and_rounded(base_log, levels):
    x = _torus_values(2)
    rounded = np.asarray(dec_jax.closest_representable(jnp.asarray(x), base_log, levels))
    want = np.asarray(dec_jax.decompose_levels(jnp.asarray(rounded), base_log, levels))
    got = dec_t.decompose_levels(_t(rounded), base_log, levels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_r = np.asarray(dec_jax.decompose_rounded(jnp.asarray(x), base_log, levels))
    np.testing.assert_array_equal(
        dec_t.decompose_rounded(_t(x), base_log, levels).numpy(), want_r)


@pytest.mark.parametrize("base_log,levels", DECOMPS)
def test_small_sign_decompose(base_log, levels):
    x = _torus_values(3)
    rounded = np.asarray(dec_jax.closest_representable(jnp.asarray(x), base_log, levels))
    want = np.asarray(dec_jax.small_sign_decompose(jnp.asarray(rounded), base_log, levels))
    got = dec_t.small_sign_decompose(_t(rounded), base_log, levels)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("base_log,levels", DECOMPS)
def test_recompose(base_log, levels):
    x = _torus_values(4)
    digits = np.asarray(dec_jax.decompose_rounded(jnp.asarray(x), base_log, levels))
    want = np.asarray(dec_jax.recompose(jnp.asarray(digits), base_log, levels, jnp.uint32))
    got = torus.to_numpy(dec_t.recompose(torch.from_numpy(digits.copy()), base_log, levels))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_negacyclic_monomial_mul_div(n):
    """Per-lane degrees over [0, 2N] (2N included: the modulus switch can
    return it), against the JAX barrel rotation."""
    rng = np.random.default_rng(n)
    b = 2 * n + 1
    polys = rng.integers(0, 1 << 32, size=(3, b, n), dtype=np.uint32)
    polys[0, 0, :len(EDGES[:n])] = EDGES[:n]
    degrees = np.arange(b, dtype=np.int32)                # 0 .. 2N
    for fn_t, fn_j in [(poly_t.negacyclic_monomial_mul, poly_jax.negacyclic_monomial_mul),
                       (poly_t.negacyclic_monomial_div, poly_jax.negacyclic_monomial_div)]:
        want = np.asarray(fn_j(jnp.asarray(polys), jnp.asarray(degrees)[None, :]))
        got = torus.to_numpy(fn_t(_t(polys), torch.from_numpy(degrees)[None, :]))
        np.testing.assert_array_equal(got, want)
    # scalar degree and a broadcast lead axis
    want = np.asarray(poly_jax.negacyclic_monomial_mul(jnp.asarray(polys[0]), 3))
    np.testing.assert_array_equal(
        torus.to_numpy(poly_t.negacyclic_monomial_mul(_t(polys[0]), 3)), want)


@pytest.mark.parametrize("k,n", [(1, 16), (2, 64), (4, 32)])
def test_negacyclic_multisum_matches_schoolbook(k, n):
    """The float64 keygen multisum is exact: held against the schoolbook
    negacyclic product mod 2^32 of the JAX package's numpy oracle."""
    rng = np.random.default_rng(k * n)
    masks = rng.integers(0, 1 << 32, size=(5, k, n), dtype=np.uint32)
    masks[0, 0, :] = 0xFFFFFFFF                            # largest partial sums
    key = rng.integers(0, 2, size=(k, n), dtype=np.uint32)
    key[0, :] = 1
    want = np.zeros((5, n), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for j in range(k):
            want += poly_jax.polymul_wrapping_naive(masks[:, j, :], key[j][None, :])
    got = torus.to_numpy(poly_t.negacyclic_multisum(_t(masks), _t(key)))
    np.testing.assert_array_equal(got, want)


def test_torus_carriers_round_trip():
    x = _torus_values(5)
    t = torus.from_numpy(x)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(torus.to_numpy(t), x)
    for s in (0, 1, 7, 24, 31, 32):
        want = (x >> np.uint32(s)) if s < 32 else np.zeros_like(x)
        np.testing.assert_array_equal(torus.to_numpy(torus.lshr(t, s)), want)
    assert [torus.i32(u) for u in (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)] == \
        [0, 0x7FFFFFFF, -(1 << 31), -1]


def test_from_torus_f64_matches_jax():
    from concrete_tpu.torus import from_torus_f64

    rng = np.random.default_rng(6)
    x = np.concatenate([rng.normal(0, 2.0 ** -20, 1000),
                        [0.0, 0.5, -0.5, 1.0 - 2.0 ** -40, -2.0 ** -40, 0.25]])
    np.testing.assert_array_equal(torus.from_torus_f64(x), from_torus_f64(x, 32))
