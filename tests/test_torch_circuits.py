"""The port's boolean circuits (encrypt_uint, ripple_carry_adder,
decrypt_uint) against concrete_tpu.boolean.circuits, byte for byte, on keys
both packages make from the same seeds (tiny insecure parameters, CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from concrete_tpu import boolean as boolean_jax
from concrete_tpu.boolean import circuits as circuits_jax
from concrete_tpu.dispersion import StandardDev as StdJax
from concrete_tpu.params import BooleanParameters as ParamsJax
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch.boolean import circuits
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import BooleanParameters
from concrete_tpu_torch.torus import from_numpy, to_numpy

SHAPE = (4, 1, 64, 2.0 ** -20, 2.0 ** -25, 7, 3, 2, 5)
A = np.array([0, 1, 5, 7, 3, 6], dtype=np.uint64)
B = np.array([0, 7, 2, 7, 4, 1], dtype=np.uint64)


def _params(cls, std):
    n, k, N, s1, s2, bl, lv, ks_bl, ks_lv = SHAPE
    return cls(n, k, N, std(s1), std(s2), bl, lv, ks_bl, ks_lv)


@pytest.fixture(scope="module")
def keys():
    jax_keys = boolean_jax.gen_keys(_params(ParamsJax, StdJax), secret_seed=1,
                                    mask_seed=2, noise_seed=3)
    port_keys = boolean_t.gen_keys(_params(BooleanParameters, StandardDev),
                                   secret_seed=1, mask_seed=2, noise_seed=3,
                                   device="cpu")
    return jax_keys, port_keys


def test_encrypt_uint_matches_jax(keys):
    (cks_j, _), (cks_t, _) = keys
    got = circuits.encrypt_uint(cks_t, A, 3, mask_seed=4, noise_seed=5)
    assert got.shape == (3, len(A), 5) and got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, circuits_jax.encrypt_uint(cks_j, A, 3, mask_seed=4, noise_seed=5))
    # the planes take distinct sub-seeds: no two share a mask
    assert len({bytes(p[:, :-1]) for p in got}) == 3
    np.testing.assert_array_equal(circuits.decrypt_uint(cks_t, got), A)
    np.testing.assert_array_equal(
        circuits.decrypt_uint(cks_t, circuits.encrypt_uint(cks_t, 9, 4)), [9])


@pytest.mark.parametrize("with_carry", [False, True], ids=["no_carry", "carry_in"])
def test_ripple_carry_adder_matches_jax(keys, with_carry):
    (cks_j, sks_j), (cks_t, sks_t) = keys
    a = circuits.encrypt_uint(cks_t, A, 3, mask_seed=6, noise_seed=7)
    b = circuits.encrypt_uint(cks_t, B, 3, mask_seed=8, noise_seed=9)
    c_in = cks_t.encrypt([True] * len(A), mask_seed=10, noise_seed=11) \
        if with_carry else None
    sums, carry = circuits.ripple_carry_adder(
        sks_t, from_numpy(a), b, None if c_in is None else from_numpy(c_in))
    sums_j, carry_j = circuits_jax.ripple_carry_adder(
        sks_j, a, b, None if c_in is None else jnp.asarray(c_in))
    np.testing.assert_array_equal(to_numpy(sums), np.asarray(sums_j))
    np.testing.assert_array_equal(to_numpy(carry), np.asarray(carry_j))
    total = A + B + (1 if with_carry else 0)
    np.testing.assert_array_equal(circuits.decrypt_uint(cks_t, sums), total % 8)
    np.testing.assert_array_equal(
        circuits.decrypt_uint(cks_t, sums),
        circuits_jax.decrypt_uint(cks_j, np.asarray(sums_j)))
    np.testing.assert_array_equal(cks_t.decrypt(carry), total >= 8)


def test_adder_backends_give_the_same_bits(keys):
    """The adder on the toeplitz backend equals the default (ntt) one."""
    _, (cks_t, sks_t) = keys
    a = circuits.encrypt_uint(cks_t, A, 2, mask_seed=12, noise_seed=13)
    b = circuits.encrypt_uint(cks_t, B, 2, mask_seed=14, noise_seed=15)
    mxu = dataclasses.replace(sks_t, backend="mxu")
    assert (sks_t.resolved_backend(), mxu.resolved_backend()) == ("ntt", "mxu")
    for x, y in zip(circuits.ripple_carry_adder(sks_t, a, b),
                    circuits.ripple_carry_adder(mxu, a, b)):
        np.testing.assert_array_equal(to_numpy(x), to_numpy(y))
