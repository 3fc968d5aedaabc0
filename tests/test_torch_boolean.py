"""The port's boolean-gate slice as a whole, on the CPU: keys made by
concrete_tpu are carried across through its npz files, and every gate of
the port must return the very ciphertexts the JAX package returns; the
port's own keys must give the truth tables."""

import dataclasses

import numpy as np
import pytest
import torch

from concrete_tpu import boolean as boolean_jax
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch import torus
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import BooleanParameters

from common import TINY, TINY_K2

A = [True, True, False, False]
B = [True, False, True, False]
C = [False, True, True, False]
TRUTH = {
    "and_": lambda a, b: a & b, "nand": lambda a, b: ~(a & b),
    "or_": lambda a, b: a | b, "nor": lambda a, b: ~(a | b),
    "xor": lambda a, b: a ^ b, "xnor": lambda a, b: ~(a ^ b),
}
GATES = list(TRUTH) + ["not_", "mux"]


def _port_params(p):
    return BooleanParameters(
        p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
        StandardDev(p.lwe_modular_std_dev.std_dev),
        StandardDev(p.glwe_modular_std_dev.std_dev),
        p.pbs_base_log, p.pbs_level, p.ks_base_log, p.ks_level)


def _call(sks, gate, a, b, c):
    if gate == "not_":
        return sks.not_(a)
    if gate == "mux":
        return sks.mux(a, b, c)
    return getattr(sks, gate)(a, b)


def _truth(gate):
    a, b, c = (np.array(v) for v in (A, B, C))
    if gate == "not_":
        return ~a
    if gate == "mux":
        return np.where(a, b, c)
    return TRUTH[gate](a, b)


@pytest.fixture(scope="module", params=[TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def jax_keys(request, tmp_path_factory):
    """JAX-made keys, saved, and loaded back by the port."""
    cks, sks = boolean_jax.gen_keys(request.param, secret_seed=1, mask_seed=2,
                                    noise_seed=3)
    d = tmp_path_factory.mktemp("keys")
    cks.save(str(d / "client.npz"))
    sks.save(str(d / "server.npz"))
    cts = [cks.encrypt(v, mask_seed=10 + i, noise_seed=20 + i)
           for i, v in enumerate((A, B, C))]
    return (cks, sks, boolean_t.ClientKey.load(str(d / "client.npz")),
            boolean_t.ServerKey.load(str(d / "server.npz"), device="cpu"), cts)


@pytest.mark.parametrize("gate", GATES)
def test_gates_match_jax_on_jax_keys(jax_keys, gate):
    cks_j, sks_j, cks_t, sks_t, (a, b, c) = jax_keys
    want = np.asarray(_call(sks_j, gate, a, b, c))
    got = _call(sks_t, gate, a, b, c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    np.testing.assert_array_equal(cks_t.decrypt(got), _truth(gate))


def test_keys_carried_across(jax_keys):
    cks_j, sks_j, cks_t, sks_t, (a, _, _) = jax_keys
    np.testing.assert_array_equal(cks_t.lwe_secret_key.key, cks_j.lwe_secret_key.key)
    np.testing.assert_array_equal(cks_t.glwe_secret_key.key, cks_j.glwe_secret_key.key)
    assert cks_t.parameters == _port_params(cks_j.parameters)
    np.testing.assert_array_equal(cks_t.decrypt(a), cks_j.decrypt(a))
    np.testing.assert_array_equal(sks_t.bsk_standard, sks_j.bsk_standard)
    from_arrays = boolean_t.ServerKey.from_arrays(
        sks_j.bsk_standard, np.asarray(sks_j.ksk), cks_t.parameters, device="cpu")
    assert from_arrays.cfg == sks_t.cfg
    np.testing.assert_array_equal(from_arrays.ksk, sks_t.ksk)


@pytest.fixture(scope="module")
def port_keys(tmp_path_factory):
    cks, sks = boolean_t.gen_keys(_port_params(TINY), secret_seed=5, mask_seed=6,
                                  noise_seed=7, device="cpu")
    d = tmp_path_factory.mktemp("port_keys")
    cks.save(str(d / "client.npz"))
    sks.save(str(d / "server.npz"))
    cks2 = boolean_t.ClientKey.load(str(d / "client.npz"))
    sks2 = boolean_t.ServerKey.load(str(d / "server.npz"), device="cpu")
    cts = [cks.encrypt(v, mask_seed=30 + i, noise_seed=40 + i)
           for i, v in enumerate((A, B, C))]
    return cks2, sks2, cts


@pytest.mark.parametrize("gate", GATES)
def test_port_keys_truth_tables(port_keys, gate):
    cks, sks, (a, b, c) = port_keys
    np.testing.assert_array_equal(cks.decrypt(_call(sks, gate, a, b, c)),
                                  _truth(gate))


def test_gate_batches_broadcast_and_pad(port_keys):
    """Leading batch axes, broadcasting and padding up to a warmed tier do
    not change any row; an empty batch returns an empty result."""
    cks, sks, (a, b, _) = port_keys
    want = torus.to_numpy(sks.and_(a, b))
    grid = sks.and_(np.stack([a, a]), b)
    assert tuple(grid.shape) == (2, 4, a.shape[-1])
    np.testing.assert_array_equal(torus.to_numpy(grid[1]), want)
    warm = boolean_t.ServerKey.from_arrays(
        sks.bsk_standard, sks.ksk, cks.parameters, device="cpu")
    assert set(warm.warmup([16])) == {("and", 16)}
    np.testing.assert_array_equal(torus.to_numpy(warm.and_(a, b)), want)
    assert tuple(sks.and_(a[:0], b[:0]).shape) == (0, a.shape[-1])


@pytest.mark.parametrize("tiers", [(), (2048,), (16, 2048), (4096, 8192)])
def test_pad_size_tiers_match_jax(tiers):
    cks, sks = boolean_t.gen_keys(_port_params(TINY_K2), secret_seed=1,
                                  mask_seed=2, noise_seed=3, device="cpu")
    sks_j = boolean_jax.ServerKey(ksk=sks.ksk, cfg=None, bsk_standard=sks.bsk_standard)
    sks._warmed_tiers.update(tiers)
    sks_j._warmed_tiers.update(tiers)
    for b in (1, 2, 3, 16, 17, 100, 2048, 2049, 5000, 8192, 9000):
        assert sks._pad_size(b) == sks_j._pad_size(b)


def test_server_key_rejects_mismatched_arrays(port_keys):
    cks, sks, _ = port_keys
    with pytest.raises(ValueError):
        boolean_t.ServerKey.from_arrays(sks.bsk_standard[:, :1], sks.ksk,
                                        cks.parameters, device="cpu")
    big = BooleanParameters(4, 1, 8192, StandardDev(0.0), StandardDev(0.0),
                            7, 2, 2, 2)
    large = boolean_t.ServerKey.from_arrays(
        np.zeros((4, 2, 2, 2, 8192), np.uint32),
        np.zeros((8192, 2, 5), np.uint32), big, device="cpu")
    assert large.resolved_backend() == "ntt"
    assert dataclasses.replace(large, backend="nuss").resolved_backend() == "nuss"
    with pytest.raises(NotImplementedError):          # O(N^2) table
        dataclasses.replace(large, backend="mxu").resolved_backend()
    assert dataclasses.replace(large, backend="ntt").resolved_backend() == "ntt"


@pytest.mark.parametrize("gate", ["and_", "xor", "mux"])
@pytest.mark.parametrize("fast", [{}, {"levels": 1}, {"limb_drop": 1}],
                         ids=["levels2", "levels1", "drop1"])
def test_fast_mode_gates_match_jax(jax_keys, gate, fast):
    """ServerKey.with_fast_mode on JAX keys: the same ciphertexts as the JAX
    package's fast-mode key on its mxu backend."""
    _, sks_j, _, sks_t, (a, b, c) = jax_keys
    fast_j = dataclasses.replace(sks_j, backend="mxu").with_fast_mode(**fast)
    fast_t = dataclasses.replace(sks_t, backend="mxu").with_fast_mode(**fast)
    assert fast_t.cfg.pbs_level == fast_j.cfg.pbs_level
    assert fast_t.cfg.mxu_limb_drop == fast_j.cfg.mxu_limb_drop
    assert fast_t.bsk_standard.shape == fast_j.bsk_standard.shape
    want = np.asarray(_call(fast_j, gate, a, b, c))
    np.testing.assert_array_equal(torus.to_numpy(_call(fast_t, gate, a, b, c)),
                                  want)
