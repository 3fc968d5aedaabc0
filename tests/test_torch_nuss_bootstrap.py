"""The port's Nussbaumer backend end to end, held against concrete_tpu on
the CPU with tolerance 0 (integer arithmetic mod 2^32 / 2^64): the blind
rotation, PBS, multi-LUT PBS and external product against the JAX nuss
path and the port's own mxu path, boolean gates and MUX on a
backend="nuss" key, the high-level bootstrapping key on JAX-made keys, and
the entry points' choice of backend at N = 8192 and 16384. The transform
functions, the plan, the key conversion and the kernels' plain versions
are in test_torch_nuss.py."""


import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu import boolean as boolean_jax
from concrete_tpu import highlevel as hl_jax
from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_nuss as bsn_jax
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_nuss as bsn_t

from common import TINY

UNSIGNED = {32: np.uint32, 64: np.uint64}
EDGES64 = [0, 1, 0xFFFF_FFFF, 0x1_0000_0000, 0x7FFF_FFFF_FFFF_FFFF,
           0x8000_0000_0000_0000, 0xFFFF_FFFF_FFFF_FFFF]


def _rand(rng, shape, bits):
    dt = UNSIGNED[bits]
    x = rng.integers(0, np.iinfo(dt).max, size=shape, dtype=dt, endpoint=True)
    if bits == 64:
        x.reshape(-1)[:len(EDGES64)] = EDGES64
    return x


def _cfgs(n, k, N, bl, lv, bits=32, ks_bl=4, ks_l=3):
    kw = dict(lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
              pbs_base_log=bl, pbs_level=lv, ks_base_log=ks_bl, ks_level=ks_l,
              bits=bits)
    return bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)



# -- blind rotation and bootstrap ---------------------------------------------------------


def _rotation_inputs(bits, n, k, N, lv, seed, b=4):
    rng = np.random.default_rng(seed)
    bsk = _rand(rng, (n, lv, k + 1, k + 1, N), bits)
    lut = _rand(rng, (k + 1, N), bits)
    lwe = _rand(rng, (b, n + 1), bits)
    return bsk, lut, lwe


@pytest.mark.parametrize("bits,n,k,N,bl,lv,L", [
    (32, 6, 1, 64, 7, 2, 2), (32, 5, 2, 128, 7, 3, 4), (32, 4, 1, 256, 8, 2, 8),
    (64, 4, 1, 64, 7, 2, 2), (64, 3, 2, 128, 7, 2, 4), (64, 3, 1, 256, 10, 2, 8)])
def test_blind_rotate_and_bootstrap_match_jax_and_mxu(bits, n, k, N, bl, lv, L):
    """tests/test_nussbaumer.py's configurations: the port's nuss path
    equals the JAX nuss path and the port's own mxu path."""
    cj, ct = _cfgs(n, k, N, bl, lv, bits)
    bsk, lut, lwe = _rotation_inputs(bits, n, k, N, lv, 2 + bits)
    rj = jnp.asarray(bsn_jax.bsk_to_nuss(bsk, cj, L))
    rt = bsn_t.bsk_to_nuss(bsk, ct, L)
    lj, wj = jnp.asarray(lut), jnp.asarray(lwe)
    lt, wt = torus.from_numpy(lut), torus.from_numpy(lwe)
    want = np.asarray(bsn_jax.blind_rotate_nuss(cj, rj, lj, wj, l=L))
    got = bsn_t.blind_rotate_nuss(ct, rt, lt, wt, l=L)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    mxu = bsx_t.blind_rotate_mxu(ct, torus.from_numpy(bsx_t.bsk_to_mxu(bsk, ct)),
                                 lt, wt)
    assert torch.equal(got, mxu)
    np.testing.assert_array_equal(
        torus.to_numpy(bsn_t.bootstrap_nuss(ct, rt, lt, wt, l=L)),
        np.asarray(bsn_jax.bootstrap_nuss(cj, rj, lj, wj, l=L)))


@pytest.mark.parametrize("bits", [32, 64])
def test_many_lut_and_external_product_match_jax(bits):
    cj, ct = _cfgs(3, 1, 64, 7, 2, bits)
    bsk, lut, lwe = _rotation_inputs(bits, 3, 1, 64, 2, 41 + bits)
    rj = jnp.asarray(bsn_jax.bsk_to_nuss(bsk, cj, 2))
    rt = bsn_t.bsk_to_nuss(bsk, ct, 2)
    want = np.asarray(bsn_jax.bootstrap_many_lut_nuss(
        cj, rj, jnp.asarray(lut), jnp.asarray(lwe), 2, ms_offset=1, l=2))
    got = bsn_t.bootstrap_many_lut_nuss(ct, rt, torus.from_numpy(lut),
                                        torus.from_numpy(lwe), 2, ms_offset=1, l=2)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    glwe = _rand(np.random.default_rng(3), (3, 2, 64), bits)
    np.testing.assert_array_equal(
        torus.to_numpy(bsn_t.external_product_nuss(ct, rt[1], torus.from_numpy(glwe), 2)),
        np.asarray(bsn_jax.external_product_nuss(cj, rj[1], jnp.asarray(glwe), 2)))


def test_blind_rotate_nuss_refuses_mismatched_inputs():
    _, ct = _cfgs(3, 1, 64, 7, 2)
    bsk, lut, lwe = _rotation_inputs(32, 3, 1, 64, 2, 5)
    rings = bsn_t.bsk_to_nuss(bsk, ct, 2)
    with pytest.raises(ValueError):
        bsn_t.blind_rotate_nuss(ct, rings[:2], torus.from_numpy(lut),
                                torus.from_numpy(lwe), l=2)
    with pytest.raises(TypeError):
        bsn_t.blind_rotate_nuss(ct, rings, torus.from_numpy(lut.astype(np.uint64)),
                                torus.from_numpy(lwe.astype(np.uint64)), l=2)
    with pytest.raises(ValueError):
        bsn_t.bsk_to_nuss(bsk[:, :1], ct, 2)


# -- entry points ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_keys(tmp_path_factory):
    """JAX-made TINY keys, saved, and loaded back by the port."""
    cks, sks = boolean_jax.gen_keys(TINY, secret_seed=1, mask_seed=2,
                                    noise_seed=3)
    d = tmp_path_factory.mktemp("nuss_keys")
    cks.save(str(d / "client.npz"))
    sks.save(str(d / "server.npz"))
    return (cks, dataclasses.replace(sks, backend="nuss"),
            boolean_t.ClientKey.load(str(d / "client.npz")),
            boolean_t.ServerKey.load(str(d / "server.npz"), device="cpu"))


@pytest.mark.parametrize("gate", ["and_", "xor", "mux"])
def test_server_key_nuss_gates_match_jax(tiny_keys, gate):
    """ServerKey(backend="nuss") gates and MUX on JAX-made TINY keys: the
    JAX nuss backend's ciphertexts, the truth tables, and the port's mxu
    backend's ciphertexts."""
    cks_j, sks_j, cks_t, sks_t = tiny_keys
    nuss = dataclasses.replace(sks_t, backend="nuss")
    assert nuss.resolved_backend() == "nuss" and sks_t.resolved_backend() == "ntt"
    sks_t = dataclasses.replace(sks_t, backend="mxu")
    a, b = np.array([False, True, False, True]), np.array([False, False, True, True])
    ca = cks_j.encrypt(a, mask_seed=20, noise_seed=21)
    cb = cks_j.encrypt(b, mask_seed=22, noise_seed=23)
    if gate == "mux":
        want, truth = sks_j.mux(ca, cb, ca), np.where(a, b, a)
        got, mxu = nuss.mux(ca, cb, ca), sks_t.mux(ca, cb, ca)
    else:
        want = getattr(sks_j, gate)(ca, cb)
        truth = a & b if gate == "and_" else a ^ b
        got, mxu = getattr(nuss, gate)(ca, cb), getattr(sks_t, gate)(ca, cb)
    np.testing.assert_array_equal(torus.to_numpy(got), np.asarray(want))
    assert torch.equal(got, mxu)
    np.testing.assert_array_equal(cks_t.decrypt(got), truth)
    assert nuss.bsk_nuss.shape[0] == TINY.lwe_dimension


def test_server_key_backend_is_carried(tiny_keys, tmp_path):
    _, _, _, sks_t = tiny_keys
    nuss = dataclasses.replace(sks_t, backend="nuss")
    nuss.bsk_nuss  # noqa: B018 - build the cache
    moved = nuss.to("cpu")
    assert moved.backend == "nuss" and "nuss" in moved.evaluation.forms
    fast = nuss.with_fast_mode(levels=1)
    assert fast.backend == "nuss" and "nuss" not in fast.evaluation.forms
    assert fast.bsk_nuss.shape[1] == nuss.bsk_nuss.shape[1] // nuss.cfg.pbs_level
    nuss.save(str(tmp_path / "k.npz"))
    assert boolean_t.ServerKey.load(str(tmp_path / "k.npz"),
                                    device="cpu").backend == "nuss"


def test_entry_points_resolve_nuss_at_large_n():
    big = boolean_t.ServerKey(
        np.zeros((8192, 2, 5), np.uint32),
        bs_t.ServerConfig(4, 1, 8192, 7, 2, 2, 2), np.zeros((4, 2, 2, 2, 8192),
                                                            np.uint32), "cpu")
    assert big.resolved_backend() == "ntt"
    assert dataclasses.replace(big, backend="nuss").resolved_backend() == "nuss"
    for n in (8192, 16384):
        bsk = hl_t.LWEBSK(hl_t.LWEBSK._config(2, 1, n, 7, 3), 2.0 ** -100,
                          np.zeros((2, 3, 2, 2, n), np.uint64), device="cpu")
        assert bsk.resolved_backend() == "nuss"
        assert dataclasses.replace(bsk, backend="nuss").resolved_backend() == "nuss"
        with pytest.raises(NotImplementedError):
            dataclasses.replace(bsk, backend="mxu").resolved_backend()


def test_highlevel_bsk_on_nuss_matches_jax(tmp_path):
    """A JAX-made high-level key loaded by the port on the nuss backend:
    PBS and multi-LUT PBS equal to the JAX nuss backend; fast mode's limb
    drop has no effect there, its levels do; the variance has no
    truncation term."""
    sk = hl_jax.LWESecretKey.new(hl_jax.LWEParams(8, -40), secret_seed=1)
    rsk = hl_jax.RLWESecretKey.new(hl_jax.RLWEParams(64, 1, -50), secret_seed=2)
    bsk_j = dataclasses.replace(
        hl_jax.LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4), backend="nuss")
    bsk_j.save(str(tmp_path / "bsk.npz"))
    bsk_t = hl_t.LWEBSK.load(str(tmp_path / "bsk.npz"), device="cpu",
                             backend="nuss")
    assert bsk_t.resolved_backend() == "nuss"
    rng = np.random.default_rng(5)
    acc = rng.integers(0, 1 << 64, size=(2, 64), dtype=np.uint64)
    cts = rng.integers(0, 1 << 64, size=(6, 9), dtype=np.uint64)
    np.testing.assert_array_equal(
        torus.to_numpy(bsk_t.run_bootstrap(acc, cts)),
        np.asarray(bsk_j.run_bootstrap(jnp.asarray(acc), jnp.asarray(cts))))
    np.testing.assert_array_equal(
        torus.to_numpy(bsk_t.run_bootstrap_many(acc, cts, 1)),
        np.asarray(bsk_j.run_bootstrap_many(jnp.asarray(acc), jnp.asarray(cts), 1)))
    fast_t, fast_j = bsk_t.with_fast_mode(limb_drop=2), bsk_j.with_fast_mode(limb_drop=2)
    np.testing.assert_array_equal(torus.to_numpy(fast_t.run_bootstrap(acc, cts)),
                                  torus.to_numpy(bsk_t.run_bootstrap(acc, cts)))
    assert fast_t.bootstrap_output_variance(8) == bsk_t.bootstrap_output_variance(8)
    np.testing.assert_allclose(fast_t.bootstrap_output_variance(8),
                               fast_j.bootstrap_output_variance(8), rtol=1e-12)
    lv2_t, lv2_j = bsk_t.with_fast_mode(limb_drop=0, levels=2), \
        bsk_j.with_fast_mode(limb_drop=0, levels=2)
    np.testing.assert_array_equal(
        torus.to_numpy(lv2_t.run_bootstrap(acc, cts)),
        np.asarray(lv2_j.run_bootstrap(jnp.asarray(acc), jnp.asarray(cts))))


def test_keygen_products_on_a_device_give_the_same_bytes():
    """Key generation's multisum runs on the key's device; on the CPU the
    explicit device and the default agree (the GPU is held to the same by
    the exactness of the float64 sums)."""
    from concrete_tpu_torch.core.ggsw import StandardBootstrapKey
    from concrete_tpu_torch.core.glwe import GlweSecretKey
    from concrete_tpu_torch.core.lwe import LweSecretKey
    from concrete_tpu_torch.csprng import (EncryptionRandomGenerator,
                                           SecretRandomGenerator)

    rng = SecretRandomGenerator(9)
    lsk = LweSecretKey.generate_binary(3, rng, 64)
    gsk = GlweSecretKey.generate_binary(1, 64, rng, 64)
    a = StandardBootstrapKey.generate(lsk, gsk, 7, 2, 2.0 ** -50,
                                      EncryptionRandomGenerator(1, 2))
    b = StandardBootstrapKey.generate(lsk, gsk, 7, 2, 2.0 ** -50,
                                      EncryptionRandomGenerator(1, 2),
                                      device=torch.device("cpu"))
    np.testing.assert_array_equal(a.data, b.data)

