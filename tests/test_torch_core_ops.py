"""The LWE / GLWE / one-GGSW operations the fixture grid calls, held bit for
bit against concrete_tpu on the CPU: the nine server-side LWE ops on both
tori (negative weights and cleartexts wrap two's-complement), the GLWE NTT
conversions, the mxu external product and CMux on one GGSW's rings, and the
torus distance helpers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from concrete_tpu import torus as torus_jax
from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_mxu as bsx_jax
from concrete_tpu.core import glwe as glwe_jax
from concrete_tpu.core import lwe as lwe_jax
from concrete_tpu.core.ggsw import encrypt_constant_ggsw as ggsw_jax
from concrete_tpu.core.glwe import GlweSecretKey as GlweKeyJax
from concrete_tpu.csprng import EncryptionRandomGenerator as GenJax
from concrete_tpu.csprng import SecretRandomGenerator as SecretJax
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import glwe as glwe_t
from concrete_tpu_torch.core import lwe as lwe_t

DT = {32: np.uint32, 64: np.uint64}


def _rand(rng, shape, bits):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64,
                        endpoint=True).astype(DT[bits]) * DT[bits](3)


def _same(port, jax_out):
    np.testing.assert_array_equal(torus.to_numpy(port), np.asarray(jax_out))


@pytest.mark.parametrize("bits", [32, 64])
def test_torus_distance_helpers(bits):
    rng = np.random.default_rng(bits)
    a, b = _rand(rng, 257, bits), _rand(rng, 257, bits)
    np.testing.assert_array_equal(
        torus.torus_modular_distance(torus.from_numpy(a, bits=bits), b, bits),
        torus_jax.torus_modular_distance(a, b, bits))
    np.testing.assert_array_equal(torus.into_signed_torus_f64(a, bits),
                                  torus_jax.into_signed_torus_f64(a, bits))


@pytest.mark.parametrize("bits", [32, 64])
def test_lwe_ops_match_jax(bits):
    rng = np.random.default_rng(7 + bits)
    n, m = 24, 5
    ca, cb = _rand(rng, (6, n + 1), bits), _rand(rng, (6, n + 1), bits)
    ta, tb = torus.from_numpy(ca, bits=bits), torus.from_numpy(cb, bits=bits)
    ja, jb = jnp.asarray(ca), jnp.asarray(cb)
    pt = _rand(rng, 6, bits)
    _same(lwe_t.trivial_encrypt(pt, n, bits), lwe_jax.trivial_encrypt(pt, n, bits))
    _same(lwe_t.trivial_decrypt(ta), lwe_jax.trivial_decrypt(ja))
    _same(lwe_t.add(ta, tb), lwe_jax.add(ja, jb))
    _same(lwe_t.sub(ta, tb), lwe_jax.sub(ja, jb))
    _same(lwe_t.neg(ta), lwe_jax.neg(ja))
    _same(lwe_t.add_plaintext(ta, pt[0]), lwe_jax.add_plaintext(ja, pt[0]))
    _same(lwe_t.sub_plaintext(ta, pt), lwe_jax.sub_plaintext(ja, pt))
    for c in (5, -3, np.int64(-(1 << 40)), DT[bits](0xFFFF_FFF0)):
        _same(lwe_t.scalar_mul(ta, c), lwe_jax.scalar_mul(ja, c))
    # the input must not change (the ops return new tensors)
    np.testing.assert_array_equal(torus.to_numpy(ta), ca)
    cts = _rand(rng, (3, m, n + 1), bits)
    weights = (4, -7, 0, -1, 1 << 20)
    _same(lwe_t.affine_transform(torus.from_numpy(cts, bits=bits), weights,
                                 pt[1]),
          lwe_jax.affine_transform(jnp.asarray(cts), weights, pt[1]))


@pytest.mark.parametrize("bits,k,n", [(32, 2, 32), (64, 1, 32)])
def test_glwe_ntt_round_trip_and_spectra(bits, k, n):
    cfg = bs_t.ServerConfig(lwe_dimension=8, glwe_dimension=k,
                            polynomial_size=n, pbs_base_log=6, pbs_level=2,
                            ks_base_log=2, ks_level=5, bits=bits)
    rng = np.random.default_rng(n + bits)
    ct = _rand(rng, (3, k + 1, n), bits)
    spec = glwe_t.glwe_to_ntt(ct, cfg.primes, bits)
    spec_jax = glwe_jax.glwe_to_ntt(jnp.asarray(ct), cfg.primes, bits)
    np.testing.assert_array_equal(spec.numpy().view(np.uint32),
                                  np.asarray(spec_jax))
    back = glwe_t.glwe_from_ntt(spec, cfg.primes, bits)
    np.testing.assert_array_equal(torus.to_numpy(back), ct)
    _same(back, glwe_jax.glwe_from_ntt(spec_jax, cfg.primes, bits))


def _ggsw_pair(k, n, bl, lv, bits, bit, seed):
    """A GGSW(bit) made by concrete_tpu and its mxu rings in both packages."""
    sk = GlweKeyJax.generate_binary(k, n, SecretJax(seed), bits)
    ggsw = ggsw_jax(sk, bit, bl, lv, 2.0 ** -25, GenJax(seed + 1, seed + 2))
    return sk, ggsw


# every value of each axis (N 64 / 256, k 1 / 2, base_log 7 / 8 with
# n_sub 1 / 2, u32 / u64) in four cases
@pytest.mark.parametrize("bits,n,k,bl,lv", [
    (32, 64, 1, 7, 2), (32, 256, 2, 8, 2), (64, 64, 2, 8, 2),
    (64, 256, 1, 7, 3)])
def test_external_product_and_cmux_mxu_match_jax(bits, n, k, bl, lv):
    cfg_kw = dict(lwe_dimension=4, glwe_dimension=k, polynomial_size=n,
                  pbs_base_log=bl, pbs_level=lv, ks_base_log=2, ks_level=5,
                  bits=bits)
    cfg_j, cfg_t = bs_jax.ServerConfig(**cfg_kw), bs_t.ServerConfig(**cfg_kw)
    assert bsx_t.MxuPlan.from_config(cfg_t).n_sub == (1 if bl == 7 else 2)
    rng = np.random.default_rng(n * k + bl + bits)
    _, ggsw = _ggsw_pair(k, n, bl, lv, bits, 1, n + k)
    rings_np = bsx_t.bsk_to_mxu(ggsw[None], cfg_t)[0]
    np.testing.assert_array_equal(rings_np,
                                  bsx_jax.bsk_to_mxu(ggsw[None], cfg_j)[0])
    rings_t = torch.from_numpy(rings_np.view(np.int32))
    ct0, ct1 = _rand(rng, (5, k + 1, n), bits), _rand(rng, (5, k + 1, n), bits)
    _same(bsx_t.external_product_mxu(cfg_t, rings_t, ct1),
          bsx_jax.external_product_mxu(cfg_j, jnp.asarray(rings_np),
                                       jnp.asarray(ct1)))
    _same(bsx_t.cmux_mxu(cfg_t, rings_t, torus.from_numpy(ct0, bits=bits),
                         torus.from_numpy(ct1, bits=bits)),
          bsx_jax.cmux_mxu(cfg_j, jnp.asarray(rings_np), jnp.asarray(ct0),
                           jnp.asarray(ct1)))
