"""The port's client side against concrete_tpu's, byte for byte (tolerance
0), on the CPU at tiny sizes: LWE and GLWE keys of every kind on both tori
and their encryptions, the bootstrap key (batched and batched=False), GGSW,
the keyswitch key and the general keyswitch at base_log > 7, GSW and
packing, the checks' exception classes, boolean.gen_keys and the
high-level keys from equal seeds, and test_golden.py's key-material and
gate-pipeline digests."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu import boolean as boolean_jax
from concrete_tpu import highlevel as hl_jax
from concrete_tpu.core import checks as checks_jax
from concrete_tpu.core import ggsw as ggsw_jax
from concrete_tpu.core import glwe as glwe_jax
from concrete_tpu.core import gsw as gsw_jax
from concrete_tpu.core import lwe as lwe_jax
from concrete_tpu.core import packing as packing_jax
from concrete_tpu.csprng import EncryptionRandomGenerator as EncJax
from concrete_tpu.csprng import SecretRandomGenerator as SecJax
from concrete_tpu.math import polynomial as poly_jax
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_ntt as bsntt_t
from concrete_tpu_torch.core import checks
from concrete_tpu_torch.core import ggsw as ggsw_t
from concrete_tpu_torch.core import glwe as glwe_t
from concrete_tpu_torch.core import gsw as gsw_t
from concrete_tpu_torch.core import lwe as lwe_t
from concrete_tpu_torch.core import packing as packing_t
from concrete_tpu_torch.csprng import EncryptionRandomGenerator as Enc
from concrete_tpu_torch.csprng import SecretRandomGenerator as Sec
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import BooleanParameters
from concrete_tpu_torch.torus import from_numpy, to_numpy

from common import TINY, TINY_K2

KINDS = ("binary", "ternary", "gaussian", "uniform")
DT = {32: np.uint32, 64: np.uint64}


def _h(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _port_params(p, **over):
    fields = dict(lwe_dimension=p.lwe_dimension, glwe_dimension=p.glwe_dimension,
                  polynomial_size=p.polynomial_size,
                  lwe_modular_std_dev=StandardDev(p.lwe_modular_std_dev.std_dev),
                  glwe_modular_std_dev=StandardDev(p.glwe_modular_std_dev.std_dev),
                  pbs_base_log=p.pbs_base_log, pbs_level=p.pbs_level,
                  ks_base_log=p.ks_base_log, ks_level=p.ks_level)
    fields.update(over)
    return BooleanParameters(**fields)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_lwe_keys_and_encryptions_match_jax(kind, bits):
    kj = getattr(lwe_jax.LweSecretKey, f"generate_{kind}")(24, SecJax(1), bits)
    kt = getattr(lwe_t.LweSecretKey, f"generate_{kind}")(24, Sec(1), bits)
    assert (kt.kind, kt.bits) == (kj.kind, kj.bits) == (kind, bits)
    np.testing.assert_array_equal(kt.key, kj.key)
    msgs = np.arange(7, dtype=DT[bits]) << DT[bits](bits - 4)
    gj, gt = EncJax(2, 3), Enc(2, 3)
    for _ in range(2):                      # the second call reads on
        ct = kt.encrypt(msgs, 2.0 ** -20, gt)
        np.testing.assert_array_equal(ct, kj.encrypt(msgs, 2.0 ** -20, gj))
        np.testing.assert_array_equal(kt.decrypt(ct), kj.decrypt(ct))
    assert gt.noise.inner.state.gpos == gj.noise.inner.state.gpos


def _glwe_oracle(kj, msgs, std, gen):
    """concrete_tpu's randomness with a schoolbook product: its multisum
    takes no u64 Gaussian or uniform key (its CRT prime pool is too
    small), so the port is held to this there."""
    masks, noises = kj.draw_randomness(msgs.shape[0], std, gen)
    body = noises + msgs
    with np.errstate(over="ignore"):
        for j in range(kj.dimension):
            body += poly_jax.polymul_wrapping_naive(masks[:, j], kj.key[j][None])
    return np.concatenate([masks, body[:, None]], axis=1)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_glwe_keys_and_encryptions_match_jax(kind, bits):
    kj = getattr(glwe_jax.GlweSecretKey, f"generate_{kind}")(2, 16, SecJax(4), bits)
    kt = getattr(glwe_t.GlweSecretKey, f"generate_{kind}")(2, 16, Sec(4), bits)
    assert kt.kind == kind
    np.testing.assert_array_equal(kt.key, kj.key)
    big_t, big_j = kt.into_lwe_key(), kj.into_lwe_key()
    assert (big_t.kind, big_t.dimension) == (big_j.kind, big_j.dimension)
    msgs = (np.arange(3 * 16, dtype=DT[bits]) << DT[bits](bits - 8)).reshape(3, 16)
    ct = kt.encrypt(msgs, 2.0 ** -20, Enc(5, 6))
    if bits == 64 and kind in ("gaussian", "uniform"):
        np.testing.assert_array_equal(ct, _glwe_oracle(kj, msgs, 2.0 ** -20,
                                                       EncJax(5, 6)))
        half = DT[bits](1 << (bits - 9))
        np.testing.assert_array_equal((kt.decrypt(ct) + half) >> DT[bits](bits - 8),
                                      msgs >> DT[bits](bits - 8))
        return
    np.testing.assert_array_equal(ct, kj.encrypt(msgs, 2.0 ** -20, EncJax(5, 6)))
    np.testing.assert_array_equal(kt.decrypt(ct), kj.decrypt(ct))
    np.testing.assert_array_equal(kt.encrypt_zero((2,), 0.0, Enc(7, 8)),
                                  kj.encrypt_zero((2,), 0.0, EncJax(7, 8)))
    trivial = glwe_t.trivial_encrypt(msgs, 2, bits)
    np.testing.assert_array_equal(to_numpy(trivial),
                                  np.asarray(glwe_jax.trivial_encrypt(msgs, 2)))
    np.testing.assert_array_equal(kt.decrypt(trivial), msgs)
    np.testing.assert_array_equal(to_numpy(glwe_t.trivial_decrypt(trivial)), msgs)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_bit"])
def test_bootstrap_key_and_ggsw_match_jax(batched, bits):
    """Both forms of StandardBootstrapKey.generate, a ternary GLWE key
    included, and encrypt_constant_ggsw."""
    lj = lwe_jax.LweSecretKey.generate_binary(5, SecJax(1), bits)
    lt = lwe_t.LweSecretKey.generate_binary(5, Sec(1), bits)
    for kind in ("binary", "ternary"):
        kj = getattr(glwe_jax.GlweSecretKey, f"generate_{kind}")(2, 16, SecJax(2), bits)
        kt = getattr(glwe_t.GlweSecretKey, f"generate_{kind}")(2, 16, Sec(2), bits)
        gj, gt = EncJax(3, 4), Enc(3, 4)
        want = ggsw_jax.StandardBootstrapKey.generate(
            lj, kj, 4, 3, 2.0 ** -25, gj, batched=batched)
        got = ggsw_t.StandardBootstrapKey.generate(
            lt, kt, 4, 3, 2.0 ** -25, gt, batched=batched)
        np.testing.assert_array_equal(got.data, want.data)
        assert got.bits == bits
        assert gt.mask.inner.state.gpos == gj.mask.inner.state.gpos
        assert gt.noise.inner.state.gpos == gj.noise.inner.state.gpos
    np.testing.assert_array_equal(
        ggsw_t.encrypt_constant_ggsw(kt, 1, 4, 2, 2.0 ** -25, Enc(5, 6)),
        ggsw_jax.encrypt_constant_ggsw(kj, 1, 4, 2, 2.0 ** -25, EncJax(5, 6)))


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("base_log,level", [(8, 3), (11, 2), (2, 5)])
def test_ksk_and_keyswitch_match_jax(base_log, level, bits):
    """LweKeyswitchKey.generate, the general keyswitch at base_log > 7 and
    keyswitch_prepared (the limb path at base_log <= 7), against
    concrete_tpu's keyswitch."""
    sj, st = SecJax(5), Sec(5)
    in_j, in_t = (lwe_jax.LweSecretKey.generate_binary(40, sj, bits),
                  lwe_t.LweSecretKey.generate_binary(40, st, bits))
    out_j, out_t = (lwe_jax.LweSecretKey.generate_binary(12, sj, bits),
                    lwe_t.LweSecretKey.generate_binary(12, st, bits))
    std = 2.0 ** -(bits - 8)
    kj = lwe_jax.LweKeyswitchKey.generate(in_j, out_j, base_log, level, std,
                                          EncJax(6, 7))
    kt = lwe_t.LweKeyswitchKey.generate(in_t, out_t, base_log, level, std, Enc(6, 7))
    np.testing.assert_array_equal(kt.data, kj.data)
    msgs = np.arange(9, dtype=DT[bits]) << DT[bits](bits - 5)
    ct = in_t.encrypt(msgs, std, Enc(8, 9))
    want = np.asarray(lwe_jax.keyswitch(jnp.asarray(kj.data), jnp.asarray(ct),
                                        base_log=base_log, level_count=level))
    got = lwe_t.keyswitch(kt.data, from_numpy(ct), base_log=base_log,
                          level_count=level)
    np.testing.assert_array_equal(to_numpy(got), want)
    limbs = torch.from_numpy(lwe_t.ksk_to_limbs(kt.data))
    prepared = lwe_t.keyswitch_prepared(limbs, from_numpy(ct), base_log=base_log,
                                        level_count=level)
    np.testing.assert_array_equal(to_numpy(prepared), want)
    assert lwe_t.limbs_fit(base_log, limbs.shape[0]) == (base_log <= 7)


@pytest.mark.parametrize("bits", [32, 64])
def test_gsw_and_packing_match_jax(bits):
    sj, st = SecJax(3), Sec(3)
    kj, kt = (lwe_jax.LweSecretKey.generate_binary(8, sj, bits),
              lwe_t.LweSecretKey.generate_binary(8, st, bits))
    gkj, gkt = (glwe_jax.GlweSecretKey.generate_binary(2, 16, sj, bits),
                glwe_t.GlweSecretKey.generate_binary(2, 16, st, bits))
    std = 2.0 ** -(bits - 10)
    c0 = kt.encrypt(np.arange(5, dtype=DT[bits]) << DT[bits](bits - 4), std, Enc(6, 7))
    c1 = kt.encrypt(np.arange(5, dtype=DT[bits]) << DT[bits](bits - 3), std, Enc(8, 9))
    for bl, lv in ((8, 2), (5, 3)):
        g = gsw_t.encrypt_constant_gsw(kt, 1, bl, lv, std, Enc(4, 5))
        gj = gsw_jax.encrypt_constant_gsw(kj, 1, bl, lv, std, EncJax(4, 5))
        np.testing.assert_array_equal(g, gj)
        np.testing.assert_array_equal(
            to_numpy(gsw_t.cmux(g, c0, c1, base_log=bl, level_count=lv)),
            np.asarray(gsw_jax.cmux(jnp.asarray(gj), jnp.asarray(c0),
                                    jnp.asarray(c1), base_log=bl, level_count=lv)))
        pk = packing_t.PackingKeyswitchKey.generate(kt, gkt, bl, lv, std, Enc(2, 3))
        pkj = packing_jax.PackingKeyswitchKey.generate(kj, gkj, bl, lv, std,
                                                       EncJax(2, 3))
        np.testing.assert_array_equal(pk.data, pkj.data)
        np.testing.assert_array_equal(
            to_numpy(packing_t.packing_keyswitch(pk.data, c0, base_log=bl,
                                                 level_count=lv)),
            np.asarray(packing_jax.packing_keyswitch(
                jnp.asarray(pkj.data), jnp.asarray(c0), base_log=bl,
                level_count=lv)))
    with pytest.raises(ValueError):
        packing_t.packing_keyswitch(pk.data, np.zeros((17, 9), DT[bits]),
                                    base_log=8, level_count=2)


def test_checks_classes_and_call_sites():
    """The CoreError hierarchy of concrete_tpu, raised where it raises it:
    the general keyswitch and both blind rotations."""
    for name in ("LweDimensionMismatch", "GlweDimensionMismatch",
                 "PolynomialSizeMismatch", "KeyParameterMismatch",
                 "ShardingMismatch"):
        cls = getattr(checks, name)
        assert issubclass(cls, checks.CoreError) and issubclass(cls, ValueError)
        assert cls.__mro__[1].__name__ == getattr(checks_jax, name).__mro__[1].__name__
    with pytest.raises(checks.ShardingMismatch):
        checks.check_tp_divides("rows", 10, 4)
    with pytest.raises(checks.KeyParameterMismatch):
        lwe_t.keyswitch(np.zeros((4, 2, 5), np.uint32), torch.zeros(3, 6, dtype=torch.int32),
                        base_log=8, level_count=3)
    cfg = bs_t.ServerConfig(4, 1, 16, 7, 2, 2, 2)
    lut = torch.zeros(2, 16, dtype=torch.int32)
    rings = torch.zeros((4, bsx_t.MxuPlan.from_config(cfg).row_blocks, 2, 32),
                        dtype=torch.int32)
    with pytest.raises(checks.LweDimensionMismatch):
        bsx_t.blind_rotate_mxu(cfg, rings, lut, torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(checks.KeyParameterMismatch):
        bsx_t.blind_rotate_mxu(cfg, rings[:3], lut, torch.zeros(3, 5, dtype=torch.int32))
    spectra = torch.zeros((4, len(cfg.primes), 2, 2, 2, 16), dtype=torch.int32)
    with pytest.raises(checks.PolynomialSizeMismatch):
        bsntt_t.blind_rotate(cfg, spectra, lut[:, :8], torch.zeros(3, 5, dtype=torch.int32))
    with pytest.raises(checks.GlweDimensionMismatch):
        bsntt_t.blind_rotate(cfg, spectra, lut[:1], torch.zeros(3, 5, dtype=torch.int32))


@pytest.mark.parametrize("params,ks", [(TINY, None), (TINY_K2, None), (TINY, (8, 3))],
                         ids=["tiny", "tiny_k2", "tiny_ks8"])
def test_gen_keys_and_gates_match_jax(params, ks):
    """Equal seeds: the same client and server keys and ciphertexts, and a
    gate (a MUX, whose keyswitch is the general one at ks_base_log 8) that
    returns concrete_tpu's bytes; the big-key decryption of a bootstrap."""
    if ks:
        params = boolean_jax.BooleanParameters(
            **{**params.__dict__, "ks_base_log": ks[0], "ks_level": ks[1]})
    cks_j, sks_j = boolean_jax.gen_keys(params, secret_seed=1, mask_seed=2,
                                        noise_seed=3)
    cks_t, sks_t = boolean_t.gen_keys(_port_params(params), secret_seed=1,
                                      mask_seed=2, noise_seed=3, device="cpu")
    np.testing.assert_array_equal(cks_t.lwe_secret_key.key, cks_j.lwe_secret_key.key)
    np.testing.assert_array_equal(cks_t.glwe_secret_key.key,
                                  cks_j.glwe_secret_key.key)
    np.testing.assert_array_equal(sks_t.bsk_standard, sks_j.bsk_standard)
    np.testing.assert_array_equal(sks_t.ksk, np.asarray(sks_j.ksk))
    cts = [cks_t.encrypt(v, mask_seed=10 + i, noise_seed=20 + i)
           for i, v in enumerate(([True, False, True, False],
                                  [True, True, False, False],
                                  [False, True, True, False]))]
    for i, c in enumerate(cts):
        np.testing.assert_array_equal(
            c, cks_j.encrypt(cks_t.decrypt(c), mask_seed=10 + i, noise_seed=20 + i))
    if ks:
        got = sks_t.mux(*cts)
        want = sks_j.mux(*(jnp.asarray(c) for c in cts))
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        assert cks_t.decrypt(got).tolist() == [True, True, False, False]
        lut = sks_t.gate_keys()[2]
        pbs = bsntt_t.bootstrap(sks_t.cfg, sks_t.bsk_ntt, lut,
                                from_numpy(cts[0]))
        np.testing.assert_array_equal(cks_t.decrypt_big_key(pbs),
                                      cks_j.decrypt_big_key(to_numpy(pbs)))


def test_golden_key_material_and_gate_pipeline():
    """tests/test_golden.py's key-material and gate-pipeline digests,
    reproduced by the port alone."""
    sgen = Sec(42)
    lwe_sk = lwe_t.LweSecretKey.generate_binary(TINY.lwe_dimension, sgen)
    glwe_sk = glwe_t.GlweSecretKey.generate_binary(
        TINY.glwe_dimension, TINY.polynomial_size, sgen)
    bsk = ggsw_t.StandardBootstrapKey.generate(
        lwe_sk, glwe_sk, TINY.pbs_base_log, TINY.pbs_level,
        TINY.glwe_modular_std_dev.std_dev, Enc(43, 44))
    assert _h(lwe_sk.key) == "546e127fb90c3bb1"
    assert _h(glwe_sk.key) == "6e00998a0996dabf"
    assert _h(bsk.data) == "6a3eb86a403b3940"
    cks, sks = boolean_t.gen_keys(_port_params(TINY), secret_seed=7, mask_seed=8,
                                  noise_seed=9, device="cpu")
    a = cks.encrypt(np.array([True, False, True, False]), mask_seed=10, noise_seed=11)
    b = cks.encrypt(np.array([True, True, False, False]), mask_seed=12, noise_seed=13)
    assert _h(a) == "a351caf3068cea27"
    out = to_numpy(sks.and_(a, b))
    assert _h(out) == "af72029a4aef376d"
    assert list(cks.decrypt(out)) == [True, False, False, False]


def test_highlevel_keys_and_encryptions_match_jax():
    """LWESecretKey / RLWESecretKey / LWEBSK / LWEKSK.new and the LWE and
    VectorLWE encryptions from equal seeds; an LWEKSK at base_log 8 switches
    with the general keyswitch, equal to concrete_tpu's."""
    sk_j = hl_jax.LWESecretKey.new(hl_jax.LWEParams(10, -40), secret_seed=1)
    sk_t = hl_t.LWESecretKey.new(hl_t.LWEParams(10, -40), secret_seed=1)
    rsk_j = hl_jax.RLWESecretKey.new(hl_jax.RLWEParams(64, 1, -50), secret_seed=2)
    rsk_t = hl_t.RLWESecretKey.new(hl_t.RLWEParams(64, 1, -50), secret_seed=2)
    np.testing.assert_array_equal(sk_t.inner.key, sk_j.inner.key)
    np.testing.assert_array_equal(rsk_t.inner.key, rsk_j.inner.key)
    bsk_j = hl_jax.LWEBSK.new(sk_j, rsk_j, 7, 3, mask_seed=3, noise_seed=4)
    bsk_t = hl_t.LWEBSK.new(sk_t, rsk_t, 7, 3, mask_seed=3, noise_seed=4,
                            device="cpu")
    np.testing.assert_array_equal(bsk_t.coefficient_bsk, bsk_j.coefficient_bsk)
    for bl, lv in ((2, 8), (8, 5)):
        ksk_j = hl_jax.LWEKSK.new(rsk_j.to_lwe_secret_key(), sk_j, bl, lv,
                                  mask_seed=5, noise_seed=6)
        ksk_t = hl_t.LWEKSK.new(rsk_t.to_lwe_secret_key(), sk_t, bl, lv,
                                mask_seed=5, noise_seed=6, device="cpu")
        np.testing.assert_array_equal(ksk_t.inner.data, ksk_j.inner.data)
        big = hl_t.LWE.encrypt_raw(rsk_t.to_lwe_secret_key(),
                                   np.uint64(3 << 60), mask_seed=7, noise_seed=8)
        np.testing.assert_array_equal(
            to_numpy(ksk_t.run_keyswitch(big.data[None])),
            np.asarray(ksk_j.run_keyswitch(jnp.asarray(big.data[None]))))
    enc_args = (0.0, 7.0)
    enc_j = hl_jax.Encoder.new(*enc_args, nb_bit_precision=3, nb_bit_padding=1)
    enc_t = hl_t.Encoder.new(*enc_args, nb_bit_precision=3, nb_bit_padding=1)
    xs = [1.0, 5.0, 6.0]
    np.testing.assert_array_equal(
        hl_t.VectorLWE.encode_encrypt(sk_t, xs, enc_t, mask_seed=9, noise_seed=10).data,
        hl_jax.VectorLWE.encode_encrypt(sk_j, xs, enc_j, mask_seed=9,
                                        noise_seed=10).data)
    np.testing.assert_array_equal(
        hl_t.LWE.encode_encrypt(sk_t, 2.0, enc_t, mask_seed=11, noise_seed=12).data,
        hl_jax.LWE.encode_encrypt(sk_j, 2.0, enc_j, mask_seed=11, noise_seed=12).data)
