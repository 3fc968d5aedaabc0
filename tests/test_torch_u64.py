"""The port's u64 torus held bit for bit against concrete_tpu on the CPU:
the int64 carriers and torus numerics, the gadget decompositions, monomial
products and the keygen multisum, the u64 toeplitz ("mxu") bootstrap (key
conversion, the K1 table with two word planes, the K4 digit kernel's plain
version against the JAX Pallas kernel in interpret mode, the int64 limb
recombination, the blind rotation, PBS and multi-LUT PBS, exact and with
dropped limbs) and the u64 limb keyswitch. Tolerance 0 for every torus
value: all of it is integer arithmetic mod 2^64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu import torus as torus_jax
from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_mxu as bsx_jax
from concrete_tpu.core import lwe as lwe_jax
from concrete_tpu.math import decomposition as dec_jax
from concrete_tpu.math import polynomial as poly_jax
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import lwe as lwe_t
from concrete_tpu_torch.math import decomposition as dec_t
from concrete_tpu_torch.math import polynomial as poly_t

EDGES = [0, 1, 0xFFFF_FFFF, 0x1_0000_0000, 0x7FFF_FFFF_FFFF_FFFF,
         0x8000_0000_0000_0000, 0x8000_0000_0000_0001, 0xFFFF_FFFF_FFFF_FFFF,
         0xFFFF_FFFF_8000_0000, 0x0000_0000_8000_0000]
# (base_log, level): n_sub 1, 2, 3; prefixes 21 .. 64, including the
# non_rep == 32 edge (16, 2) and prefixes wider than 32 bits
DECOMPS = [(7, 3), (10, 3), (16, 2), (16, 3), (2, 8), (4, 7), (16, 4),
           (31, 2)]


def _u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def _values(seed, n=512):
    x = _u64(np.random.default_rng(seed), n)
    x[:len(EDGES)] = EDGES
    return x


def _t(x):
    return torus.from_numpy(x)


def _cfgs(n=6, k=1, N=64, bl=7, l=3, drop=0, ks_bl=2, ks_l=8):
    kw = dict(lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
              pbs_base_log=bl, pbs_level=l, ks_base_log=ks_bl, ks_level=ks_l,
              bits=64, mxu_limb_drop=drop)
    return bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)


def _plan(ks1, n, bl, l, drop=0):
    return bsx_t.MxuPlan.from_config(bs_t.ServerConfig(
        lwe_dimension=6, glwe_dimension=ks1 - 1, polynomial_size=n,
        pbs_base_log=bl, pbs_level=l, ks_base_log=2, ks_level=8, bits=64,
        mxu_limb_drop=drop))


# -- torus --------------------------------------------------------------------


def test_carriers_roundtrip_and_shift():
    x = _values(1)
    t = _t(x)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(torus.to_numpy(t), x)
    for s in (0, 1, 31, 32, 33, 63, 64):
        np.testing.assert_array_equal(
            torus.to_numpy(torus.lshr(t, s)),
            x >> np.uint64(s) if s < 64 else np.zeros_like(x))
    assert torus.i64(1 << 63) == -(1 << 63)
    assert torus.i64((1 << 64) - 1) == -1


def test_from_and_into_torus_f64_match_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0.0, 1.0, 500), rng.uniform(-3, 3, 500),
                        [0.0, 0.5, -0.5, 1.0 - 2.0 ** -60, 2.0 ** -64, -1e-30]])
    with np.errstate(invalid="ignore"):
        for bits in (32, 64):
            got = torus.from_torus_f64(x, bits)
            want = torus_jax.from_torus_f64(x, bits)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    t = _values(3)
    np.testing.assert_array_equal(torus.into_torus_f64(t, 64),
                                  torus_jax.into_torus_f64(t, 64))


def test_encryption_random_is_u64():
    """u64 masks and noise from the port's streams, equal to concrete_tpu's."""
    from concrete_tpu.csprng import EncryptionRandomGenerator as GenJax
    from concrete_tpu_torch.csprng import EncryptionRandomGenerator

    gen, gen_j = EncryptionRandomGenerator(4, 5), GenJax(4, 5)
    mask, noise = gen.fill_mask(12, 64), gen.fill_noise(7, 2.0 ** -30, 64)
    assert mask.dtype == noise.dtype == np.uint64
    np.testing.assert_array_equal(mask, gen_j.fill_mask(12, 64))
    np.testing.assert_array_equal(noise, gen_j.fill_noise(7, 2.0 ** -30, 64))


# -- decomposition ---------------------------------------------------------------


@pytest.mark.parametrize("base_log,levels", DECOMPS)
def test_decompositions_match_jax(base_log, levels):
    x = _values(base_log * levels)
    xj = jnp.asarray(x)
    rounded = dec_jax.closest_representable(xj, base_log, levels)
    np.testing.assert_array_equal(
        torus.to_numpy(dec_t.closest_representable(_t(x), base_log, levels)),
        np.asarray(rounded))
    r = np.asarray(rounded)
    got = dec_t.decompose_levels(_t(r), base_log, levels)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(dec_jax.decompose_levels(rounded, base_log, levels)))
    np.testing.assert_array_equal(
        dec_t.decompose_rounded(_t(x), base_log, levels).numpy(),
        np.asarray(dec_jax.decompose_rounded(xj, base_log, levels)))
    np.testing.assert_array_equal(
        dec_t.small_sign_decompose(_t(r), base_log, levels).numpy(),
        np.asarray(dec_jax.small_sign_decompose(rounded, base_log, levels)))
    digits = dec_jax.decompose_levels(rounded, base_log, levels)
    np.testing.assert_array_equal(
        torus.to_numpy(dec_t.recompose(torch.from_numpy(np.array(digits)),
                                       base_log, levels)),
        np.asarray(dec_jax.recompose(digits, base_log, levels, jnp.uint64)))


# -- polynomials -------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 256])
def test_monomial_mul_div_match_jax(n):
    rng = np.random.default_rng(n)
    poly = _u64(rng, (3, 5, n))
    poly[0, 0, :len(EDGES)] = EDGES
    deg = np.concatenate([rng.integers(0, 2 * n, size=1),
                          [0, n, 2 * n - 1, 2 * n]]).astype(np.int64)
    for fj, ft in ((poly_jax.negacyclic_monomial_mul, poly_t.negacyclic_monomial_mul),
                   (poly_jax.negacyclic_monomial_div, poly_t.negacyclic_monomial_div)):
        want = np.asarray(fj(jnp.asarray(poly), jnp.asarray(deg)[None, :]))
        got = ft(_t(poly), torch.from_numpy(deg)[None, :])
        np.testing.assert_array_equal(torus.to_numpy(got), want)


@pytest.mark.parametrize("k,n", [(1, 64), (2, 256)])
def test_keygen_multisum_matches_jax(k, n):
    rng = np.random.default_rng(k * n)
    masks = _u64(rng, (4, 3, k, n))
    masks[0, 0, 0, :len(EDGES)] = EDGES
    key = rng.integers(0, 2, size=(k, n), dtype=np.uint64)
    want = np.asarray(poly_jax.multisum_negacyclic(
        jnp.asarray(masks), jnp.asarray(key), 64, small_max=1))
    got = poly_t.negacyclic_multisum(_t(masks), _t(key))
    np.testing.assert_array_equal(torus.to_numpy(got), want)


# -- configuration -------------------------------------------------------------------


def test_server_config_fast_mode_matches_jax():
    cj, ct = _cfgs(N=256, bl=7, l=3)
    for kw in ({}, {"limb_drop": 2}, {"limb_drop": 6, "levels": 2},
               {"limb_drop": 0, "levels": 1}):
        fj, ft = cj.with_fast_mode(**kw), ct.with_fast_mode(**kw)
        for f in dataclasses.fields(bs_t.ServerConfig):
            assert getattr(ft, f.name) == getattr(fj, f.name), (kw, f.name)
    for bad in ({"limb_drop": 7}, {"levels": 4}, {"levels": 0}):
        with pytest.raises(ValueError):
            cj.with_fast_mode(**bad)
        with pytest.raises(ValueError):
            ct.with_fast_mode(**bad)
    with pytest.raises(ValueError):
        bs_t.ServerConfig(4, 1, 64, 7, 2, 2, 5, bits=32, mxu_limb_drop=3)


def test_plan_matches_jax():
    for drop in (0, 2, 6):
        for bl, l in [(7, 3), (10, 3), (16, 3)]:
            cj, ct = _cfgs(N=1024, bl=bl, l=l, drop=drop)
            pj, pt = bsx_jax.MxuPlan.from_config(cj), bsx_t.MxuPlan.from_config(ct)
            assert (pt.row_blocks, pt.n_sub, pt.n_words, pt.n_limbs,
                    pt.limbs_used, pt.limb_drop, pt.bits) == \
                (pj.row_blocks, pj.n_sub, pj.n_words, pj.n_limbs,
                 pj.limbs_used, pj.limb_drop, pj.bits)
    with pytest.raises(NotImplementedError):
        bsx_t.MxuPlan.from_config(_cfgs(bl=20, l=4)[1])   # 80 prefix bits


def test_modulus_switch_and_sample_extract_u64_match_jax():
    rng = np.random.default_rng(19)
    x = _u64(rng, (64, 17))
    x[0, :len(EDGES)] = EDGES[:17]
    for n, off, lcl in [(64, 0, 0), (1024, 0, 1), (1024, 1, 2)]:
        want = np.asarray(bs_jax.pbs_modulus_switch(jnp.asarray(x), n, off, lcl))
        got = bs_t.pbs_modulus_switch(_t(x), n, off, lcl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    glwe = _u64(rng, (2, 5, 3, 64))
    np.testing.assert_array_equal(
        torus.to_numpy(bs_t.sample_extract(_t(glwe))),
        np.asarray(bs_jax.sample_extract(jnp.asarray(glwe))))
    np.testing.assert_array_equal(
        torus.to_numpy(bs_t.sample_extract_nth(_t(glwe), 5)),
        np.asarray(bs_jax.sample_extract_nth(jnp.asarray(glwe), 5)))
    cj, ct = _cfgs()
    value = np.uint64(1) << np.uint64(60)
    np.testing.assert_array_equal(
        torus.to_numpy(bs_t.trivial_lut_constant(ct, value)),
        np.asarray(bs_jax.trivial_lut_constant(cj, value)))


# -- the u64 toeplitz bootstrap ----------------------------------------------------------


@pytest.mark.parametrize("bl,l,drop", [(7, 3, 0), (10, 3, 2), (16, 2, 0)])
def test_bsk_to_mxu_u64_matches_jax(bl, l, drop):
    cj, ct = _cfgs(n=3, k=2, bl=bl, l=l, drop=drop)
    bsk = _u64(np.random.default_rng(bl), (3, l, 3, 3, 64))
    bsk[0, 0, 0, 0, :len(EDGES)] = EDGES
    got = bsx_t.bsk_to_mxu(bsk, ct)
    assert got.dtype == np.uint32 and got.shape[2] == 6
    np.testing.assert_array_equal(got, bsx_jax.bsk_to_mxu(bsk, cj))


@pytest.mark.parametrize("drop", range(7))
@pytest.mark.parametrize("r_blocks,ks1,n", [(6, 2, 64), (3, 3, 256)])
def test_build_tables_plain_u64_matches_jax(r_blocks, ks1, n, drop):
    rng = np.random.default_rng(r_blocks * n + drop)
    rings = rng.integers(0, 1 << 32, size=(r_blocks, 2 * ks1, 2 * n),
                         dtype=np.uint32)
    want = np.asarray(bsx_jax._build_tables_jnp(jnp.asarray(rings), n, 2, drop))
    got = bsx_t.build_tables_plain(_t(rings), n, drop, 2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(bsx_t.build_tables(_t(rings), n, drop, 2).numpy(),
                                  want)


def _adversarial_acc(rng, ks1, b, n):
    acc = _u64(rng, (ks1, b, n))
    acc[0, 0, :4] = [0, 1, 0xFFFF_FFFF, 0x1_0000_0000]
    acc[0, 1, :4] = [0xFFFF_FFFF_FFFF_FFFF, 0x8000_0000,
                     0x7FFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0000]
    return acc


def _degrees(rng, n, b):
    return np.concatenate([rng.integers(0, 2 * n, size=b - 4),
                           [0, n, 2 * n - 1, 2 * n]]).astype(np.int32)


@pytest.mark.parametrize("ks1,n,bl,l", [(3, 64, 7, 3), (2, 128, 10, 3),
                                        (2, 64, 16, 2)])
def test_rotdig64_plain_matches_pallas64(ks1, n, bl, l):
    """The three cases of the JAX u64 kernel test, with its word-boundary
    rows, against the Pallas kernel run in interpret mode."""
    plan = _plan(ks1, n, bl, l)
    rng = np.random.default_rng(31)
    b = 16
    acc = _adversarial_acc(rng, ks1, b, n)
    a_hat = _degrees(rng, n, b)
    planes = bsx_jax._acc_u64_to_planes(jnp.asarray(acc))
    with jax.enable_x64(False):
        kern = bsx_jax._rotdig_pallas64(ks1, n, b, bl, l, plan.n_sub,
                                        interpret=True)
        want = np.asarray(kern(planes, jnp.asarray(a_hat)[:, None]))
    got = bsx_t.rotdig64_plain(plan, _t(acc), torch.from_numpy(a_hat))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ks1,n,bl,l", [(2, 64, 7, 3), (2, 256, 16, 3),
                                        (3, 64, 16, 4), (2, 64, 31, 2),
                                        (2, 64, 1, 1), (2, 64, 11, 3),
                                        (2, 64, 10, 4)])
def test_rotdig64_plain_matches_jax_digit_matrix(ks1, n, bl, l):
    """Prefixes beyond the TPU kernel's 32 bits, up to 64, against the JAX
    XLA form (negacyclic_monomial_mul + _digit_matrix); 33 and 40 bits are
    the shapes where K4 runs one level on its 64-bit state before the
    32-bit one."""
    plan = _plan(ks1, n, bl, l)
    plan_j = bsx_jax.MxuPlan(lwe_dimension=6, glwe_size=ks1, polynomial_size=n,
                             base_log=bl, level=l, n_sub=plan.n_sub,
                             ks_base_log=2, ks_level=8, bits=64)
    rng = np.random.default_rng(37 + bl)
    b = 12
    acc = _adversarial_acc(rng, ks1, b, n)
    a_hat = _degrees(rng, n, b)
    rot = poly_jax.negacyclic_monomial_mul(jnp.asarray(acc),
                                           jnp.asarray(a_hat)[None, :])
    want = np.asarray(bsx_jax._digit_matrix(plan_j, rot - jnp.asarray(acc)))
    acc_t, a_t = _t(acc), torch.from_numpy(a_hat)
    np.testing.assert_array_equal(bsx_t.rotdig64_plain(plan, acc_t, a_t).numpy(),
                                  want)
    bsx_t.reset_launch_counts()
    np.testing.assert_array_equal(bsx_t.rotdig64(plan, acc_t, a_t).numpy(), want)
    assert bsx_t.launch_counts()["rotdig64"] == 0      # plain version on CPU
    with pytest.raises(TypeError):
        bsx_t.rotdig64(plan, acc_t.to(torch.int32), a_t)
    with pytest.raises(TypeError):
        bsx_t.rotdig(plan, acc_t, a_t)


@pytest.mark.parametrize("drop", [0, 2, 5])
def test_recombine_limb_planes_int64_matches_jax(drop):
    plan = _plan(3, 64, 7, 2, drop)
    plan_j = bsx_jax.MxuPlan.from_config(_cfgs(k=2, bl=7, l=2, drop=drop)[0])
    rng = np.random.default_rng(29)
    s = rng.integers(-(1 << 31), 1 << 31,
                     size=(16, 3 * plan.limbs_used * 64)).astype(np.int32)
    s[0, :] = 2 ** 31 - 1
    s[1, :] = -(2 ** 31)
    s[2, ::2], s[2, 1::2] = 2 ** 31 - 1, -(2 ** 31)
    want = np.asarray(bsx_jax.recombine_limb_planes(plan_j, jnp.asarray(s)))
    got = bsx_t.recombine_limb_planes(plan, torch.from_numpy(s))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def _rotation_inputs(cj, ct, seed, b):
    rng = np.random.default_rng(seed)
    bsk = _u64(rng, (ct.lwe_dimension, ct.pbs_level, ct.glwe_size,
                     ct.glwe_size, ct.polynomial_size))
    rings = bsx_jax.bsk_to_mxu(bsk, cj)
    lwe = _u64(rng, (b, ct.lwe_dimension + 1))
    lwe[0, :] = 0xFFFF_FFFF_FFFF_FFFF               # degrees of exactly 2N
    lut = _u64(rng, (ct.glwe_size, ct.polynomial_size))
    return rings, lut, lwe


@pytest.mark.parametrize("k,N,bl,l,drop", [(1, 64, 7, 3, 0), (1, 64, 7, 3, 2),
                                           (2, 64, 10, 3, 0), (1, 256, 16, 3, 3),
                                           (2, 64, 7, 2, 6)])
def test_u64_blind_rotate_and_bootstrap_match_jax(k, N, bl, l, drop):
    cj, ct = _cfgs(n=6, k=k, N=N, bl=bl, l=l, drop=drop)
    rings, lut, lwe = _rotation_inputs(cj, ct, bl + drop, 6)
    rj, lj, wj = jnp.asarray(rings), jnp.asarray(lut), jnp.asarray(lwe)
    want = np.asarray(bsx_jax.blind_rotate_mxu(cj, rj, lj, wj))
    got = bsx_t.blind_rotate_mxu(ct, _t(rings), _t(lut), _t(lwe))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    np.testing.assert_array_equal(
        torus.to_numpy(bsx_t.bootstrap_mxu(ct, _t(rings), _t(lut), _t(lwe))),
        np.asarray(bsx_jax.bootstrap_mxu(cj, rj, lj, wj)))


@pytest.mark.parametrize("drop", [0, 2])
def test_u64_many_lut_bootstrap_matches_jax(drop):
    cj, ct = _cfgs(n=5, k=1, N=64, bl=7, l=3, drop=drop)
    rings, lut, lwe = _rotation_inputs(cj, ct, 41, 4)
    want = np.asarray(bsx_jax.bootstrap_many_lut_mxu(
        cj, jnp.asarray(rings), jnp.asarray(lut), jnp.asarray(lwe), 2))
    got = bsx_t.bootstrap_many_lut_mxu(ct, _t(rings), _t(lut), _t(lwe), 2)
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def test_u64_blind_rotate_refuses_u32_inputs():
    cj, ct = _cfgs()
    rings, lut, lwe = _rotation_inputs(cj, ct, 3, 2)
    with pytest.raises(TypeError):
        bsx_t.blind_rotate_mxu(ct, _t(rings), _t(lut).to(torch.int32),
                               _t(lwe).to(torch.int32))


# -- the u64 limb keyswitch ----------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out,bl,l", [(64, 17, 2, 8), (128, 31, 4, 7),
                                             (256, 32, 7, 3)])
def test_u64_keyswitch_limbs_matches_jax(n_in, n_out, bl, l):
    rng = np.random.default_rng(n_in + bl)
    ksk = _u64(rng, (n_in, l, n_out + 1))
    ksk[0, 0, :4] = [0, 0x7F7F7F7F7F7F7F7F, 0x8080808080808080,
                     0xFFFF_FFFF_FFFF_FFFF]
    ct = _u64(rng, (2, 5, n_in + 1))
    ct[0, 0, :len(EDGES)] = EDGES
    ksk8 = lwe_t.ksk_to_limbs(ksk)
    np.testing.assert_array_equal(ksk8, lwe_jax.ksk_to_limbs(ksk))
    assert ksk8.shape == (n_in * l, 8 * (n_out + 1))
    want = np.asarray(lwe_jax.keyswitch(jnp.asarray(ksk), jnp.asarray(ct),
                                        base_log=bl, level_count=l))
    got = lwe_t.keyswitch_limbs(torch.from_numpy(ksk8), _t(ct), base_log=bl,
                                level_count=l)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def test_u64_keys_decrypt_their_own_ciphertexts():
    """Port keygen on the u64 torus: an LWE and a keyswitch round trip, and
    a GLWE key's big LWE key decrypting a sample-extracted trivial GLWE."""
    from concrete_tpu_torch.core.glwe import GlweSecretKey
    from concrete_tpu_torch.csprng import (EncryptionRandomGenerator,
                                           SecretRandomGenerator)

    rng = SecretRandomGenerator(5)
    k_in = lwe_t.LweSecretKey.generate_binary(64, rng, 64)
    k_out = lwe_t.LweSecretKey.generate_binary(24, rng, 64)
    rand = EncryptionRandomGenerator(6, 7)
    msgs = (np.arange(8, dtype=np.uint64) << np.uint64(60))
    ct = k_in.encrypt(msgs, 2.0 ** -50, rand)
    assert ct.dtype == np.uint64
    err = (k_in.decrypt(ct) - msgs).astype(np.int64)
    assert np.abs(err).max() < 1 << 20
    ksk = lwe_t.LweKeyswitchKey.generate(k_in, k_out, 4, 7, 2.0 ** -50, rand)
    out = lwe_t.keyswitch_limbs(torch.from_numpy(lwe_t.ksk_to_limbs(ksk.data)),
                                _t(ct), base_log=4, level_count=7)
    err = (k_out.decrypt(torus.to_numpy(out)) - msgs).astype(np.int64)
    assert np.abs(err).max() < 1 << 40
    gsk = GlweSecretKey.generate_binary(2, 64, rng, 64)
    masks = rand.fill_mask(3 * 2 * 64, 64).reshape(3, 2, 64)
    body = np.zeros((3, 64), np.uint64)
    glwe = gsk.encrypt_from_randomness(masks, body, body + msgs[:3, None])
    lwe = torus.to_numpy(bs_t.sample_extract(_t(glwe)))
    np.testing.assert_array_equal(gsk.into_lwe_key().decrypt(lwe), msgs[:3])
