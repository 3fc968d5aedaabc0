"""The port's exact-NTT ("ntt") backend, held against concrete_tpu on the CPU
with tolerance 0 (integer arithmetic mod p, 2^32 and 2^64): Montgomery
arithmetic, the transform plans and stacked transforms, the CRT residues
and Garner reconstruction, ServerConfig.primes, the key conversion, the
external product, CMux, blind rotation and PBS on both tori, the boolean
gates and the high-level key on backend="ntt", and the choice of backend.
K9's plain version against the Pallas kernel is in test_torch_fused_cmux.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu import boolean as boolean_jax
from concrete_tpu import highlevel as hl_jax
from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import ggsw as ggsw_jax
from concrete_tpu.math import crt as crt_jax
from concrete_tpu.math import mod_arith as ma_jax
from concrete_tpu.math import ntt as ntt_jax
from concrete_tpu.params import (
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import backends as backends_t
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_ntt as bsntt_t
from concrete_tpu_torch.core import bootstrap_nuss as bsn_t
from concrete_tpu_torch.core import ggsw as ggsw_t
from concrete_tpu_torch.math import crt as crt_t
from concrete_tpu_torch.math import mod_arith as ma_t
from concrete_tpu_torch.math import ntt as ntt_t

from common import TINY

UNSIGNED = {32: np.uint32, 64: np.uint64}
EDGES = {32: [0, 1, 0x7FFF_FFFF, 0x8000_0000, 0xFFFF_FFFF],
         64: [0, 1, 0xFFFF_FFFF, 0x1_0000_0000, 0x7FFF_FFFF_FFFF_FFFF,
              0x8000_0000_0000_0000, 0xFFFF_FFFF_FFFF_FFFF]}


def _rand(rng, shape, bits):
    dt = UNSIGNED[bits]
    x = rng.integers(0, np.iinfo(dt).max, size=shape, dtype=dt, endpoint=True)
    flat = x.reshape(-1)
    flat[:len(EDGES[bits])] = EDGES[bits][:flat.size]
    return x


def _residues(rng, primes, shape):
    return np.stack([rng.integers(0, p, size=shape, dtype=np.uint32)
                     for p in primes])


def _i64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _cfgs(n, k, N, bl, lv, bits=32, ks_bl=4, ks_l=3):
    kw = dict(lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
              pbs_base_log=bl, pbs_level=lv, ks_base_log=ks_bl, ks_level=ks_l,
              bits=bits)
    return bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)


# -- Montgomery arithmetic, plans, transforms -----------------------------------------


@pytest.mark.parametrize("p", ntt_jax.DEFAULT_PRIMES)
def test_montgomery_ops_match_jax(p):
    cj, ct = ma_jax.MontgomeryContext.new(p), ma_t.MontgomeryContext.new(p)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    rng = np.random.default_rng(p % 1000)
    a, b = (rng.integers(0, p, size=2000, dtype=np.uint32) for _ in range(2))
    a[:4], b[:4] = [0, 1, p - 1, p - 1], [p - 1, 0, p - 1, 1]
    ta, tb = _i64(a), _i64(b)
    for fj, ft in ((cj.mont_mul, ct.mont_mul), (cj.add, ct.add),
                   (cj.sub, ct.sub)):
        np.testing.assert_array_equal(ft(ta, tb).numpy(),
                                      np.asarray(fj(jnp.asarray(a), jnp.asarray(b))))
    for fj, ft in ((cj.to_mont, ct.to_mont), (cj.from_mont, ct.from_mont),
                   (cj.neg, ct.neg)):
        np.testing.assert_array_equal(ft(ta).numpy(), np.asarray(fj(jnp.asarray(a))))
    assert ct.root_of_unity(1 << 12) == cj.root_of_unity(1 << 12)
    assert ct.pow_mod_host(12345, 678) == cj.pow_mod_host(12345, 678)
    assert ma_t._find_generator(p) == ma_jax._find_generator(p)
    assert [ma_t._is_prime(v) for v in (p, p + 2, 1, 2, 561, 7919)] == \
        [ma_jax._is_prime(v) for v in (p, p + 2, 1, 2, 561, 7919)]


@pytest.mark.parametrize("n", [8, 64, 256])
def test_plan_tables_match_jax(n):
    for p in ntt_jax.DEFAULT_PRIMES:
        pj, pt = ntt_jax.make_plan(n, p), ntt_t.make_plan(n, p)
        assert pt.n == pj.n and pt.ctx == ma_t.MontgomeryContext.new(p)
        np.testing.assert_array_equal(pt.twist_fwd, pj.twist_fwd)
        np.testing.assert_array_equal(pt.untwist_inv, pj.untwist_inv)
        assert len(pt.w_fwd) == len(pj.w_fwd) == n.bit_length() - 1
        for a, b in zip(pt.w_fwd + pt.w_inv, pj.w_fwd + pj.w_inv):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", [2, 3])
def test_stacked_transforms_match_jax(P):
    primes = ntt_jax.DEFAULT_PRIMES[:P]
    rng = np.random.default_rng(P)
    n = 64
    x = _residues(rng, primes, (3, 5, n))
    spj, spt = ntt_jax.make_stacked_plans(n, primes), ntt_t.make_stacked_plans(n, primes)
    want = np.asarray(jax.jit(functools.partial(ntt_jax.forward_stacked, spj))(x))
    got = ntt_t.forward_stacked(spt, _i64(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ntt_t.inverse_stacked(spt, got).numpy(),
        np.asarray(jax.jit(functools.partial(ntt_jax.inverse_stacked, spj))(want)))
    np.testing.assert_array_equal(ntt_t.inverse_stacked(spt, got).numpy(), x)
    plan_j, plan_t = ntt_jax.make_plan(n, primes[-1]), ntt_t.make_plan(n, primes[-1])
    a, b = x[-1, 0], x[-1, 1]
    np.testing.assert_array_equal(
        ntt_t.negacyclic_polymul_mod_p(plan_t, _i64(a), _i64(b)).numpy(),
        np.asarray(jax.jit(functools.partial(ntt_jax.negacyclic_polymul_mod_p,
                                             plan_j))(a, b)))
    assert torch.equal(ntt_t.inverse(plan_t, ntt_t.forward(plan_t, _i64(a))),
                       _i64(a))


# -- CRT ---------------------------------------------------------------------------------------


def test_select_primes_and_crt_context_match_jax():
    for bound in (1, 2 ** 40, 2 ** 61, 2 ** 62 + 5, 2 ** 90, 2 ** 118):
        assert crt_t.select_primes(bound) == crt_jax.select_primes(bound)
    with pytest.raises(ValueError):
        crt_t.select_primes(2 ** 125)
    for args in [(256, 10, 128, 32), (1024, 6, 128, 64), (64, 4, 2 ** 16, 64)]:
        assert crt_t.external_product_bound(*args) == \
            crt_jax.external_product_bound(*args)
    for P in (1, 2, 3, 4):
        for bits in (32, 64):
            primes = ntt_jax.DEFAULT_PRIMES[:P]
            assert dataclasses.asdict(crt_t.CrtContext.new(primes, bits)) == \
                dataclasses.asdict(crt_jax.CrtContext.new(primes, bits))


@pytest.mark.parametrize("bits", [32, 64])
def test_residues_and_combine_match_jax(bits):
    rng = np.random.default_rng(bits)
    for P in (2, 3, 4):
        primes = ntt_jax.DEFAULT_PRIMES[:P]
        cj, ct = crt_jax.CrtContext.new(primes, bits), crt_t.CrtContext.new(primes, bits)
        x = _rand(rng, 3000, bits)
        for got, want in zip(ct.residues_from_torus(torus.from_numpy(x)),
                             cj.residues_from_torus(jnp.asarray(x))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        d = rng.integers(-(1 << 20), 1 << 20, size=500).astype(np.int32)
        for got, want in zip(ct.residues_from_signed(torch.from_numpy(d)),
                             cj.residues_from_signed(jnp.asarray(d))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        res = _residues(rng, primes, 3000)
        got = ct.combine_to_torus([_i64(r) for r in res])
        assert got.dtype == torus.carrier(bits)
        np.testing.assert_array_equal(
            torus.to_numpy(got),
            np.asarray(cj.combine_to_torus([jnp.asarray(r) for r in res])))
        if bits == 32 or P >= 3:     # M > 2^bits: a value's residues give it back
            back = ct.combine_to_torus(ct.residues_from_torus(torus.from_numpy(x)))
            np.testing.assert_array_equal(torus.to_numpy(back), x)


# -- configuration -------------------------------------------------------------------------------


def test_server_config_primes_match_jax():
    for p in (TPU128_PARAMETERS, DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS):
        cj = bs_jax.ServerConfig.from_boolean_parameters(p)
        ct = bs_t.ServerConfig.from_boolean_parameters(p)
        assert ct.primes == cj.primes and len(ct.primes) == 2
        assert ct.with_fast_mode(levels=2).primes == cj.with_fast_mode(levels=2).primes
        assert ct.crt_context == crt_t.CrtContext.new(cj.primes, 32)
        np.testing.assert_array_equal(ct.plan(ct.primes[0]).w_fwd[0],
                                      cj.plan(cj.primes[0]).w_fwd[0])
    fast_j = bs_jax.ServerConfig.from_boolean_parameters(
        TFHE_LIB_PARAMETERS).with_fast_mode(limb_drop=0, levels=2)
    fast_t = bs_t.ServerConfig.from_boolean_parameters(
        TFHE_LIB_PARAMETERS).with_fast_mode(limb_drop=0, levels=2)
    assert fast_t.primes == fast_j.primes
    int4_j, int4_t = _cfgs(630, 1, 1024, 7, 3, 64, 2, 8)
    assert int4_t.primes == int4_j.primes and len(int4_t.primes) == 3
    # the primes follow the fields they derive from: a u32 configuration
    # made u64 by dataclasses.replace carries the u64 primes
    int4_as_u32 = dataclasses.replace(int4_t, bits=32)
    assert int4_as_u32.primes == _cfgs(630, 1, 1024, 7, 3, 32, 2, 8)[0].primes
    assert dataclasses.replace(int4_as_u32, bits=64).primes == int4_j.primes
    # outside the ntt envelope: concrete_tpu refuses the configuration, the
    # port keeps it for its other backends and refuses it on ntt
    with pytest.raises(NotImplementedError):
        bs_jax.ServerConfig(4, 1, 64, 31, 2, 2, 8, bits=64)
    wide = bs_t.ServerConfig(4, 1, 64, 31, 2, 2, 8, bits=64)
    assert bsx_t.MxuPlan.from_config(wide).bits == 64
    with pytest.raises(NotImplementedError):
        wide.primes  # noqa: B018


@pytest.mark.parametrize("bits", [32, 64])
def test_bsk_to_ntt_matches_jax(bits):
    cj, ct = _cfgs(3, 2, 64, 7, 2, bits)
    bsk = _rand(np.random.default_rng(bits + 1), (3, 2, 3, 3, 64), bits)
    want = np.asarray(ggsw_jax.bsk_to_ntt(bsk, cj.primes, bits))
    got = ggsw_t.bsk_to_ntt(bsk, ct.primes, bits)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        ggsw_t.ggsw_to_ntt(torus.from_numpy(bsk[1]), ct.primes, bits).numpy(),
        np.asarray(ggsw_jax.ggsw_to_ntt(bsk[1], cj.primes, bits)))


# -- external product, blind rotation, bootstrap ---------------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("k", [1, 2])
def test_external_product_and_cmux_match_jax(k, bits):
    cj, ct = _cfgs(2, k, 64, 7, 2, bits)
    rng = np.random.default_rng(10 * k + bits)
    bsk = _rand(rng, (2, 2, k + 1, k + 1, 64), bits)
    g_j = ggsw_jax.bsk_to_ntt(bsk, cj.primes, bits)
    g_t = ggsw_t.bsk_to_ntt(bsk, ct.primes, bits)
    ct0, ct1 = _rand(rng, (5, k + 1, 64), bits), _rand(rng, (5, k + 1, 64), bits)
    cmux_j = jax.jit(functools.partial(bs_jax.cmux, cj))
    np.testing.assert_array_equal(
        torus.to_numpy(bsntt_t.external_product(ct, g_t[0], torus.from_numpy(ct1))),
        np.asarray(cmux_j(g_j[0], jnp.zeros_like(ct1), ct1)))
    np.testing.assert_array_equal(
        torus.to_numpy(bsntt_t.cmux(ct, g_t[1], torus.from_numpy(ct0),
                                    torus.from_numpy(ct1))),
        np.asarray(cmux_j(g_j[1], ct0, ct1)))


def _rotation_inputs(bits, n, k, N, lv, seed, b=4):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (n, lv, k + 1, k + 1, N), bits),
            _rand(rng, (k + 1, N), bits), _rand(rng, (b, n + 1), bits))


@pytest.mark.parametrize("bits,n,k,N,bl,lv", [
    (32, 6, 1, 64, 7, 2), (32, 4, 2, 128, 8, 2), (64, 4, 1, 64, 7, 3),
    (64, 3, 2, 128, 10, 2)])
def test_blind_rotate_and_bootstrap_match_jax_and_mxu(bits, n, k, N, bl, lv):
    """The port's ntt path equals the JAX ntt path and the port's own mxu
    path; on the u32 torus (two primes) each step went through ntt_cmux,
    which on the CPU runs its plain version."""
    cj, ct = _cfgs(n, k, N, bl, lv, bits)
    assert bsntt_t.kernel_applies(ct) == (bits == 32)
    bsk, lut, lwe = _rotation_inputs(bits, n, k, N, lv, 3 + bits + N)
    g_j = ggsw_jax.bsk_to_ntt(bsk, cj.primes, bits)
    g_t = ggsw_t.bsk_to_ntt(bsk, ct.primes, bits)
    lj, wj = jnp.asarray(lut), jnp.asarray(lwe)
    lt, wt = torus.from_numpy(lut), torus.from_numpy(lwe)
    bsntt_t.reset_launch_counts()
    got = bsntt_t.blind_rotate(ct, g_t, lt, wt)
    assert bsntt_t.ntt_cmux.launches == 0
    np.testing.assert_array_equal(
        torus.to_numpy(got), np.asarray(bs_jax.blind_rotate(cj, g_j, lj, wj)))
    mxu = bsx_t.blind_rotate_mxu(ct, torus.from_numpy(bsx_t.bsk_to_mxu(bsk, ct)),
                                 lt, wt)
    assert torch.equal(got, mxu)
    np.testing.assert_array_equal(
        torus.to_numpy(bsntt_t.bootstrap(ct, g_t, lt, wt)),
        np.asarray(bs_jax.bootstrap(cj, g_j, lj, wj)))


@pytest.mark.parametrize("bits", [32, 64])
def test_many_lut_matches_jax(bits):
    cj, ct = _cfgs(3, 1, 64, 7, 2, bits)
    bsk, lut, lwe = _rotation_inputs(bits, 3, 1, 64, 2, 41 + bits)
    g_j = ggsw_jax.bsk_to_ntt(bsk, cj.primes, bits)
    g_t = ggsw_t.bsk_to_ntt(bsk, ct.primes, bits)
    want = np.asarray(bs_jax.bootstrap_many_lut(
        cj, g_j, jnp.asarray(lut), jnp.asarray(lwe), 2, ms_offset=1))
    got = bsntt_t.bootstrap_many_lut(ct, g_t, torus.from_numpy(lut),
                                     torus.from_numpy(lwe), 2, ms_offset=1)
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def test_blind_rotate_refuses_mismatched_inputs():
    _, ct = _cfgs(3, 1, 64, 7, 2)
    bsk, lut, lwe = _rotation_inputs(32, 3, 1, 64, 2, 5)
    g = ggsw_t.bsk_to_ntt(bsk, ct.primes, 32)
    lt, wt = torus.from_numpy(lut), torus.from_numpy(lwe)
    with pytest.raises(ValueError):
        bsntt_t.blind_rotate(ct, g[:2], lt, wt)
    with pytest.raises(ValueError):
        bsntt_t.blind_rotate(ct, g.to(torch.int64), lt, wt)
    with pytest.raises(ValueError):
        bsntt_t.blind_rotate(ct, g, lt, wt[:, :3])
    with pytest.raises(TypeError):
        bsntt_t.blind_rotate(ct, g, lt.to(torch.int64), wt.to(torch.int64))
    with pytest.raises(ValueError):
        bsntt_t.ntt_cmux(ct, lt[:, None, :].contiguous(),
                         torch.zeros(1, dtype=torch.int32), g[0][:1])


# -- entry points -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_keys(tmp_path_factory):
    """JAX-made TINY keys, saved, and loaded back by the port."""
    cks, sks = boolean_jax.gen_keys(TINY, secret_seed=1, mask_seed=2,
                                    noise_seed=3)
    d = tmp_path_factory.mktemp("ntt_keys")
    cks.save(str(d / "client.npz"))
    sks.save(str(d / "server.npz"))
    return (cks, dataclasses.replace(sks, backend="ntt"),
            boolean_t.ClientKey.load(str(d / "client.npz")),
            boolean_t.ServerKey.load(str(d / "server.npz"), device="cpu"))


@pytest.mark.parametrize("gate", ["and_", "xor", "mux"])
def test_server_key_ntt_gates_match_jax(tiny_keys, gate):
    """ServerKey(backend="ntt") gates and MUX on JAX-made TINY keys: the JAX
    ntt backend's ciphertexts, the truth tables, and the port's mxu
    backend's ciphertexts."""
    cks_j, sks_j, cks_t, sks_t = tiny_keys
    ntt = dataclasses.replace(sks_t, backend="ntt")
    assert ntt.resolved_backend() == "ntt" and sks_j.resolved_backend() == "ntt"
    a, b = np.array([False, True, False, True]), np.array([False, False, True, True])
    ca = cks_j.encrypt(a, mask_seed=20, noise_seed=21)
    cb = cks_j.encrypt(b, mask_seed=22, noise_seed=23)
    if gate == "mux":
        want, truth = sks_j.mux(ca, cb, ca), np.where(a, b, a)
        got, mxu = ntt.mux(ca, cb, ca), sks_t.mux(ca, cb, ca)
    else:
        want = getattr(sks_j, gate)(ca, cb)
        truth = a & b if gate == "and_" else a ^ b
        got, mxu = getattr(ntt, gate)(ca, cb), getattr(sks_t, gate)(ca, cb)
    np.testing.assert_array_equal(torus.to_numpy(got), np.asarray(want))
    assert torch.equal(got, mxu)
    np.testing.assert_array_equal(cks_t.decrypt(got), truth)
    np.testing.assert_array_equal(ntt.bsk_ntt.numpy().view(np.uint32),
                                  np.asarray(sks_j.bsk_ntt))


def test_server_key_ntt_backend_is_carried(tiny_keys, tmp_path):
    _, _, _, sks_t = tiny_keys
    ntt = dataclasses.replace(sks_t, backend="ntt")
    ntt.bsk_ntt  # noqa: B018 - build the cache
    moved = ntt.to("cpu")
    assert moved.backend == "ntt" and "ntt" in moved.evaluation.forms
    fast = ntt.with_fast_mode(levels=1)
    assert fast.backend == "ntt" and "ntt" not in fast.evaluation.forms
    assert fast.cfg.primes == bs_jax.ServerConfig.from_boolean_parameters(
        TINY).with_fast_mode(limb_drop=0, levels=1).primes
    assert fast.bsk_ntt.shape[2] == 1
    ntt.save(str(tmp_path / "k.npz"))
    loaded = boolean_t.ServerKey.load(str(tmp_path / "k.npz"), device="cpu")
    assert loaded.backend == "ntt" and loaded.cfg.primes == ntt.cfg.primes


def test_highlevel_bsk_on_ntt_matches_jax(tmp_path):
    """A JAX-made u64 high-level key loaded by the port on the ntt backend
    (three CRT primes: the torch composition): PBS and multi-LUT PBS equal
    to the JAX ntt backend and to the port's mxu backend."""
    sk = hl_jax.LWESecretKey.new(hl_jax.LWEParams(8, -40), secret_seed=1)
    rsk = hl_jax.RLWESecretKey.new(hl_jax.RLWEParams(64, 1, -50), secret_seed=2)
    bsk_j = dataclasses.replace(
        hl_jax.LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4), backend="ntt")
    bsk_j.save(str(tmp_path / "bsk.npz"))
    bsk_t = hl_t.LWEBSK.load(str(tmp_path / "bsk.npz"), device="cpu",
                             backend="ntt")
    assert bsk_t.resolved_backend() == "ntt" and len(bsk_t.cfg.primes) == 3
    assert not bsntt_t.kernel_applies(bsk_t.cfg)
    rng = np.random.default_rng(5)
    acc = rng.integers(0, 1 << 64, size=(2, 64), dtype=np.uint64)
    cts = rng.integers(0, 1 << 64, size=(6, 9), dtype=np.uint64)
    got = bsk_t.run_bootstrap(acc, cts)
    np.testing.assert_array_equal(
        torus.to_numpy(got),
        np.asarray(bsk_j.run_bootstrap(jnp.asarray(acc), jnp.asarray(cts))))
    assert torch.equal(got, dataclasses.replace(bsk_t, backend="mxu")
                       .run_bootstrap(acc, cts))
    np.testing.assert_array_equal(
        torus.to_numpy(bsk_t.run_bootstrap_many(acc, cts, 1)),
        np.asarray(bsk_j.run_bootstrap_many(jnp.asarray(acc), jnp.asarray(cts), 1)))
    fast = bsk_t.with_fast_mode(limb_drop=2)
    assert "ntt" not in fast.evaluation.forms
    assert torch.equal(fast.run_bootstrap(acc, cts), got)


def test_resolve_backend_takes_ntt():
    _, tiny = _cfgs(4, 1, 64, 7, 2)
    assert backends_t.resolve_backend(tiny, "ntt") == "ntt"
    assert backends_t.resolve_backend(tiny, "auto") == "ntt"
    # N = 8192 with k + 1 = 401: mxu refuses N > 4096 and every Nussbaumer
    # chunking passes the int32 accumulation bound; the ntt backend takes it
    _, wide = _cfgs(4, 400, 8192, 2, 3)
    with pytest.raises(NotImplementedError):
        bsx_t.MxuPlan.from_config(wide)
    with pytest.raises((NotImplementedError, ValueError)):
        bsn_t.NussPlan.from_config(wide)
    assert backends_t.resolve_backend(wide, "auto") == "ntt"
    with pytest.raises(NotImplementedError):
        backends_t.resolve_backend(bs_t.ServerConfig(4, 1, 64, 31, 2, 2, 8, bits=64),
                              "ntt")
    with pytest.raises(ValueError):
        backends_t.resolve_backend(tiny, "fft")
