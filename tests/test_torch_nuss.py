"""The port's Nussbaumer backend (N > 4096; any N on request) held against
concrete_tpu on the CPU, tolerance 0 for every torus value (all of it is
integer arithmetic mod 2^32 / 2^64): the transform functions of
math/nussbaumer on int32 and int64, the plan and its chunking rule, the
key conversion byte for byte, and the three kernels' plain versions (and
K1's on the Nussbaumer rings) against the JAX XLA forms and the Pallas
kernels in interpret mode. The bootstraps and entry points are in
test_torch_nuss_bootstrap.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_nuss as bsn_jax
from concrete_tpu.math import nussbaumer as nb_jax
from concrete_tpu.math.polynomial import polymul_wrapping_naive
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_nuss as bsn_t
from concrete_tpu_torch.math import nussbaumer as nb_t


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


# -- math/nussbaumer ---------------------------------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("n,l", [(16, 2), (64, 4), (256, 8), (1024, 32)])
def test_transform_functions_match_jax(bits, n, l):
    """chunk / forward / inverse_raw / fold / unchunk on int32 / int64
    tensors and on host numpy arrays (as the JAX module's _xp takes them)."""
    x = _rand(np.random.default_rng(n + bits), (3, n), bits)
    with np.errstate(over="ignore"):      # the JAX module's numpy path
        c = nb_jax.chunk(x, l)
        f = nb_jax.forward(c, l)
        inv = nb_jax.inverse_raw(f, l)
        fo = nb_jax.fold(f, l)
    t = torus.from_numpy(x)
    ct = nb_t.chunk(t, l)
    assert ct.dtype == t.dtype
    np.testing.assert_array_equal(torus.to_numpy(ct), c)
    np.testing.assert_array_equal(torus.to_numpy(nb_t.forward(ct, l)), f)
    np.testing.assert_array_equal(
        torus.to_numpy(nb_t.inverse_raw(torus.from_numpy(f), l)), inv)
    np.testing.assert_array_equal(
        torus.to_numpy(nb_t.fold(torus.from_numpy(f), l)), fo)
    np.testing.assert_array_equal(
        torus.to_numpy(nb_t.unchunk(ct[..., :l, :], l)), x)
    # host numpy in, numpy of the same type out
    got = nb_t.forward(nb_t.chunk(x, l), l)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, f)
    np.testing.assert_array_equal(nb_t.inverse_raw(f, l), inv)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("n,l", [(64, 2), (1024, 32)])
def test_monomial_mul_chunked_matches_jax(bits, n, l):
    rng = np.random.default_rng(n * bits)
    cm = _rand(rng, (2, 5, l, n // l), bits)
    deg = np.array([0, n, 2 * n - 1, 2 * n, rng.integers(0, 2 * n)],
                   dtype=np.int32)
    want = np.asarray(nb_jax.monomial_mul_chunked(
        jnp.asarray(cm), jnp.asarray(deg), l))
    got = nb_t.monomial_mul_chunked(torus.from_numpy(cm),
                                    torch.from_numpy(deg), l)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    with np.errstate(over="ignore"):
        for d in (0, n, 2 * n - 1):       # scalar degrees, the numpy path
            np.testing.assert_array_equal(
                nb_t.monomial_mul_chunked(cm, d, l),
                nb_jax.monomial_mul_chunked(cm, np.asarray(d), l))


def test_polymul_and_pick_l_match_jax():
    """The reference composition (chunk, forward, pointwise, inverse, fold)
    against the schoolbook product mod 2^32, and pick_l."""
    rng = np.random.default_rng(0)

    def mulm(fa, fb):
        out = np.zeros_like(fa)
        for idx in np.ndindex(fa.shape[:-1]):
            out[idx] = polymul_wrapping_naive(fa[idx], fb[idx])
        return out

    for n, l in [(16, 2), (64, 4), (256, 8)]:
        a = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        b = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        with np.errstate(over="ignore"):
            got = nb_t.negacyclic_polymul_nuss(
                a.astype(np.uint64), b.astype(np.uint64), l, mulm)
        np.testing.assert_array_equal(got.astype(np.uint32),
                                      polymul_wrapping_naive(a, b))
    for n in (16, 64, 128, 256, 1024, 8192, 16384):
        assert nb_t.pick_l(n) == nb_jax.pick_l(n)


# -- the plan -------------------------------------------------------------------------

PLAN_FIELDS = ("lwe_dimension", "glwe_size", "polynomial_size", "l",
               "base_log", "level", "n_sub", "ks_base_log", "ks_level", "bits",
               "m", "two_l", "shift", "w_prime", "limbs_used", "n_words",
               "limb_hi_drop", "row_blocks")


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("N", [64, 256, 1024, 4096, 8192, 16384])
def test_plan_and_best_l_match_jax(bits, N):
    """Every field and property, for best_l's choice and every explicit L,
    and the same refusals (no arrays: the grid reaches N = 16384)."""
    for k, bl, lv in [(1, 2, 3), (1, 7, 3), (2, 10, 2), (1, 16, 2)]:
        cj, ct = _cfgs(100, k, N, bl, lv, bits)
        assert bsn_t.NussPlan.best_l(ct) == bsn_jax.NussPlan.best_l(cj)
        for l in (None, 1, 2, 4, 8, 16, 32, 64, 128, 256):
            try:
                pj = bsn_jax.NussPlan.from_config(cj, l)
            except (NotImplementedError, ValueError) as exc:
                with pytest.raises(type(exc)):
                    bsn_t.NussPlan.from_config(ct, l)
                continue
            pt = bsn_t.NussPlan.from_config(ct, l)
            for f in PLAN_FIELDS:
                assert getattr(pt, f) == getattr(pj, f), (k, bl, l, f)
            assert [pt.sub_multiplier(s) for s in range(pt.n_sub)] == \
                [pj.sub_multiplier(s) for s in range(pj.n_sub)]


def test_plan_refusals():
    _, ct = _cfgs(4, 1, 64, 7, 2)
    with pytest.raises(ValueError):
        bsn_t.NussPlan.from_config(ct, 16)               # L > M
    with pytest.raises(NotImplementedError):
        bsn_t.NussPlan.from_config(dataclasses.replace(ct, bits=16))
    p = bsn_t.NussPlan.from_config(_cfgs(100, 1, 8192, 2, 3)[1])
    assert (p.l, p.m, p.limbs_used, p.n_words, p.limb_hi_drop) == (32, 256, 5, 2, 3)
    p64 = bsn_t.NussPlan.from_config(_cfgs(630, 1, 8192, 7, 3, 64)[1])
    assert (p64.l, p64.n_sub, p64.limbs_used, p64.n_words) == (32, 2, 9, 3)


# -- key conversion ----------------------------------------------------------------------


@pytest.mark.parametrize("bits,k,N,bl,lv,L", [
    (32, 1, 64, 7, 2, 2), (32, 2, 128, 7, 3, 4), (32, 1, 256, 8, 2, 8),
    (32, 1, 1024, 2, 3, 32),
    (64, 1, 64, 7, 2, 2), (64, 2, 128, 7, 2, 4), (64, 1, 256, 10, 2, 8),
    (64, 1, 1024, 7, 3, 32)])
def test_bsk_to_nuss_matches_jax(bits, k, N, bl, lv, L):
    cj, ct = _cfgs(3, k, N, bl, lv, bits)
    bsk = _rand(np.random.default_rng(N + L + bits), (3, lv, k + 1, k + 1, N),
                bits)
    want = bsn_jax.bsk_to_nuss(bsk, cj, L)
    got = bsn_t.bsk_to_nuss(bsk, ct, L)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    # from a tensor, in slices of one row of the n axis
    rows = bsn_t._slice_rows
    bsn_t._slice_rows = lambda plan, n_lwe: 1
    try:
        np.testing.assert_array_equal(
            torus.to_numpy(bsn_t.bsk_to_nuss(torus.from_numpy(bsk), ct, L)), want)
    finally:
        bsn_t._slice_rows = rows


# -- the kernels' plain versions -------------------------------------------------------


def _dot_output(rng, plan, b):
    s = rng.integers(-(1 << 31), 1 << 31,
                     size=(plan.two_l, b, plan.glwe_size * plan.limbs_used * plan.m))
    s[0, 0, :] = 2 ** 31 - 1
    s[-1, -1, :] = -(2 ** 31)
    return s.astype(np.int32)


# (k+1, N, L): tests/test_nussbaumer.py's shapes, L = 2 and 16, and the
# TFHE_LIB ring's chunking (N=1024, L=32, M=32: root 1, the fold's
# neighbour is the class itself)
RECOMBINE_SHAPES = [(3, 128, 4), (2, 512, 8), (2, 64, 2), (2, 512, 16),
                    (2, 1024, 32)]


@pytest.mark.parametrize("ks1,N,L", RECOMBINE_SHAPES)
def test_recombine_inv_plain_matches_pallas_and_xla(ks1, N, L):
    """K5's plain version against the JAX XLA form and the Pallas kernel in
    interpret mode, and the wrapper on CPU tensors, which takes the plain
    version."""
    cj, ct = _cfgs(4, ks1 - 1, N, 7, 2)
    plan_j, plan = bsn_jax.NussPlan.from_config(cj, L), bsn_t.NussPlan.from_config(ct, L)
    s = _dot_output(np.random.default_rng(19 + N), plan, 16)
    want = np.asarray(bsn_jax._recombine_nuss_u64(plan_j, jnp.asarray(s)))
    got = bsn_t.recombine_inv_plain(plan, torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    np.testing.assert_array_equal(
        np.asarray(bsn_jax._recombine_nuss_kernel(plan_j, jnp.asarray(s),
                                                  interpret=True)), want)
    bsn_t.reset_launch_counts()
    np.testing.assert_array_equal(
        torus.to_numpy(bsn_t.recombine_inv(plan, torch.from_numpy(s))), want)
    assert bsn_t.launch_counts()["recombine_inv"] == 0


@pytest.mark.parametrize("ks1,N,L", RECOMBINE_SHAPES)
def test_recombine_inv64_plain_matches_pallas_and_xla(ks1, N, L):
    """K6's plain version on the u64 torus (128-bit pairs on int64)."""
    cj, ct = _cfgs(4, ks1 - 1, N, 7, 2, 64)
    plan_j, plan = bsn_jax.NussPlan.from_config(cj, L), bsn_t.NussPlan.from_config(ct, L)
    s = _dot_output(np.random.default_rng(29 + N), plan, 16)
    want = np.asarray(bsn_jax._recombine_nuss_torus64(plan_j, jnp.asarray(s)))
    got = bsn_t.recombine_inv64_plain(plan, torch.from_numpy(s))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    np.testing.assert_array_equal(
        np.asarray(bsn_jax._recombine_nuss_torus64_kernel(
            plan_j, jnp.asarray(s), interpret=True)), want)
    np.testing.assert_array_equal(
        torus.to_numpy(bsn_t.recombine_inv64(plan, torch.from_numpy(s))), want)
    with pytest.raises(TypeError):            # K5 is the u32 torus's
        bsn_t.recombine_inv(plan, torch.from_numpy(s))


@pytest.mark.parametrize("ks1,N,L,bl,lv", [
    (2, 256, 4, 7, 2), (3, 128, 4, 5, 3), (2, 512, 8, 7, 2)])
def test_rotdig_fwd_nuss_plain_matches_pallas(ks1, N, L, bl, lv):
    """K7's plain version against the Pallas kernel in interpret mode,
    degrees in the negated half included; the port's d8 is frequency-major,
    the JAX package's [B, 2L, R'*M]."""
    cj, ct = _cfgs(4, ks1 - 1, N, bl, lv)
    plan_j, plan = bsn_jax.NussPlan.from_config(cj, L), bsn_t.NussPlan.from_config(ct, L)
    rng = np.random.default_rng(23)
    acc = _rand(rng, (ks1, 16, L, N // L), 32)
    a_hat = np.concatenate([rng.integers(0, 2 * N, size=13),
                            [0, N, 2 * N - 1]]).astype(np.int32)
    want = np.asarray(bsn_jax._rotdig_nuss(plan_j, jnp.asarray(acc),
                                           jnp.asarray(a_hat.astype(np.uint32)),
                                           interpret=True))
    got = bsn_t.rotdig_fwd_nuss(plan, torus.from_numpy(acc),
                                torch.from_numpy(a_hat))
    assert got.dtype == torch.int8 and got.shape == (plan.two_l, 16,
                                                     plan.row_blocks * plan.m)
    np.testing.assert_array_equal(got.permute(1, 0, 2).numpy(), want)


@pytest.mark.parametrize("bits,ks1,N,L,bl,lv", [
    (32, 2, 128, 8, 16, 2), (64, 2, 64, 4, 7, 3), (64, 3, 64, 2, 10, 2)])
def test_rotdig_fwd_nuss_plain_matches_xla(bits, ks1, N, L, bl, lv):
    """Beyond the JAX kernel (u64, bl_eff > 14): against the XLA composition
    monomial_mul_chunked + _digit_matrix_nuss."""
    cj, ct = _cfgs(4, ks1 - 1, N, bl, lv, bits)
    plan_j, plan = bsn_jax.NussPlan.from_config(cj, L), bsn_t.NussPlan.from_config(ct, L)
    rng = np.random.default_rng(37 + bits)
    acc = _rand(rng, (ks1, 8, L, N // L), bits)
    a_hat = np.concatenate([rng.integers(0, 2 * N, size=5),
                            [0, N, 2 * N - 1]]).astype(np.int32)
    aj = jnp.asarray(acc)
    rot = nb_jax.monomial_mul_chunked(aj, jnp.asarray(a_hat)[None, :], L)
    want = np.asarray(bsn_jax._digit_matrix_nuss(plan_j, rot - aj))
    got = bsn_t.rotdig_fwd_nuss_plain(plan, torus.from_numpy(acc),
                                      torch.from_numpy(a_hat))
    np.testing.assert_array_equal(got.permute(1, 0, 2).numpy(), want)


@pytest.mark.parametrize("nw,hd,ks1,m", [(2, 3, 2, 32), (3, 3, 2, 16), (3, 3, 3, 64)])
def test_build_tables_plain_nuss_rings_match_jax(nw, hd, ks1, m):
    """K1's plain version on the Nussbaumer rings: 2 or 3 word planes with
    the high limbs dropped, against the JAX package's _build_tables_jnp."""
    from concrete_tpu.core import bootstrap_mxu as bsx_jax

    rings = np.random.default_rng(m + nw).integers(
        0, 1 << 32, size=(8, ks1 * nw, 2 * m), dtype=np.uint32)
    want = np.asarray(bsx_jax._build_tables_jnp(jnp.asarray(rings), m, nw, 0, hd))
    got = bsx_t.build_tables(torus.from_numpy(rings), m, 0, nw, hd)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        bsx_t.build_tables(torus.from_numpy(rings), m, 0, nw, 4 * nw)
