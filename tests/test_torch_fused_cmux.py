"""The plain versions of K9 (the NTT-domain CMux step,
core/bootstrap_ntt.ntt_cmux) and K8 (the fused toeplitz CMux accumulation,
core/bootstrap_mxu.fused_external_product_acc) against the
JAX package's Pallas kernels run in interpret mode, at the shapes of
tests/test_bootstrap_mxu.py, and the fused blind rotation on the CPU.
Tolerance 0: every step is integer arithmetic mod 2^32."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_mxu as bsx_jax
from concrete_tpu.ops import fused_cmux as fc_jax
from concrete_tpu.ops import pallas_cmux
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_ntt as bsntt_t
from concrete_tpu_torch.core import lwe as lwe_t


def _cfgs(k, N, bl, lv, drop=0, bits=32, n=4):
    kw = dict(lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
              pbs_base_log=bl, pbs_level=lv, ks_base_log=4, ks_level=3,
              mxu_limb_drop=drop, bits=bits)
    return bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


# -- K9 ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_ntt_cmux_plain_matches_pallas_kernel(k):
    """tests/test_bootstrap_mxu.py's K9 case (N = 64, B = 8, base_log 6,
    level 2) and a k = 2 twin: the port's plain step and its wrapper on
    CPU tensors equal make_cmux_kernel in interpret mode."""
    cj, ct = _cfgs(k, 64, 6, 2)
    assert len(ct.primes) == 2 and bsntt_t.kernel_applies(ct)
    rng = np.random.default_rng(11 + k)
    b, ks1, N, l = 8, k + 1, 64, 2
    acc = _u32(rng, (ks1, b, N))
    a_hat = rng.integers(0, 2 * N, size=b, dtype=np.int32)
    a_hat[:3] = [0, N, 2 * N - 1]
    ggsw = np.stack([rng.integers(0, p, size=(l, ks1, ks1, N), dtype=np.uint32)
                     for p in ct.primes])
    with jax.enable_x64(False):
        kern = pallas_cmux.make_cmux_kernel(cj, tile_b=b, interpret=True)
        want = np.asarray(kern(jnp.asarray(acc), jnp.asarray(a_hat),
                               jnp.asarray(ggsw)))
    acc_t, a_t = torus.from_numpy(acc), torch.from_numpy(a_hat)
    g_t = torch.from_numpy(ggsw.view(np.int32))
    np.testing.assert_array_equal(
        torus.to_numpy(bsntt_t.ntt_cmux_plain(ct, acc_t, a_t, g_t)), want)
    bsntt_t.reset_launch_counts()
    out = torch.empty_like(acc_t)
    assert bsntt_t.ntt_cmux(ct, acc_t, a_t, g_t, out=out) is out
    np.testing.assert_array_equal(torus.to_numpy(out), want)
    assert bsntt_t.ntt_cmux.launches == 0


def test_ntt_cmux_refusals():
    _, ct = _cfgs(1, 64, 6, 2)
    acc = torch.zeros((2, 3, 64), dtype=torch.int32)
    a_hat = torch.zeros(3, dtype=torch.int32)
    g = torch.zeros((2, 2, 2, 2, 64), dtype=torch.int32)
    with pytest.raises(TypeError):
        bsntt_t.ntt_cmux(ct, acc.to(torch.int64), a_hat, g)
    with pytest.raises(ValueError):
        bsntt_t.ntt_cmux(ct, acc, a_hat[:2], g)
    with pytest.raises(ValueError):
        bsntt_t.ntt_cmux(ct, acc, a_hat, g[:, :1])
    with pytest.raises(ValueError):
        bsntt_t.ntt_cmux(ct, acc.transpose(1, 2).contiguous().transpose(1, 2),
                         a_hat, g)
    _, u64 = _cfgs(1, 64, 7, 3, bits=64)
    assert len(u64.primes) == 3 and not bsntt_t.kernel_applies(u64)
    assert [bsntt_t.cols_per_block(ks1, n) for ks1, n in
            [(5, 256), (2, 8192), (2, 16384), (5, 8192), (3, 16384)]] == \
        [5, 2, 1, 2, 1]


@pytest.mark.parametrize("preset", ["TPU128", "DEFAULT", "TFHE_LIB"])
def test_ntt_cmux_host_tables_match_big_integers(preset):
    """Every word of K9's host tables and constants at a gate preset's N and
    primes, recomputed with Python integers from the root psi that the
    twist table carries: twist psi^i R^2, untwist psi^-i N^-1 R (the R the
    MAC's REDC divides out), stage twiddles omega^(+-j 2^s) R, Garner's
    constants."""
    from concrete_tpu_torch.params import (DEFAULT_PARAMETERS,
                                           TFHE_LIB_PARAMETERS,
                                           TPU128_PARAMETERS)
    params = {"TPU128": TPU128_PARAMETERS, "DEFAULT": DEFAULT_PARAMETERS,
              "TFHE_LIB": TFHE_LIB_PARAMETERS}[preset]
    cfg = bs_t.ServerConfig.from_boolean_parameters(params)
    n, primes = cfg.polynomial_size, cfg.primes
    tables, consts = bsntt_t._host_tables(n, primes)
    tables = tables.view(np.uint32).astype(object)
    consts = [int(c) for c in consts.view(np.uint32)]
    R = 1 << 32
    for pi, p in enumerate(primes):
        psi = int(tables[0, pi, 1]) * pow(R * R, -1, p) % p
        assert pow(psi, n, p) == p - 1
        omega = psi * psi % p
        want = np.zeros((4, n), dtype=object)
        want[0] = [pow(psi, i, p) * R * R % p for i in range(n)]
        want[1] = [pow(psi, -i, p) * pow(n, -1, p) * R % p for i in range(n)]
        for s in range(n.bit_length() - 1):
            for j in range(n >> (s + 1)):
                want[2, n - (n >> s) + j] = pow(omega, j << s, p) * R % p
                want[3, n - (n >> s) + j] = pow(omega, -(j << s), p) * R % p
        assert (tables[:, pi] == want).all()
        assert consts[pi] == p and consts[2 + pi] == (-pow(p, -1, R)) % R
    p0, p1 = primes
    half = -(-(p0 * p1) // 2)
    assert consts[4] == pow(p0, -1, p1) * R % p1
    assert (consts[5], consts[6]) == (half % p0, half // p0)
    assert consts[7] == p0 * p1 % R


# every N from 16 to 16384, and the grid of shapes a configuration may take
ALL_N = [1 << e for e in range(4, 15)]
SHAPE_GRID = [(ks1, level, b) for ks1 in range(2, 9) for level in range(1, 5)
              for b in (1, 3, 2048)]


def _block_geometry_rule(ks1, n, level, b):
    """The block path's geometry rule, written out: (cols, group, rows)
    from 227 KB (58,112 words), polynomials of N + N/8 words, at most 5
    columns, 4 rows and 72 KB of rows."""
    padded, words = n + n // 8, 232448 // 4
    cols = max(1, min(ks1, 5, (words // padded - 1) // 2))
    per_row = (2 * cols + 2 * level * ks1) * padded
    if per_row > words:
        return cols, words // padded - 2 * cols, 1
    return cols, 2 * level * ks1, max(1, min(4, b, 72 * 1024 // 4 // per_row))


@pytest.mark.parametrize("n", ALL_N)
def test_ntt_cmux_block_geometry_fits(n):
    """K9's block geometry for every k+1 and level a configuration may
    take: within the kernel's limits (cols <= 5, rows <= 4 and the batch),
    a digit group of at least one polynomial and at most all 2*l*(k+1),
    and shared memory of rows*(2*cols + group) padded polynomials (N + N/8
    words) within the 227 KB a block may take (less the kernel's 32 static
    bytes); the rule itself unchanged."""
    for ks1, level, b in SHAPE_GRID:
        cols, group, rows = bsntt_t.block_geometry(ks1, n, level, b)
        assert (cols, group, rows) == _block_geometry_rule(ks1, n, level, b)
        assert 1 <= cols <= min(ks1, bsntt_t.COLS_MAX)
        assert 1 <= group <= 2 * level * ks1
        assert 1 <= rows <= min(b, bsntt_t.ROWS_MAX)
        assert rows == 1 or group == 2 * level * ks1
        assert rows * (2 * cols + group) * (n + n // 8) * 4 \
            <= 232448 - 32


@pytest.mark.parametrize("n", ALL_N)
def test_ntt_cmux_path_follows_n_and_the_warp_geometry_fits(n):
    """K9's path is the warp path exactly at bootstrap_ntt.WARP_N, for every
    shape of the grid, and the launch takes that path's geometry: on the
    block path block_geometry; on the warp path one row a block of 2*(k+1)
    warps within the kernel's launch bound (kWarpThreads in the source),
    both primes a pass unless they do not fit, and shared memory of
    (per_pass*l + 2)*(k+1) polynomials of N + N/32 words (at N = 1024,
    where the scratch polynomials take the spectra's slots, 2*l*(k+1), or
    (l + 2)*(k+1) with one prime a pass) within 227 KB."""
    src = (Path(bsntt_t.__file__).parent.parent / "csrc" / "ntt_kernels.cu").read_text()
    assert f"constexpr int kWarpThreads = {bsntt_t.WARP_THREADS_MAX};" in src
    assert bsntt_t.WARP_N == (256, 512, 1024)
    for ks1, level, b in SHAPE_GRID:
        how, geometry = bsntt_t.launch_geometry(ks1, n, level, b)
        assert how == ("warp" if n in bsntt_t.WARP_N else "block")
        assert how == bsntt_t.path(ks1, n)
        if how == "block":
            assert geometry == bsntt_t.block_geometry(ks1, n, level, b)
            continue
        (per_pass,) = geometry
        assert 2 * ks1 * 32 <= bsntt_t.WARP_THREADS_MAX
        polys = {2: 2 * level, 1: level + 2} if n == 1024 else \
            {2: 2 * level + 2, 1: level + 2}
        words = lambda pp: polys[pp] * ks1 * (n + n // 32)  # noqa: E731
        assert per_pass == (2 if words(2) * 4 <= 232448 else 1)
        assert words(per_pass) * 4 <= 232448


# -- K8 ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("k,l,bl,drop", [(1, 3, 7, 0), (2, 2, 8, 0), (1, 2, 7, 1)])
def test_fused_plain_matches_pallas_kernel(k, l, bl, drop):
    """tests/test_bootstrap_mxu.py's three K8 cases ((2, 2, 8, 0) splits
    each digit into two int8 chunks): the port's plain version and its
    wrapper on CPU tensors equal make_fused_cmux in interpret mode."""
    cj, ct = _cfgs(k, 64, bl, l, drop)
    plan_j, plan_t = bsx_jax.MxuPlan.from_config(cj), bsx_t.MxuPlan.from_config(ct)
    assert plan_t.n_sub == (2 if bl == 8 else 1)
    rng = np.random.default_rng(k * 10 + l)
    R, ks1, N, b = plan_t.row_blocks, plan_t.glwe_size, 64, 8
    rings = _u32(rng, (R, ks1, 2 * N))
    glwe = _u32(rng, (ks1, b, N))
    acc = _u32(rng, (ks1, b, N))
    d8 = np.array(bsx_jax._digit_matrix(plan_j, jnp.asarray(glwe)))
    with jax.enable_x64(False):
        want = np.asarray(fc_jax.fused_external_product_acc(
            cj, plan_j, jnp.asarray(acc), jnp.asarray(d8), jnp.asarray(rings),
            interpret=True))
    acc_t, d8_t, rings_t = (torus.from_numpy(acc), torch.from_numpy(d8),
                            torus.from_numpy(rings))
    np.testing.assert_array_equal(torus.to_numpy(
        bsx_t.fused_external_product_acc_plain(plan_t, acc_t, d8_t, rings_t)), want)
    bsx_t.reset_launch_counts()
    acc_in = acc_t.clone()
    assert bsx_t.fused_external_product_acc(plan_t, acc_in, d8_t, rings_t,
                                            out=acc_in) is acc_in
    np.testing.assert_array_equal(torus.to_numpy(acc_in), want)
    assert bsx_t.fused_external_product_acc.launches == 0


@pytest.mark.parametrize("k,N,bl,lv,drop", [(1, 64, 7, 3, 0), (2, 64, 8, 2, 1)])
def test_fused_blind_rotation_equals_unfused(k, N, bl, lv, drop):
    """blind_rotate_mxu(fused=True) on the CPU (K2's and K8's plain
    versions) equals the default loop, and the fused keyword reaches the
    PBS and gate pipelines."""
    _, ct = _cfgs(k, N, bl, lv, drop, n=5)
    rng = np.random.default_rng(N + k)
    bsk = _u32(rng, (5, lv, k + 1, k + 1, N))
    rings = torus.from_numpy(bsx_t.bsk_to_mxu(bsk, ct))
    lut = torus.from_numpy(_u32(rng, (k + 1, N)))
    lwe = torus.from_numpy(_u32(rng, (6, 6)))
    want = bsx_t.blind_rotate_mxu(ct, rings, lut, lwe)
    assert torch.equal(bsx_t.blind_rotate_mxu(ct, rings, lut, lwe, fused=True), want)
    assert torch.equal(bsx_t.bootstrap_many_lut_mxu(ct, rings, lut, lwe, 1, fused=True),
                       bsx_t.bootstrap_many_lut_mxu(ct, rings, lut, lwe, 1))
    ksk = _u32(rng, (k * N, ct.ks_level, 6))
    ksk8 = torch.from_numpy(lwe_t.ksk_to_limbs(ksk))
    assert torch.equal(
        bsx_t.bootstrap_keyswitch_mxu(ct, rings, ksk8, lut, lwe, fused=True),
        bsx_t.bootstrap_keyswitch_mxu(ct, rings, ksk8, lut, lwe))


def test_fused_refuses_u64():
    _, ct = _cfgs(1, 64, 7, 3, bits=64)
    plan = bsx_t.MxuPlan.from_config(ct)
    rng = np.random.default_rng(3)
    bsk = rng.integers(0, 1 << 63, size=(4, 3, 2, 2, 64), dtype=np.uint64)
    rings = torus.from_numpy(bsx_t.bsk_to_mxu(bsk, ct))
    lut = torch.zeros((2, 64), dtype=torch.int64)
    lwe = torch.zeros((3, 5), dtype=torch.int64)
    with pytest.raises(ValueError):
        bsx_t.blind_rotate_mxu(ct, rings, lut, lwe, fused=True)
    with pytest.raises(ValueError):
        bsx_t.fused_external_product_acc(
            plan, torch.zeros((2, 3, 64), dtype=torch.int64),
            torch.zeros((3, plan.row_blocks * 64), dtype=torch.int8), rings[0])
