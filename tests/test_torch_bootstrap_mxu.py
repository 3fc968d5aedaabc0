"""The port's toeplitz ("mxu") bootstrap held bit for bit against
concrete_tpu on the CPU: the key conversions, each kernel's plain PyTorch
version against the JAX Pallas kernel run in interpret mode (as
tests/test_bootstrap_mxu.py runs them), and the blind rotation in both
loop forms, the PBS and the keyswitch against the JAX functions."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_mxu as bsx_jax
from concrete_tpu.core import lwe as lwe_jax
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import lwe as lwe_t
from concrete_tpu_torch.math import polynomial as poly_t

from common import TINY, TINY_K2


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(x):
    return torus.from_numpy(x)


def _cfgs(params):
    return (bs_jax.ServerConfig.from_boolean_parameters(params),
            bs_t.ServerConfig.from_boolean_parameters(params))


def _plan(ks1, n, bl, l, n_sub, drop=0):
    return bsx_t.MxuPlan(lwe_dimension=4, glwe_size=ks1, polynomial_size=n,
                         base_log=bl, level=l, n_sub=n_sub, ks_base_log=2,
                         ks_level=3, limb_drop=drop)


def _degrees(rng, n, b):
    """Per-lane degrees, including 0, N, 2N-1 and 2N."""
    return np.concatenate([rng.integers(0, 2 * n, size=b - 4),
                           [0, n, 2 * n - 1, 2 * n]]).astype(np.int32)


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def test_plan_and_bsk_to_mxu_match_jax(params):
    cfg_j, cfg_t = _cfgs(params)
    pj, pt = bsx_jax.MxuPlan.from_config(cfg_j), bsx_t.MxuPlan.from_config(cfg_t)
    assert (pt.row_blocks, pt.n_sub, pt.limbs_used) == \
        (pj.row_blocks, pj.n_sub, pj.limbs_used)
    rng = np.random.default_rng(1)
    bsk = _u32(rng, (cfg_t.lwe_dimension, cfg_t.pbs_level, cfg_t.glwe_size,
                     cfg_t.glwe_size, cfg_t.polynomial_size))
    np.testing.assert_array_equal(bsx_t.bsk_to_mxu(bsk, cfg_t),
                                  bsx_jax.bsk_to_mxu(bsk, cfg_j))


def test_ksk_to_limbs_matches_jax():
    rng = np.random.default_rng(2)
    ksk = _u32(rng, (64, 3, 17))
    ksk[0, 0, :4] = [0, 0x7F7F7F7F, 0x80808080, 0xFFFFFFFF]
    np.testing.assert_array_equal(lwe_t.ksk_to_limbs(ksk),
                                  lwe_jax.ksk_to_limbs(ksk))


@pytest.mark.parametrize("r_blocks,ks1,n,drop", [(6, 2, 128, 0), (4, 5, 64, 0),
                                                 (2, 3, 64, 1)])
def test_build_tables_plain_matches_pallas(r_blocks, ks1, n, drop):
    rng = np.random.default_rng(r_blocks * n)
    rings = _u32(rng, (r_blocks, ks1, 2 * n))
    with jax.enable_x64(False):
        want = np.asarray(bsx_jax._build_tables_pallas(
            r_blocks, ks1, n, 1, drop, interpret=True)(jnp.asarray(rings)))
    got = bsx_t.build_tables_plain(_t(rings), n, drop)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ks1,n,bl,l,n_sub", [(5, 64, 7, 2, 1), (2, 128, 7, 3, 1),
                                              (3, 128, 8, 2, 2), (2, 64, 12, 2, 2)])
def test_rotdig_plain_matches_pallas(ks1, n, bl, l, n_sub):
    rng = np.random.default_rng(9 + n_sub)
    b = 16
    acc = _u32(rng, (ks1, b, n))
    a_hat = _degrees(rng, n, b)
    with jax.enable_x64(False):
        kern = bsx_jax._rotdig_pallas(ks1, n, b, bl, l, n_sub, interpret=True)
        want = np.asarray(kern(jnp.asarray(acc), jnp.asarray(a_hat)[:, None]))
    got = bsx_t.rotdig_plain(_plan(ks1, n, bl, l, n_sub), _t(acc),
                             torch.from_numpy(a_hat))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ks1,n,bl,l,n_sub", [(5, 64, 7, 2, 1), (3, 128, 8, 2, 2)])
def test_rotdig_recombine_plain_matches_pallas(ks1, n, bl, l, n_sub):
    plan = _plan(ks1, n, bl, l, n_sub)
    rng = np.random.default_rng(13 + n_sub)
    b = 16
    acc = _u32(rng, (ks1, b, n))
    s = rng.integers(-(1 << 31), 1 << 31, size=(b, ks1 * plan.limbs_used * n),
                     dtype=np.int64).astype(np.int32)
    a_hat = _degrees(rng, n, b)
    with jax.enable_x64(False):
        kern = bsx_jax._rotdig_recombine_pallas(
            ks1, n, b, bl, l, plan.limbs_used, 0, n_sub, interpret=True)
        acc_want, d8_want = kern(jnp.asarray(s), jnp.asarray(acc),
                                 jnp.asarray(a_hat)[:, None])
    acc_got, d8_got = bsx_t.rotdig_recombine_plain(
        plan, torch.from_numpy(s), _t(acc), torch.from_numpy(a_hat))
    np.testing.assert_array_equal(torus.to_numpy(acc_got), np.asarray(acc_want))
    np.testing.assert_array_equal(d8_got.numpy(), np.asarray(d8_want))


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper returns its plain version's result (into
    `out` when given) and launches no kernel."""
    plan = _plan(3, 64, 8, 2, 2)
    rng = np.random.default_rng(17)
    b, n = 8, 64
    rings, acc = _t(_u32(rng, (plan.row_blocks, 3, 2 * n))), _t(_u32(rng, (3, b, n)))
    a_hat = torch.from_numpy(_degrees(rng, n, b))
    s = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, size=(b, 3 * 4 * n),
                                      dtype=np.int32))
    bsx_t.reset_launch_counts()
    rhs = torch.empty((plan.row_blocks * n, 3 * 4 * n), dtype=torch.int8)
    assert bsx_t.build_tables(rings, n, out=rhs) is rhs
    assert torch.equal(rhs, bsx_t.build_tables_plain(rings, n))
    d8 = torch.empty((b, plan.row_blocks * n), dtype=torch.int8)
    bsx_t.rotdig(plan, acc, a_hat, out=d8)
    assert torch.equal(d8, bsx_t.rotdig_plain(plan, acc, a_hat))
    acc_in = acc.clone()
    acc_new, d8_new = bsx_t.rotdig_recombine(plan, s, acc_in, a_hat,
                                             acc_out=acc_in, d8_out=d8)
    acc_want, d8_want = bsx_t.rotdig_recombine_plain(plan, s, acc, a_hat)
    assert acc_new is acc_in and torch.equal(acc_in, acc_want)
    assert d8_new is d8 and torch.equal(d8, d8_want)
    assert bsx_t.launch_counts() == {"build_tables": 0, "rotdig": 0,
                                     "rotdig_recombine": 0, "rotdig64": 0,
                                     "recombine_acc": 0,
                                     "fused_external_product_acc": 0,
                                     "window_step": 0}
    with pytest.raises(TypeError):
        bsx_t.rotdig(plan, acc, a_hat.to(torch.int64))
    with pytest.raises(ValueError):
        bsx_t.rotdig(plan, acc[:, :4], a_hat)


def _recombine_operands(rng, bits, drop, b=9, ks1=3, n=64):
    """A plan and (s, acc) for recombine_acc: S rows at INT32_MAX, at
    INT32_MIN and alternating between them, the rest random; acc random
    words of the carrier."""
    plan = dataclasses.replace(_plan(ks1, n, 7, 2, 1, drop), bits=bits)
    s = rng.integers(-(1 << 31), 1 << 31,
                     size=(b, ks1 * plan.limbs_used * n)).astype(np.int32)
    s[0, :] = 2 ** 31 - 1
    s[1, :] = -(2 ** 31)
    s[2, ::2], s[2, 1::2] = 2 ** 31 - 1, -(2 ** 31)
    words = np.uint32 if bits == 32 else np.uint64
    acc = rng.integers(0, np.iinfo(words).max, size=(ks1, b, n), dtype=words,
                       endpoint=True)
    acc[0, 0, :4] = [0, 1, np.iinfo(words).max, np.iinfo(words).max >> 1]
    return plan, torch.from_numpy(s), _t(acc)


@pytest.mark.parametrize("in_place", [False, True], ids=["out", "in_place"])
@pytest.mark.parametrize("bits,drop", [(64, 0), (64, 2), (32, 0), (32, 1)])
def test_recombine_acc_on_cpu_is_acc_plus_the_plain_recombine(bits, drop,
                                                              in_place):
    """On CPU tensors recombine_acc is acc + recombine_limb_planes, bit for
    bit, wrapping mod 2^bits, into a new tensor or into acc itself, and
    launches nothing."""
    plan, s, acc = _recombine_operands(np.random.default_rng(bits + drop),
                                       bits, drop)
    want = acc + bsx_t.recombine_limb_planes(plan, s)
    bsx_t.reset_launch_counts()
    if in_place:
        got = bsx_t.recombine_acc(plan, s, acc, out=acc)
        assert got is acc
    else:
        before = acc.clone()
        got = bsx_t.recombine_acc(plan, s, acc)
        assert torch.equal(acc, before)
    assert got.dtype == (torch.int32 if bits == 32 else torch.int64)
    assert torch.equal(got, want)
    assert bsx_t.recombine_acc.launches == 0


@pytest.mark.parametrize("bad", ["acc_dtype", "s_dtype", "s_shape",
                                 "out_dtype", "acc_layout"])
def test_recombine_acc_refuses_wrong_operands(bad):
    plan, s, acc = _recombine_operands(np.random.default_rng(5), 64, 0)
    out = None
    if bad == "acc_dtype":
        acc = acc.to(torch.int32)
    elif bad == "s_dtype":
        s = s.to(torch.int64)
    elif bad == "s_shape":
        s = s[:, :-1].contiguous()
    elif bad == "out_dtype":
        out = torch.empty(acc.shape, dtype=torch.int32)
    else:
        acc = acc.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        bsx_t.recombine_acc(plan, s, acc, out=out)


def test_modulus_switch_and_sample_extract_match_jax():
    rng = np.random.default_rng(19)
    x = _u32(rng, (64, 17))
    x[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    for n, off, lcl in [(128, 0, 0), (256, 0, 0), (1024, 1, 2)]:
        want = np.asarray(bs_jax.pbs_modulus_switch(jnp.asarray(x), n, off, lcl))
        got = bs_t.pbs_modulus_switch(_t(x), n, off, lcl)
        np.testing.assert_array_equal(got.numpy(), want)
    glwe = _u32(rng, (2, 5, 3, 64))
    np.testing.assert_array_equal(
        torus.to_numpy(bs_t.sample_extract(_t(glwe))),
        np.asarray(bs_jax.sample_extract(jnp.asarray(glwe))))
    np.testing.assert_array_equal(
        torus.to_numpy(bs_t.sample_extract_nth(_t(glwe), 3)),
        np.asarray(bs_jax.sample_extract_nth(jnp.asarray(glwe), 3)))


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def test_keyswitch_limbs_matches_jax(params):
    cfg_j, cfg_t = _cfgs(params)
    rng = np.random.default_rng(23)
    ksk = _u32(rng, (cfg_t.big_lwe_dimension, cfg_t.ks_level,
                     cfg_t.lwe_dimension + 1))
    ct = _u32(rng, (2, 5, cfg_t.big_lwe_dimension + 1))
    ksk8 = lwe_jax.ksk_to_limbs(ksk)
    want = np.asarray(lwe_jax.keyswitch_limbs(
        jnp.asarray(ksk8), jnp.asarray(ct), base_log=cfg_t.ks_base_log,
        level_count=cfg_t.ks_level))
    got = lwe_t.keyswitch_limbs(torch.from_numpy(ksk8), _t(ct),
                                base_log=cfg_t.ks_base_log,
                                level_count=cfg_t.ks_level)
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def _rotation_inputs(params, seed, b):
    cfg_j, cfg_t = _cfgs(params)
    rng = np.random.default_rng(seed)
    bsk = _u32(rng, (cfg_t.lwe_dimension, cfg_t.pbs_level, cfg_t.glwe_size,
                     cfg_t.glwe_size, cfg_t.polynomial_size))
    rings = bsx_jax.bsk_to_mxu(bsk, cfg_j)
    lwe = _u32(rng, (b, cfg_t.lwe_dimension + 1))
    lwe[0, :] = 0xFFFFFFFF                       # degrees of exactly 2N
    lut = _u32(rng, (cfg_t.glwe_size, cfg_t.polynomial_size))
    return cfg_j, cfg_t, rings, lut, lwe


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def test_blind_rotate_both_loop_forms_match_jax(params):
    """blind_rotate_mxu and each of its two loops (the plain scan and the
    dot-first deferred scan, called directly) give the JAX accumulator."""
    cfg_j, cfg_t, rings, lut, lwe = _rotation_inputs(params, 29, 6)
    want = np.asarray(bsx_jax.blind_rotate_mxu(
        cfg_j, jnp.asarray(rings), jnp.asarray(lut), jnp.asarray(lwe)))
    got = bsx_t.blind_rotate_mxu(cfg_t, _t(rings), _t(lut), _t(lwe))
    np.testing.assert_array_equal(torus.to_numpy(got), want)

    plan = bsx_t.MxuPlan.from_config(cfg_t)
    n = cfg_t.polynomial_size
    lwe_t_ = _t(lwe)
    b_hat = bs_t.pbs_modulus_switch(lwe_t_[:, -1], n)
    a_hats = bs_t.pbs_modulus_switch(lwe_t_[:, :-1], n).T.contiguous()
    acc0 = poly_t.negacyclic_monomial_div(
        _t(lut)[:, None, :].expand(-1, lwe.shape[0], -1), b_hat[None, :]).contiguous()
    for scan in (bsx_t._plain_scan, bsx_t._deferred_scan):
        acc = scan(plan, _t(rings), acc0, a_hats)
        np.testing.assert_array_equal(torus.to_numpy(acc.permute(1, 0, 2)), want)


@pytest.mark.parametrize("params", [TINY, TINY_K2], ids=["tiny", "tiny_k2"])
def test_bootstrap_keyswitch_matches_jax(params):
    cfg_j, cfg_t, rings, lut, lwe = _rotation_inputs(params, 31, 5)
    rng = np.random.default_rng(37)
    ksk8 = lwe_jax.ksk_to_limbs(_u32(rng, (cfg_t.big_lwe_dimension, cfg_t.ks_level,
                                            cfg_t.lwe_dimension + 1)))
    want = np.asarray(bsx_jax.bootstrap_keyswitch_mxu(
        cfg_j, jnp.asarray(rings), jnp.asarray(ksk8), jnp.asarray(lut),
        jnp.asarray(lwe)))
    got = bsx_t.bootstrap_keyswitch_mxu(cfg_t, _t(rings), torch.from_numpy(ksk8),
                                        _t(lut), _t(lwe))
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def test_many_lut_bootstrap_matches_jax():
    cfg_j, cfg_t, rings, lut, lwe = _rotation_inputs(TINY_K2, 41, 4)
    want = np.asarray(bsx_jax.bootstrap_many_lut_mxu(
        cfg_j, jnp.asarray(rings), jnp.asarray(lut), jnp.asarray(lwe), 2))
    got = bsx_t.bootstrap_many_lut_mxu(cfg_t, _t(rings), _t(lut), _t(lwe), 2)
    np.testing.assert_array_equal(torus.to_numpy(got), want)


def test_auto_defer_and_plan_limits_match_jax():
    for p in (TINY, TINY_K2):
        cfg_j, cfg_t = _cfgs(p)
        pj, pt = bsx_jax.MxuPlan.from_config(cfg_j), bsx_t.MxuPlan.from_config(cfg_t)
        for b in (1, 2048, 4096, 8192, 65536, 1 << 20):
            assert bsx_t.auto_defer(pt, b) == bsx_jax.auto_defer(pj, b)
    big = dataclasses.replace(_cfgs(TINY)[1], polynomial_size=8192)
    with pytest.raises(NotImplementedError):
        bsx_t.MxuPlan.from_config(big)


def test_int_mm_is_exact():
    rng = np.random.default_rng(43)
    a = torch.from_numpy(rng.integers(-128, 128, size=(5, 2524), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, size=(2524, 13), dtype=np.int8))
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    np.testing.assert_array_equal(bsx_t.int_mm(a, b).numpy(), want)
    out = torch.empty((5, 13), dtype=torch.int32)
    assert bsx_t.int_mm(a, b, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("m,k,n,shape,padded", [
    (16, 6144, 16384, (32, 6144, 16384), ("a", "out")),   # int4 CMux step
    (16, 8192, 5048, (32, 8192, 5048), ("a", "out")),     # int4 keyswitch
    (100, 6144, 2348, (128, 6144, 2352), ("a", "b", "out")),
    (64, 2524, 512, (64, 2528, 512), ("a", "b")),
    (2048, 6144, 16384, (2048, 6144, 16384), ())])
def test_int_mm_padding_pads_only_the_short_operand(m, k, n, shape, padded):
    """A short M pads a alone (the table b is passed as it lies), a short K
    pads a and b, a short N pads b alone; an aligned product pads nothing."""
    assert bsx_t.int_mm_padding(m, k, n) == (shape, padded)


@pytest.mark.parametrize("b,rows", [(1, 32), (16, 32), (17, 32), (32, 32),
                                    (2048, 2048)])
def test_step_buffers_have_the_gemm_row_count(b, rows):
    """d8 and S hold gemm_rows(b) rows, the rows past the batch zero; the
    int4 shapes (K = 6144, 16384 columns) on the meta device, the zeros on
    a tiny plan."""
    cfg = bs_t.ServerConfig(lwe_dimension=630, glwe_dimension=1,
                            polynomial_size=1024, pbs_base_log=7, pbs_level=3,
                            ks_base_log=2, ks_level=8, bits=64)
    plan = bsx_t.MxuPlan.from_config(cfg)
    d8, rhs, s = bsx_t._step_buffers(plan, b, "meta")
    assert tuple(d8.shape) == (rows, 6144) and d8.dtype == torch.int8
    assert tuple(s.shape) == (rows, 16384) and s.dtype == torch.int32
    assert tuple(rhs.shape) == (6144, 16384) and bsx_t._column_major(rhs)
    assert bsx_t.int_mm_padding(rows, 6144, 16384) == ((rows, 6144, 16384), ())
    d8, _, s = bsx_t._step_buffers(_plan(2, 16, 7, 2, 1), b, "cpu")
    assert d8.shape[0] == s.shape[0] == rows
    assert not d8[b:].any() and not s.any()


def _u64_rotation_inputs(rng, cfg, b):
    words = dict(dtype=np.uint64)
    bsk = rng.integers(0, 1 << 64, size=(cfg.lwe_dimension, cfg.pbs_level,
                                         cfg.glwe_size, cfg.glwe_size,
                                         cfg.polynomial_size), **words)
    lwe = rng.integers(0, 1 << 64, size=(b, cfg.lwe_dimension + 1), **words)
    lwe[0, :] = 0xFFFF_FFFF_FFFF_FFFF               # degrees of exactly 2N
    lut = rng.integers(0, 1 << 64, size=(cfg.glwe_size, cfg.polynomial_size),
                       **words)
    return bsk, lut, lwe


@pytest.mark.parametrize("bits", [32, 64])
def test_plain_scan_at_16_rows_matches_jax(bits):
    """The plain loop at a batch of 16 (d8 and S padded to 32 rows, the
    digits written to and S read from the first 16) gives the JAX
    accumulator, on both tori."""
    b = 16
    if bits == 32:
        cfg_j, cfg_t, rings, lut, lwe = _rotation_inputs(TINY_K2, 47, b)
    else:
        kw = dict(lwe_dimension=5, glwe_dimension=1, polynomial_size=64,
                  pbs_base_log=7, pbs_level=3, ks_base_log=2, ks_level=8,
                  bits=64)
        cfg_j, cfg_t = bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)
        bsk, lut, lwe = _u64_rotation_inputs(np.random.default_rng(47), cfg_t, b)
        rings = bsx_jax.bsk_to_mxu(bsk, cfg_j)
    want = np.asarray(bsx_jax.blind_rotate_mxu(
        cfg_j, jnp.asarray(rings), jnp.asarray(lut), jnp.asarray(lwe)))
    plan = bsx_t.MxuPlan.from_config(cfg_t)
    acc0, a_hats = bs_t.rotation_start(_t(lut), _t(lwe), cfg_t.polynomial_size)
    acc = bsx_t._plain_scan(plan, _t(rings), acc0, a_hats)
    assert acc.shape[1] == b
    np.testing.assert_array_equal(torus.to_numpy(acc.permute(1, 0, 2)), want)



_INT4 = bs_t.ServerConfig(lwe_dimension=630, glwe_dimension=1,
                          polynomial_size=1024, pbs_base_log=7, pbs_level=3,
                          ks_base_log=2, ks_level=8, bits=64)


@pytest.mark.parametrize("b,path", [
    (1, "window"), (16, "window"), (bsx_t.WINDOW_MAX_BATCH, "window"),
    (bsx_t.WINDOW_MAX_BATCH + 1, "table"), (2048, "table")])
def test_auto_window_routes_the_u64_step_by_batch(b, path):
    """auto_window, a pure function of the plan, the batch and the ring
    blocks the scan holds, sends the int4 step to the window loop up to
    the crossover and to the table loop above it; scan_for follows it."""
    plan = bsx_t.MxuPlan.from_config(_INT4)
    assert bsx_t.auto_window(plan, b) == (path == "window")
    assert bsx_t.auto_window(plan, b, plan.row_blocks) == (path == "window")
    want = bsx_t._window_scan if path == "window" else bsx_t._plain_scan
    assert bsx_t.scan_for(plan, b) is want
    assert bsx_t.scan_for(plan, b, blocks=plan.row_blocks) is want


def test_auto_window_keeps_the_table_for_tensor_parallel_rings_and_u32():
    """A tensor-parallel rank's ring blocks (R/tp of them) keep the table
    loop and its partial sum, as do the u32 torus and an N the kernel's
    column tile does not divide; the window loop refuses a rank's hooks."""
    plan = bsx_t.MxuPlan.from_config(_INT4)
    for tp in (2, 3, 6):
        blocks = plan.row_blocks // tp
        assert not bsx_t.auto_window(plan, 16, blocks)
        assert bsx_t.scan_for(plan, 16, blocks=blocks) is bsx_t._plain_scan
    assert not bsx_t.auto_window(dataclasses.replace(plan, bits=32), 16)
    assert not bsx_t.auto_window(
        dataclasses.replace(plan, polynomial_size=32), 16)
    with pytest.raises(ValueError):
        bsx_t._window_scan(plan, None, None, None, block0=plan.row_blocks // 2)
    with pytest.raises(ValueError):
        bsx_t._window_scan(plan, None, None, None, reduce=lambda s: s)


def test_window_rotation_counts_its_path_and_matches_jax():
    """A u64 rotation of 16 rows takes the window loop (K4, then
    window_step, whose CPU version is build_tables_plain -> int_mm -> the
    plain recombine): five steps counted under path=window, the JAX
    accumulator bit for bit. One row past the crossover the rotation takes
    the table loop (path=table), and the window loop called there agrees."""
    kw = dict(lwe_dimension=5, glwe_dimension=1, polynomial_size=64,
              pbs_base_log=7, pbs_level=3, ks_base_log=2, ks_level=8, bits=64)
    cfg_j, cfg_t = bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)
    rng = np.random.default_rng(47)
    bsk, lut, lwe = _u64_rotation_inputs(rng, cfg_t, 16)
    rings = bsx_jax.bsk_to_mxu(bsk, cfg_j)
    want = np.asarray(bsx_jax.blind_rotate_mxu(
        cfg_j, jnp.asarray(rings), jnp.asarray(lut), jnp.asarray(lwe)))
    bsx_t.STEPS.reset()
    got = bsx_t.blind_rotate_mxu(cfg_t, _t(rings), _t(lut), _t(lwe))
    assert bsx_t.STEPS.by_key == {"rows=16 path=window": 5}
    np.testing.assert_array_equal(torus.to_numpy(got), want)

    b = bsx_t.WINDOW_MAX_BATCH + 1
    lwe = rng.integers(0, 1 << 64, size=(b, 6), dtype=np.uint64)
    bsx_t.STEPS.reset()
    got = bsx_t.blind_rotate_mxu(cfg_t, _t(rings), _t(lut), _t(lwe))
    assert bsx_t.STEPS.by_key == {f"rows={b} path=table": 5}
    plan = bsx_t.MxuPlan.from_config(cfg_t)
    acc0, a_hats = bs_t.rotation_start(_t(lut), _t(lwe), 64)
    acc = bsx_t._window_scan(plan, _t(rings), acc0, a_hats)
    assert torch.equal(acc.permute(1, 0, 2), got)
