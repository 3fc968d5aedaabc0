"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: these tests need an NVIDIA Hopper GPU and nvcc, and skip
anywhere else (the check runs inside a fixture, never at import). On a GPU
machine (where JAX, which tests/conftest.py imports, may be absent):
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Every comparison is exact (integer arithmetic mod 2^32 and 2^64, tolerance
0)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from concrete_tpu_torch import boolean, torus
from concrete_tpu_torch.core import bootstrap as bs
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.core import bootstrap_ntt as bsntt
from concrete_tpu_torch.core import bootstrap_nuss as bsn
from concrete_tpu_torch.core.ggsw import bsk_to_ntt
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.math import polynomial
from concrete_tpu_torch.ops import _cuda
from concrete_tpu_torch.params import BooleanParameters

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        pytest.skip("needs nvcc")
    _cuda.load_all()
    return torch.device("cuda")


def _u32(rng, shape, dev):
    return torus.from_numpy(
        rng.integers(0, 1 << 32, size=shape, dtype=np.uint32), dev)


def _degrees(rng, n, b, dev):
    """Random degrees in [0, 2N], the first rows 0, 1, N-1, N, 2N-1, 2N."""
    a = rng.integers(0, 2 * n + 1, size=b).astype(np.int32)
    edges = [0, 1, n - 1, n, 2 * n - 1, 2 * n]
    a[:min(b, 6)] = edges[:min(b, 6)]
    return torch.from_numpy(a).to(dev)


def _plan(ks1, n, bl, l, n_sub, drop=0, bits=32):
    return bsx.MxuPlan(lwe_dimension=4, glwe_size=ks1, polynomial_size=n,
                       base_log=bl, level=l, n_sub=n_sub, ks_base_log=2,
                       ks_level=3, limb_drop=drop, bits=bits)


def _u64(rng, shape, dev):
    """Random u64 words with the word-boundary values of
    tests/test_bootstrap_mxu.py in the first two rows."""
    acc = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    acc[0, 0, :4] = [0, 1, 0xFFFF_FFFF, 0x1_0000_0000]
    acc[0, 1, :4] = [0xFFFF_FFFF_FFFF_FFFF, 0x8000_0000,
                     0x7FFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0000]
    return torus.from_numpy(acc, dev)


@pytest.mark.parametrize("r_blocks,ks1,n,drop", [
    (4, 2, 64, 0), (10, 5, 256, 0), (12, 3, 512, 0), (6, 2, 1024, 0),
    (2, 3, 64, 1), (2, 2, 4096, 0)])
def test_build_tables_kernel(dev, r_blocks, ks1, n, drop):
    rings = _u32(np.random.default_rng(n), (r_blocks, ks1, 2 * n), dev)
    before = bsx.build_tables.launches
    got = bsx.build_tables(rings, n, drop)
    assert bsx.build_tables.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsx.build_tables_plain(rings, n, drop))


@pytest.mark.parametrize("ks1,n,bl,l,n_sub,b", [
    (2, 64, 6, 3, 1, 5), (5, 256, 7, 2, 1, 64), (3, 512, 8, 2, 2, 33),
    (2, 1024, 7, 3, 1, 16), (2, 64, 12, 2, 2, 8), (2, 64, 15, 2, 3, 8),
    (2, 4096, 7, 2, 1, 4), (3, 64, 16, 2, 3, 8)])
def test_rotdig_kernel(dev, ks1, n, bl, l, n_sub, b):
    plan = _plan(ks1, n, bl, l, n_sub)
    rng = np.random.default_rng(n + b)
    acc, a_hat = _u32(rng, (ks1, b, n), dev), _degrees(rng, n, b, dev)
    before = bsx.rotdig.launches
    got = bsx.rotdig(plan, acc, a_hat)
    assert bsx.rotdig.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsx.rotdig_plain(plan, acc, a_hat))


@pytest.mark.parametrize("r_blocks,ks1,n,drop", [
    (6, 2, 1024, 0), (6, 2, 1024, 2), (6, 2, 64, 5), (12, 2, 256, 1),
    (3, 3, 4096, 0)])
def test_build_tables_u64_kernel(dev, r_blocks, ks1, n, drop):
    rings = _u32(np.random.default_rng(n + drop), (r_blocks, 2 * ks1, 2 * n),
                 dev)
    before = bsx.build_tables.launches
    got = bsx.build_tables(rings, n, drop, 2)
    assert bsx.build_tables.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsx.build_tables_plain(rings, n, drop, 2))


@pytest.mark.parametrize("ks1,n,bl,l,n_sub,b", [
    (2, 1024, 7, 3, 1, 64), (2, 1024, 10, 3, 2, 33), (2, 1024, 16, 2, 3, 16),
    (2, 1024, 16, 3, 3, 16), (3, 64, 16, 4, 3, 8), (2, 4096, 7, 3, 1, 4),
    (2, 64, 31, 2, 5, 8), (5, 256, 7, 2, 1, 64), (2, 4, 7, 2, 1, 5),
    (2, 256, 8, 4, 2, 7), (3, 1024, 11, 3, 2, 5), (2, 2048, 10, 4, 2, 6),
    (2, 1024, 16, 4, 3, 9), (3, 256, 7, 3, 1, 5)])
def test_rotdig64_kernel(dev, ks1, n, bl, l, n_sub, b):
    """K4 at the int4 configuration's shape, the three cases of
    tests/test_bootstrap_mxu.py's u64 kernel test, prefixes of 48, 62 and 64
    bits (beyond the TPU kernel), N = 4 and N = 4096; around the switch from
    the 64-bit to the 32-bit digit state, prefixes of 32 (all on 32 bits),
    33 and 40 (one level on 64 bits) and 64 (two), through the generic
    instance; the unrolled bl 7 l 3 at N = 256; N = 2048; and B * (k+1)
    rows that are not a multiple of the rows a block (14, 15, 18)."""
    plan = _plan(ks1, n, bl, l, n_sub, bits=64)
    rng = np.random.default_rng(7 * n + b)
    acc, a_hat = _u64(rng, (ks1, b, n), dev), _degrees(rng, n, b, dev)
    before = bsx.rotdig64.launches
    got = bsx.rotdig64(plan, acc, a_hat)
    assert bsx.rotdig64.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsx.rotdig64_plain(plan, acc, a_hat))


@pytest.mark.parametrize("ks1,n,bl,l,n_sub,drop,b", [
    (5, 256, 7, 2, 1, 0, 64), (3, 512, 8, 2, 2, 0, 33), (2, 1024, 7, 3, 1, 0, 8),
    (3, 64, 7, 2, 1, 1, 8)])
def test_rotdig_recombine_kernel(dev, ks1, n, bl, l, n_sub, drop, b):
    plan = _plan(ks1, n, bl, l, n_sub, drop)
    rng = np.random.default_rng(3 * n + b)
    acc, a_hat = _u32(rng, (ks1, b, n), dev), _degrees(rng, n, b, dev)
    s = _u32(rng, (b, ks1 * plan.limbs_used * n), dev)
    acc_want, d8_want = bsx.rotdig_recombine_plain(plan, s, acc, a_hat)
    acc_got, d8_got = bsx.rotdig_recombine(plan, s, acc, a_hat)
    torch.cuda.synchronize()
    assert torch.equal(acc_got, acc_want) and torch.equal(d8_got, d8_want)
    # in place, as the deferred blind-rotation loop calls it
    before = bsx.rotdig_recombine.launches
    bsx.rotdig_recombine(plan, s, acc, a_hat, acc_out=acc, d8_out=d8_got)
    assert bsx.rotdig_recombine.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_want) and torch.equal(d8_got, d8_want)


@pytest.mark.parametrize("m,k,n", [(5, 2524, 13), (16, 64, 64), (17, 40, 24),
                                   (17, 64, 64), (100, 6144, 2348),
                                   (64, 2560, 5120)])
def test_int_mm_padding_is_exact(dev, m, k, n):
    rng = np.random.default_rng(m * k)
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, size=(k, n), dtype=np.int8))
    got = bsx.int_mm(a.to(dev), b.to(dev)).cpu()
    assert torch.equal(got, torch._int_mm(a, b))


@pytest.mark.parametrize("k,n,bl,l,b", [(1, 128, 8, 2, 20), (4, 256, 7, 2, 40)])
def test_blind_rotation_on_gpu_matches_cpu(dev, k, n, bl, l, b):
    cfg = bs.ServerConfig(lwe_dimension=12, glwe_dimension=k, polynomial_size=n,
                          pbs_base_log=bl, pbs_level=l, ks_base_log=2, ks_level=5)
    rng = np.random.default_rng(k * n)
    bsk = rng.integers(0, 1 << 32, size=(12, l, k + 1, k + 1, n), dtype=np.uint32)
    rings = torus.from_numpy(bsx.bsk_to_mxu(bsk, cfg))
    lut = _u32(rng, (k + 1, n), "cpu")
    lwe = _u32(rng, (b, 13), "cpu")
    want = bsx.blind_rotate_mxu(cfg, rings, lut, lwe)
    got = bsx.blind_rotate_mxu(cfg, rings.to(dev), lut.to(dev), lwe.to(dev))
    assert torch.equal(got.cpu(), want)
    # both loop forms on the GPU
    plan = bsx.MxuPlan.from_config(cfg)
    lwe_d = lwe.to(dev)
    b_hat = bs.pbs_modulus_switch(lwe_d[:, -1], n)
    a_hats = bs.pbs_modulus_switch(lwe_d[:, :-1], n).T.contiguous()
    acc0 = polynomial.negacyclic_monomial_div(
        lut.to(dev)[:, None, :].expand(-1, b, -1), b_hat[None, :]).contiguous()
    for scan in (bsx._plain_scan, bsx._deferred_scan):
        acc = scan(plan, rings.to(dev), acc0, a_hats)
        assert torch.equal(acc.permute(1, 0, 2).cpu(), want)


def test_gates_on_gpu_match_cpu(dev):
    tiny = BooleanParameters(16, 1, 128, StandardDev(2.0 ** -20),
                             StandardDev(2.0 ** -25), 8, 2, 4, 3)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3,
                                device=dev)
    sks = dataclasses.replace(sks, backend="mxu")   # "auto" picks ntt on u32
    cpu = sks.to("cpu")
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(0, 2, size=40).astype(bool) for _ in range(3))
    ca, cb, cc = (cks.encrypt(v, mask_seed=5 + i, noise_seed=9 + i)
                  for i, v in enumerate((a, b, c)))
    for gate, want in [("and_", a & b), ("xor", a ^ b), ("nand", ~(a & b))]:
        got = getattr(sks, gate)(ca, cb)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), getattr(cpu, gate)(ca, cb))
        np.testing.assert_array_equal(cks.decrypt(got), want)
    got = sks.mux(ca, cb, cc)
    assert torch.equal(got.cpu(), cpu.mux(ca, cb, cc))
    np.testing.assert_array_equal(cks.decrypt(got), np.where(a, b, c))


@pytest.mark.parametrize("bl,l,drop", [(7, 3, 0), (7, 3, 2), (10, 3, 0)])
def test_u64_blind_rotation_on_gpu_matches_cpu(dev, bl, l, drop):
    cfg = bs.ServerConfig(lwe_dimension=10, glwe_dimension=1,
                          polynomial_size=256, pbs_base_log=bl, pbs_level=l,
                          ks_base_log=2, ks_level=8, bits=64,
                          mxu_limb_drop=drop)
    rng = np.random.default_rng(bl + drop)
    bsk = rng.integers(0, 1 << 64, size=(10, l, 2, 2, 256), dtype=np.uint64)
    rings = torus.from_numpy(bsx.bsk_to_mxu(bsk, cfg))
    lut = torus.from_numpy(rng.integers(0, 1 << 64, size=(2, 256),
                                        dtype=np.uint64))
    lwe = torus.from_numpy(rng.integers(0, 1 << 64, size=(40, 11),
                                        dtype=np.uint64))
    want = bsx.bootstrap_mxu(cfg, rings, lut, lwe)
    before = bsx.rotdig64.launches
    got = bsx.bootstrap_mxu(cfg, rings.to(dev), lut.to(dev), lwe.to(dev))
    assert bsx.rotdig64.launches == before + 10
    assert torch.equal(got.cpu(), want)


# -- the Nussbaumer backend: K5, K6, K7 and K1 on its rings ---------------------


def _nuss_plan(ks1, n, l, bl=7, lv=2, bits=32):
    cfg = bs.ServerConfig(lwe_dimension=4, glwe_dimension=ks1 - 1,
                          polynomial_size=n, pbs_base_log=bl, pbs_level=lv,
                          ks_base_log=2, ks_level=3, bits=bits)
    return bsn.NussPlan.from_config(cfg, l)


def _dot_output(rng, plan, b, dev):
    s = rng.integers(-(1 << 31), 1 << 31, size=(
        plan.two_l, b, plan.glwe_size * plan.limbs_used * plan.m))
    s[0, 0, :] = 2 ** 31 - 1                    # int32 extremes
    s[-1, -1, :] = -(2 ** 31)
    return torch.from_numpy(s.astype(np.int32)).to(dev)


# (k+1, N, L, B): every L of the envelope (2..32) and K5 / K6's block
# geometries: several polynomials a block (root 1: the TFHE_LIB ring at
# B = 2048 and 2047, a partial last block; L = 2, 4 at small M), one whole
# polynomial a block (root 4, 8, 16), and a polynomial over a cluster of 2,
# 4, 8 and 16 blocks (the N = 8192 / 16384 engine chunkings at L = 32, root
# 8 and 16; L = 16 at N = 16384; L = 2 at N = 8192 and 16384, 1024 threads)
NUSS_SHAPES = [(2, 64, 2, 5), (1, 512, 2, 3), (1, 8192, 2, 2), (1, 16384, 2, 1),
               (3, 256, 4, 3), (2, 128, 4, 7), (2, 1024, 8, 3), (2, 2048, 16, 2),
               (1, 16384, 16, 2), (2, 1024, 32, 4), (2, 1024, 32, 2048),
               (2, 1024, 32, 2047), (2, 8192, 32, 3), (2, 16384, 32, 2),
               (1, 4096, 32, 3)]


@pytest.mark.parametrize("ks1,n,l,b", NUSS_SHAPES)
@pytest.mark.parametrize("bits", [32, 64])
def test_recombine_inv_kernels(dev, ks1, n, l, b, bits):
    plan = _nuss_plan(ks1, n, l, bits=bits)
    s = _dot_output(np.random.default_rng(n + l + bits), plan, b, dev)
    kernel, plain = ((bsn.recombine_inv, bsn.recombine_inv_plain) if bits == 32
                     else (bsn.recombine_inv64, bsn.recombine_inv64_plain))
    before = kernel.launches
    got = kernel(plan, s)
    assert kernel.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, plain(plan, s))


@pytest.mark.parametrize("ks1,n,l,bl,lv,b", [
    (2, 64, 2, 7, 2, 5), (3, 256, 4, 5, 3, 4), (2, 1024, 32, 7, 3, 3),
    (2, 8192, 32, 2, 3, 3), (2, 8192, 32, 7, 3, 2), (2, 16384, 32, 2, 3, 2),
    (2, 512, 16, 16, 2, 3)])
@pytest.mark.parametrize("bits", [32, 64])
def test_rotdig_fwd_nuss_kernel(dev, ks1, n, l, bl, lv, b, bits):
    """K7 on both tori: n_sub 1, 2 (bl 7 at L=32) and 3 (bl 16 at L=16),
    degrees 0, N, 2N-1 and 2N, u64 rows seeded with word-boundary values."""
    plan = _nuss_plan(ks1, n, l, bl, lv, bits)
    rng = np.random.default_rng(n + bl + bits)
    shape = (ks1, b, l, n // l)
    acc = (_u32(rng, shape, dev) if bits == 32
           else _u64(rng, (ks1, b, n), dev).view(shape))
    a_hat = _degrees(rng, n, b, dev)
    before = bsn.rotdig_fwd_nuss.launches
    got = bsn.rotdig_fwd_nuss(plan, acc, a_hat)
    assert bsn.rotdig_fwd_nuss.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsn.rotdig_fwd_nuss_plain(plan, acc, a_hat))


@pytest.mark.parametrize("n_words,hi_drop,ks1,m", [(2, 3, 2, 256), (3, 3, 2, 256),
                                                   (3, 3, 2, 512), (2, 3, 3, 32)])
def test_build_tables_nuss_rings(dev, n_words, hi_drop, ks1, m):
    """K1 on the Nussbaumer rings: 2 or 3 word planes, high limbs dropped."""
    rings = _u32(np.random.default_rng(m + n_words), (12, ks1 * n_words, 2 * m),
                 dev)
    before = bsx.build_tables.launches
    got = bsx.build_tables(rings, m, 0, n_words, hi_drop)
    assert bsx.build_tables.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsx.build_tables_plain(rings, m, 0, n_words, hi_drop))


@pytest.mark.parametrize("bits,n,l,bl,lv", [(32, 256, 8, 7, 2), (64, 256, 8, 10, 2),
                                            (32, 1024, 32, 2, 3)])
def test_nuss_blind_rotation_on_gpu_matches_cpu(dev, bits, n, l, bl, lv):
    cfg = bs.ServerConfig(lwe_dimension=6, glwe_dimension=1, polynomial_size=n,
                          pbs_base_log=bl, pbs_level=lv, ks_base_log=2,
                          ks_level=5, bits=bits)
    rng = np.random.default_rng(bits + n)
    dt = np.uint32 if bits == 32 else np.uint64
    bsk = rng.integers(0, np.iinfo(dt).max, size=(6, lv, 2, 2, n), dtype=dt,
                       endpoint=True)
    rings = bsn.bsk_to_nuss(bsk, cfg, l)
    assert torch.equal(bsn.bsk_to_nuss(bsk, cfg, l, device=dev).cpu(), rings)
    lut = torus.from_numpy(rng.integers(0, np.iinfo(dt).max, size=(2, n),
                                        dtype=dt, endpoint=True))
    lwe = torus.from_numpy(rng.integers(0, np.iinfo(dt).max, size=(40, 7),
                                        dtype=dt, endpoint=True))
    want = bsn.blind_rotate_nuss(cfg, rings, lut, lwe, l=l)
    bsn.reset_launch_counts()
    got = bsn.blind_rotate_nuss(cfg, rings.to(dev), lut.to(dev), lwe.to(dev), l=l)
    counts = bsn.launch_counts()
    assert counts["rotdig_fwd_nuss"] == 6
    assert counts["recombine_inv" if bits == 32 else "recombine_inv64"] == 6
    assert torch.equal(got.cpu(), want)


# K7 beyond phase A's shapes: root = 1 (M = L) with 2L < 32 lanes a class
# group, the TFHE_LIB ring at B = 2048 (8 polynomials a block, a partial
# last block), M = 2048 (several classes a lane group), a u64 state wider
# than 32 bits, and N = 16384 with that state and n_sub 3, whose sub-digit
# planes are staged one at a time
K7_SHAPES = [(2, 64, 8, 7, 2, 5, 32), (2, 256, 16, 7, 2, 3, 32),
             (2, 1024, 32, 7, 3, 2048, 32), (2, 1024, 32, 7, 3, 2047, 64),
             (2, 16384, 8, 2, 3, 2, 32), (2, 16384, 8, 2, 3, 2, 64),
             (2, 8192, 32, 16, 3, 2, 64), (2, 16384, 32, 16, 3, 2, 64),
             (3, 4096, 16, 10, 2, 3, 64)]


@pytest.mark.parametrize("ks1,n,l,bl,lv,b,bits", K7_SHAPES)
def test_rotdig_fwd_nuss_kernel_shapes(dev, ks1, n, l, bl, lv, b, bits):
    plan = _nuss_plan(ks1, n, l, bl, lv, bits)
    rng = np.random.default_rng(n + l + bl + b)
    shape = (ks1, b, l, n // l)
    acc = (_u32(rng, shape, dev) if bits == 32
           else _u64(rng, (ks1, b, n), dev).view(shape))
    a_hat = _degrees(rng, n, b, dev)
    bsn.reset_launch_counts()
    got = bsn.rotdig_fwd_nuss(plan, acc, a_hat)
    assert bsn.launch_counts()["rotdig_fwd_nuss"] == 1
    assert list(bsn.rotdig_fwd_nuss.shapes.values()) == [1]
    torch.cuda.synchronize()
    assert torch.equal(got, bsn.rotdig_fwd_nuss_plain(plan, acc, a_hat))


# K1's column-major table at every word-plane count and limb drop, one
# matrix or one per group (the Nussbaumer frequencies)
K1_SHAPES = [(4, 2, 64, 1, 0, 0, 1), (10, 5, 256, 1, 1, 0, 1),
             (6, 2, 1024, 2, 0, 0, 1), (6, 2, 1024, 2, 2, 0, 1),
             (12, 2, 256, 2, 5, 0, 1), (12, 2, 16, 2, 0, 3, 4),
             (64 * 12, 2, 32, 2, 0, 3, 64), (12 * 8, 2, 256, 3, 0, 3, 8),
             (6, 3, 512, 3, 0, 3, 2), (2, 2, 4096, 1, 2, 0, 1)]


@pytest.mark.parametrize("r,ks1,n,nw,drop,hd,groups", K1_SHAPES)
def test_build_tables_column_major(dev, r, ks1, n, nw, drop, hd, groups):
    rings = _u32(np.random.default_rng(r + n + drop), (r, ks1 * nw, 2 * n), dev)
    nk = 4 * nw - drop - hd
    rows, cols = r // groups * n, ks1 * nk * n
    out = bsx.table_buffer(rows, cols, groups, device=dev)
    bsx.reset_launch_counts()
    got = bsx.build_tables(rings, n, drop, nw, hd, groups=groups, out=out)
    assert got is out and bsx.build_tables.launches == 1
    want = bsx.build_tables_plain(rings, n, drop, nw, hd)
    torch.cuda.synchronize()
    assert torch.equal(got, want.view(got.shape))
    # the product reads the column-major table as it is
    d8 = torch.from_numpy(np.random.default_rng(n).integers(
        -64, 65, size=(64, rows), dtype=np.int8)).to(dev)
    rhs = got if groups == 1 else got[-1]
    plain = want if groups == 1 else want.view(got.shape)[-1]
    assert torch.equal(bsx.int_mm(d8, rhs), bsx.int_mm(d8, plain.contiguous()))


def test_build_tables_refuses_a_row_major_out(dev):
    rings = _u32(np.random.default_rng(0), (2, 2, 128), dev)
    with pytest.raises(ValueError):
        bsx.build_tables(rings, 64, out=torch.empty((128, 512), dtype=torch.int8,
                                                    device=dev))


@pytest.mark.parametrize("m,k,n", [(5, 2524, 13), (17, 40, 24), (64, 2560, 5120)])
def test_int_mm_column_major_padding_is_exact(dev, m, k, n):
    rng = np.random.default_rng(m + k)
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, size=(n, k), dtype=np.int8)).t()
    got = bsx.int_mm(a.to(dev), b.to(dev)).cpu()
    assert torch.equal(got, torch._int_mm(a, b.contiguous()))


def test_nuss_beyond_the_kernel_envelope_runs_the_plain_composition(dev):
    """An explicit L with 2L > KERNEL_TWO_L_MAX takes the plain composition
    on the card, as the JAX package takes its XLA form there."""
    plan = _nuss_plan(2, 16384, 64, bl=2, lv=1)
    assert plan.two_l > bsn.KERNEL_TWO_L_MAX
    s = _dot_output(np.random.default_rng(1), plan, 2, dev)
    bsn.reset_launch_counts()
    got = bsn.recombine_inv(plan, s)
    assert bsn.launch_counts()["recombine_inv"] == 0
    assert torch.equal(got.cpu(), bsn.recombine_inv_plain(plan, s.cpu()))


def test_nuss_gates_on_gpu_match_cpu(dev):
    tiny = BooleanParameters(16, 1, 256, StandardDev(2.0 ** -25),
                             StandardDev(2.0 ** -30), 7, 2, 4, 3)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3,
                                device=dev)
    sks = dataclasses.replace(sks, backend="nuss")
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 2, size=40).astype(bool) for _ in range(2))
    ca, cb = (cks.encrypt(v, mask_seed=5 + i, noise_seed=9 + i)
              for i, v in enumerate((a, b)))
    got = sks.and_(ca, cb)
    assert torch.equal(got.cpu(), sks.to("cpu").and_(ca, cb))
    np.testing.assert_array_equal(cks.decrypt(got), a & b)


# -- the exact-NTT backend (K9) and the fused toeplitz step (K8) ----------------


def _ntt_cfg(k, n, bl=7, lv=2, bits=32, n_lwe=4):
    return bs.ServerConfig(lwe_dimension=n_lwe, glwe_dimension=k,
                           polynomial_size=n, pbs_base_log=bl, pbs_level=lv,
                           ks_base_log=2, ks_level=3, bits=bits)


# every N of the shared-memory layouts, and batches that are no multiple of
# the rows a block takes (1, 2, 3 or 4): B = 1, a few rows, 2048 + 3
NTT_CMUX_SHAPES = [(k, n, b) for n in (16, 256, 512, 1024, 8192, 16384)
                   for k in (1, 2, 4)
                   for b in ((1, 7, 2051) if n <= 1024 else (1, 3))]


@pytest.mark.parametrize("k,n,b", NTT_CMUX_SHAPES)
def test_ntt_cmux_kernel(dev, k, n, b):
    """K9 at every shared-memory layout: every digit polynomial of several
    rows in one block (up to N = 1024), the digits taken a few at a time
    (N = 8192), the columns split over blocks (N = 8192 with k = 4, N =
    16384), fewer butterflies than threads (N = 16); ragged row groups;
    degrees 0, 1, N-1, N, 2N-1 and 2N; `out` a fresh buffer."""
    cfg = _ntt_cfg(k, n)
    assert bsntt.kernel_applies(cfg)
    rng = np.random.default_rng(k * n + b)
    acc = _u32(rng, (k + 1, b, n), dev)
    a_hat = _degrees(rng, n, b, dev)
    ggsw = torch.from_numpy(np.stack([
        rng.integers(0, p, size=(2, k + 1, k + 1, n), dtype=np.uint32)
        for p in cfg.primes]).view(np.int32)).to(dev)
    before = bsntt.ntt_cmux.launches
    got = bsntt.ntt_cmux(cfg, acc, a_hat, ggsw, out=torch.empty_like(acc))
    assert bsntt.ntt_cmux.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bsntt.ntt_cmux_plain(cfg, acc, a_hat, ggsw))


# (base_log, limb_drop, N, B, in place): n_sub 1 (base_log 7) and 2
# (base_log 8), limb_drop 0-2 (n_kept 4, 3, 2), N = 64 (the smallest the
# tile takes) and 256, B = 1, 70 and 2048 + 17 (ragged row tiles)
FUSED_SHAPES = [(7, 0, 256, 70, True), (7, 1, 256, 70, True),
                (8, 0, 256, 70, True), (8, 1, 256, 70, True),
                (7, 2, 256, 70, False), (8, 2, 64, 70, True),
                (7, 0, 64, 1, False), (8, 1, 64, 1, True),
                (7, 0, 256, 2065, True), (8, 2, 256, 2065, False),
                (7, 1, 64, 2065, False)]


@pytest.mark.parametrize("bl,drop,n,b,in_place", FUSED_SHAPES)
def test_fused_cmux_kernel(dev, bl, drop, n, b, in_place):
    """K8 (int8 tensor cores) for limb_drop 0-2 and n_sub 1 (base_log 7)
    and 2 (base_log 8), ragged row tiles, updated in place (`out=acc`) or
    into a new tensor."""
    cfg = dataclasses.replace(_ntt_cfg(2, n, bl, 2), mxu_limb_drop=drop)
    plan = bsx.MxuPlan.from_config(cfg)
    assert plan.n_sub == (1 if bl == 7 else 2)
    rng = np.random.default_rng(bl + drop + n + b)
    acc = _u32(rng, (3, b, n), dev)
    d8 = torch.from_numpy(rng.integers(-128, 128, size=(b, plan.row_blocks * n),
                                       dtype=np.int8)).to(dev)
    rings = _u32(rng, (plan.row_blocks, 3, 2 * n), dev)
    want = bsx.fused_external_product_acc_plain(plan, acc, d8, rings)
    before = bsx.fused_external_product_acc.launches
    got = bsx.fused_external_product_acc(plan, acc, d8, rings,
                                         out=acc if in_place else None)
    assert bsx.fused_external_product_acc.launches == before + 1
    torch.cuda.synchronize()
    assert (got is acc) == in_place and torch.equal(got, want)


@pytest.mark.parametrize("k,n,bits", [(1, 256, 32), (4, 256, 32), (1, 512, 64)])
def test_ntt_blind_rotation_on_gpu_matches_cpu(dev, k, n, bits):
    """The ntt blind rotation on the card (K9 every step on the u32 torus,
    the torch composition on u64's three primes) against the CPU, key
    conversion on the card included."""
    cfg = _ntt_cfg(k, n, 7, 3 if bits == 64 else 2, bits, n_lwe=6)
    rng = np.random.default_rng(k + n + bits)
    dt = np.uint32 if bits == 32 else np.uint64
    bsk = rng.integers(0, np.iinfo(dt).max, size=(6, cfg.pbs_level, k + 1, k + 1, n),
                       dtype=dt, endpoint=True)
    spectra = bsk_to_ntt(bsk, cfg.primes, bits)
    assert torch.equal(bsk_to_ntt(bsk, cfg.primes, bits, device=dev).cpu(), spectra)
    lut = torus.from_numpy(rng.integers(0, np.iinfo(dt).max, size=(k + 1, n),
                                        dtype=dt, endpoint=True))
    lwe = torus.from_numpy(rng.integers(0, np.iinfo(dt).max, size=(40, 7),
                                        dtype=dt, endpoint=True))
    want = bsntt.blind_rotate(cfg, spectra, lut, lwe)
    before = bsntt.ntt_cmux.launches
    got = bsntt.blind_rotate(cfg, spectra.to(dev), lut.to(dev), lwe.to(dev))
    assert bsntt.ntt_cmux.launches == before + (6 if bits == 32 else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,n,bl,l,drop", [(1, 256, 7, 3, 0), (2, 512, 8, 2, 1)])
def test_fused_blind_rotation_on_gpu_matches_cpu(dev, k, n, bl, l, drop):
    cfg = dataclasses.replace(_ntt_cfg(k, n, bl, l, n_lwe=6), mxu_limb_drop=drop)
    rng = np.random.default_rng(n + drop)
    bsk = rng.integers(0, 1 << 32, size=(6, l, k + 1, k + 1, n), dtype=np.uint32)
    rings = torus.from_numpy(bsx.bsk_to_mxu(bsk, cfg))
    lut = _u32(rng, (k + 1, n), "cpu")
    lwe = _u32(rng, (70, 7), "cpu")
    want = bsx.blind_rotate_mxu(cfg, rings, lut, lwe)
    before = bsx.fused_external_product_acc.launches
    got = bsx.blind_rotate_mxu(cfg, rings.to(dev), lut.to(dev), lwe.to(dev),
                               fused=True)
    assert bsx.fused_external_product_acc.launches == before + 6
    assert torch.equal(got.cpu(), want)


def test_ntt_gates_on_gpu_match_cpu(dev):
    tiny = BooleanParameters(16, 1, 256, StandardDev(2.0 ** -25),
                             StandardDev(2.0 ** -30), 7, 2, 4, 3)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3,
                                device=dev)
    ntt = dataclasses.replace(sks, backend="ntt")
    cpu = ntt.to("cpu")
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(0, 2, size=40).astype(bool) for _ in range(3))
    ca, cb, cc = (cks.encrypt(v, mask_seed=5 + i, noise_seed=9 + i)
                  for i, v in enumerate((a, b, c)))
    for gate, want in [("and_", a & b), ("xor", a ^ b)]:
        got = getattr(ntt, gate)(ca, cb)
        assert torch.equal(got.cpu(), getattr(cpu, gate)(ca, cb))
        assert torch.equal(got, getattr(sks, gate)(ca, cb))
        np.testing.assert_array_equal(cks.decrypt(got), want)
    got = ntt.mux(ca, cb, cc)
    assert torch.equal(got.cpu(), cpu.mux(ca, cb, cc))
    np.testing.assert_array_equal(cks.decrypt(got), np.where(a, b, c))


@pytest.mark.parametrize("bits,n,k,bl,lv,b", [
    (32, 64, 1, 7, 2, 5), (32, 256, 2, 8, 2, 33), (32, 1024, 1, 7, 3, 100),
    (64, 64, 2, 8, 2, 5), (64, 1024, 1, 7, 3, 64)])
def test_external_product_and_cmux_mxu_on_gpu_match_cpu(dev, bits, n, k, bl,
                                                         lv, b):
    """One GGSW's external product and CMux (K1, the int8 product, the limb
    recombination) on the card, equal to the CPU's plain path."""
    cfg = bs.ServerConfig(lwe_dimension=1, glwe_dimension=k, polynomial_size=n,
                          pbs_base_log=bl, pbs_level=lv, ks_base_log=2,
                          ks_level=5, bits=bits)
    rng = np.random.default_rng(n + bl + bits)
    dt = np.uint32 if bits == 32 else np.uint64
    ggsw = rng.integers(0, np.iinfo(dt).max, size=(1, lv, k + 1, k + 1, n),
                        dtype=dt, endpoint=True)
    rings = torch.from_numpy(bsx.bsk_to_mxu(ggsw, cfg)[0].view(np.int32))
    ct0, ct1 = (torus.from_numpy(rng.integers(
        0, np.iinfo(dt).max, size=(b, k + 1, n), dtype=dt, endpoint=True))
        for _ in range(2))
    before = bsx.build_tables.launches
    got = bsx.external_product_mxu(cfg, rings.to(dev), ct1.to(dev))
    got_cmux = bsx.cmux_mxu(cfg, rings.to(dev), ct0.to(dev), ct1.to(dev))
    assert bsx.build_tables.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), bsx.external_product_mxu(cfg, rings, ct1))
    assert torch.equal(got_cmux.cpu(), bsx.cmux_mxu(cfg, rings, ct0, ct1))


def test_gate_pipeline_dp_tp_mxu_on_a_world_of_one_nccl(dev, tmp_path):
    """parallel/mesh.py on the card: a one-rank NCCL group (the tp loop is
    the single-device one, with no collective to run in a group of one),
    the output the unsharded call's bit for bit."""
    import torch.distributed as dist

    from concrete_tpu_torch.parallel import mesh as pmesh

    tiny = BooleanParameters(16, 1, 128, StandardDev(2.0 ** -20),
                             StandardDev(2.0 ** -25), 8, 2, 4, 3)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3,
                                device=dev)
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 2, size=64).astype(bool) for _ in range(2))
    lin = (torus.from_numpy(cks.encrypt(a, mask_seed=5, noise_seed=6), dev)
           + torus.from_numpy(cks.encrypt(b, mask_seed=7, noise_seed=8), dev))
    lin[:, -1] -= 1 << 29                                        # AND
    args = (sks.bsk_mxu, sks.ksk8, sks._lut(), lin)
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1, "cuda")
        got = pmesh.gate_pipeline_dp_tp_mxu(sks.cfg, mesh)(*args)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, bsx.bootstrap_keyswitch_mxu(sks.cfg, *args))
    np.testing.assert_array_equal(cks.decrypt(got), a & b)
