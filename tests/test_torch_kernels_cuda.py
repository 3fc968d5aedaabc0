"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: these tests need an NVIDIA Hopper GPU and nvcc, and skip
anywhere else (the check runs inside a fixture, never at import). On a GPU
machine (where JAX, which tests/conftest.py imports, may be absent):
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Every comparison is exact (integer arithmetic mod 2^32 and 2^64, tolerance
0)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from concrete_tpu_torch import boolean, torus
from concrete_tpu_torch.core import bootstrap as bs
from concrete_tpu_torch.core import bootstrap_mxu as bsx
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
    _cuda.library()
    return torch.device("cuda")


def _u32(rng, shape, dev):
    return torus.from_numpy(
        rng.integers(0, 1 << 32, size=shape, dtype=np.uint32), dev)


def _degrees(rng, n, b, dev):
    a = rng.integers(0, 2 * n + 1, size=b).astype(np.int32)
    a[:min(b, 4)] = [0, n, 2 * n - 1, 2 * n][:min(b, 4)]
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
    (2, 64, 31, 2, 5, 8), (5, 256, 7, 2, 1, 64), (2, 4, 7, 2, 1, 5)])
def test_rotdig64_kernel(dev, ks1, n, bl, l, n_sub, b):
    """K4 at the int4 configuration's shape, the three cases of
    tests/test_bootstrap_mxu.py's u64 kernel test, prefixes of 48, 62 and 64
    bits (beyond the TPU kernel), N = 4 and N = 4096."""
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
