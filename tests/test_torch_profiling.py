"""The bound arithmetic that moved from chip_smoke.py into profiling.py gives
the phase-A bounds PERF.md's kernel table holds (to 0.1 us), and the
roofline helpers return what they document, on the CPU (shapes only: the
tensors are on the meta device)."""

import dataclasses

import pytest
import torch

from concrete_tpu_torch import profiling as pf
from concrete_tpu_torch.core import bootstrap as bs
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.params import (
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)

CFGS = [bs.ServerConfig.from_boolean_parameters(p)
        for p in (TPU128_PARAMETERS, DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS)]
ENGINE = bs.ServerConfig(lwe_dimension=100, glwe_dimension=1,
                         polynomial_size=8192, pbs_base_log=2, pbs_level=3,
                         ks_base_log=2, ks_level=5)


def _t(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _us(inputs, outputs, op_s=None):
    return round(pf.bound_ms(inputs, outputs, op_s)[0] * 1e3, 1)


def test_k9_bounds():
    got = []
    for cfg, b in [(c, 2048) for c in CFGS] + [(ENGINE, 256)]:
        n, ks1 = cfg.polynomial_size, cfg.glwe_size
        acc = _t((ks1, b, n), torch.int32)
        spectra = _t((2, cfg.pbs_level, ks1, ks1, n), torch.int32)
        op_s = pf.int_ops_s(*pf.ntt_cmux_work(cfg, b)[1])
        got.append(_us((acc, _t((b,), torch.int32), spectra), (acc,), op_s))
    assert got == [29.7, 36.5, 67.8, 84.4]


def test_k8_bounds():
    got = []
    for cfg in CFGS + [dataclasses.replace(CFGS[0], mxu_limb_drop=1)]:
        p, b = bsx.MxuPlan.from_config(cfg), 2048
        n, ks1, r = p.polynomial_size, p.glwe_size, p.row_blocks
        macs = b * r * n * ks1 * p.limbs_used * n
        acc = _t((ks1, b, n), torch.int32)
        got.append(_us((acc, _t((b, r * n), torch.int8),
                        _t((r, ks1, 2 * n), torch.int32)), (acc,),
                       2 * macs / pf.INT8_TENSOR_OPS_PER_S))
    assert got == [27.1, 78.1, 104.2, 20.3]


def test_k1_bounds():
    got = []
    for cfg in CFGS:
        p = bsx.MxuPlan.from_config(cfg)
        n, ks1, r = p.polynomial_size, p.glwe_size, p.row_blocks
        got.append(_us((_t((r, ks1, 2 * n), torch.int32),),
                       (_t((r * n, ks1 * 4 * n), torch.int8),)))
    assert got == [3.9, 11.3, 15.1]


def test_k4_bounds():
    got = []
    b, n, ks1 = 2048, 1024, 2
    for bl, lv in [(7, 3), (10, 3), (16, 2), (16, 3)]:
        p = bsx.MxuPlan.from_config(bs.ServerConfig(
            lwe_dimension=630, glwe_dimension=1, polynomial_size=n,
            pbs_base_log=bl, pbs_level=lv, ks_base_log=2, ks_level=8, bits=64))
        per_coef = pf.rotdig64_work(p)
        op_s = pf.int_ops_s(*(b * ks1 * n * w for w in per_coef))
        got.append(_us((_t((ks1, b, n), torch.int64), _t((b,), torch.int32)),
                       (_t((b, p.row_blocks * n), torch.int8),), op_s))
    assert got == [13.8, 17.5, 17.5, 21.3]


def test_bound_by_and_gemm_ops():
    ms, by = pf.bound_ms((_t((1 << 20,), torch.int32),), (_t((4,), torch.int8),))
    assert by == "bytes" and ms == pytest.approx((4 * (1 << 20) + 4) / 3.35e12 * 1e3)
    plan = bsx.MxuPlan.from_config(CFGS[0])
    assert pf.mxu_gemm_ops(plan, 2) == (2 * 630 * 2 * 10 * 256 * 5 * 4 * 256)


def test_report_pbs_efficiency_returns_its_dict():
    r = pf.report_pbs_efficiency(CFGS[0], 2048, 0.1)
    assert set(r) == {"lane_ops", "int8_ops", "hbm_bytes", "speed_of_light_s",
                      "measured_s", "efficiency"}
    sol = pf.pbs_roofline(CFGS[0], 2048).bound_seconds()
    assert r["speed_of_light_s"] == sol and r["efficiency"] == sol / 0.1
    # the PBS bound is n steps of the K9 step's work
    step = pf.int_ops_s(*pf.ntt_cmux_work(CFGS[0], 2048)[1])
    assert sol == pytest.approx(630 * step, rel=1e-12)
    assert pf.report_pbs_efficiency(CFGS[0], 2048, 0.0)["efficiency"] == 0.0


def test_rooflines_take_the_h100_rates():
    r = pf.Roofline("x", (64 * pf.SM_CLOCKS_PER_S, 0, 0))
    assert r.bound_seconds() == pytest.approx(1.0)
    r = pf.Roofline("y", hbm_bytes=3.35e12, int8_ops=1979e12 / 2)
    assert r.bound_seconds() == pytest.approx(1.0)
    assert r.bound_seconds(hbm_bytes_per_s=1.0) == pytest.approx(3.35e12)
    mxu = pf.mxu_external_product_roofline(630, 256, 5, 2, 1, 4, 2048)
    assert mxu.int8_ops == pf.mxu_gemm_ops(bsx.MxuPlan.from_config(CFGS[0]), 2048)
    ntt = pf.ntt_roofline(1024, 2, 2, 256)
    assert ntt.hbm_bytes == 2 * 2 * 256 * 1024 * 8 and ntt.lane_ops > 0


def test_median_and_measure_on_the_cpu():
    calls = []
    assert pf.measure(lambda x: calls.append(x), 3, reps=3) >= 0.0
    assert calls == [3] * 4
    assert pf.median_s(lambda: None, reps=3) >= 0.0
