"""The port's design module against concrete_tpu's: the model-free parts
(security curve, gate error, far tail, keyswitch search, bootstrap
precision, RLWE recommendation) give the same numbers; `search` with one
stub cost object ranks the same candidates in the same order; the card's
cost model (GpuCostModel) reproduces the K9 times it was fitted on."""

import math

import pytest

from concrete_tpu import design as design_jax
from concrete_tpu.dispersion import StandardDev as StdJax
from concrete_tpu.params import BooleanParameters as ParamsJax
from concrete_tpu_torch import design
from concrete_tpu_torch.params import (
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)

PRESETS = (DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS, TPU128_PARAMETERS)


@pytest.mark.parametrize("dim", [256, 630, 700, 1024, 1500, 2048, 8192])
@pytest.mark.parametrize("security", [128, 80])
def test_security_curve_matches_jax(dim, security):
    assert design.min_log2_std(dim, security) == \
        design_jax.min_log2_std(dim, security)


def test_security_curve_range():
    assert design.min_log2_std(630) == -14.0
    assert design.min_log2_std(8192) == -105.0
    with pytest.raises(ValueError):
        design.min_log2_std(100)


def _jax_params(p):
    return ParamsJax(
        lwe_dimension=p.lwe_dimension, glwe_dimension=p.glwe_dimension,
        polynomial_size=p.polynomial_size,
        lwe_modular_std_dev=StdJax(p.lwe_modular_std_dev.std_dev),
        glwe_modular_std_dev=StdJax(p.glwe_modular_std_dev.std_dev),
        pbs_base_log=p.pbs_base_log, pbs_level=p.pbs_level,
        ks_base_log=p.ks_base_log, ks_level=p.ks_level)


@pytest.mark.parametrize("p", PRESETS, ids=["DEFAULT", "TFHE_LIB", "TPU128"])
def test_gate_error_matches_jax(p):
    for worst in (True, False):
        for level in (None, 1):
            got = design.gate_error_log2(p, worst_chain=worst, level=level)
            want = design_jax.gate_error_log2(_jax_params(p), worst_chain=worst,
                                              level=level)
            assert got == pytest.approx(want, rel=1e-12)
    # TFHE_LIB sits past erfc's underflow: the asymptotic branch
    if p is TFHE_LIB_PARAMETERS:
        assert -1000 < design.gate_error_log2(p) < -150


@pytest.mark.parametrize("target", [-13.0, -25.0, -40.0, -200.0])
def test_erfc_tail_matches_jax(target):
    assert design._erfc_tail_x(target) == design_jax._erfc_tail_x(target)
    assert math.erfc(design._erfc_tail_x(target)) <= 2.0 ** target


def test_ks_search_matches_jax():
    for args in [(1024, 2.0 ** -14, 2.0 ** -14.5), (512, 2.0 ** -11, 2.0 ** -20),
                 (2048, 2.0 ** -17, 2.0 ** -30)]:
        assert design._ks_search(*args) == design_jax._ks_search(*args)


def test_max_bootstrap_precision_and_recommend_rlwe_match_jax():
    for n in (256, 512, 1024, 2048, 4096):
        for lwe in (256, 630):
            assert design.max_bootstrap_precision(n, lwe) == \
                design_jax.max_bootstrap_precision(n, lwe)
    for bits in range(1, 7):
        got, want = design.recommend_rlwe(bits), design_jax.recommend_rlwe(bits)
        assert (got.polynomial_size, got.dimension) == \
            (want.polynomial_size, want.dimension)
    for mod in (design, design_jax):
        with pytest.raises(ValueError):
            mod.recommend_rlwe(12)


class StubCost:
    """A cost object both packages take: rewards small k*N and low levels."""

    def gates_per_s(self, p, batch):
        return batch * 1e6 / (p.lwe_dimension * p.pbs_level * p.glwe_dimension
                              * p.polynomial_size * (1 + p.pbs_base_log % 3))


def test_search_with_stub_cost_matches_jax():
    kw = dict(n_range=range(600, 661, 10), shapes=((4, 256), (2, 512), (1, 1024)),
              levels=range(1, 4), base_logs=range(5, 9), cost=StubCost())
    got, want = design.search(**kw), design_jax.search(**kw)
    assert len(got) == len(want) > 5
    for a, b in zip(got, want):
        pa, pb = a.params, b.params
        assert (pa.lwe_dimension, pa.glwe_dimension, pa.polynomial_size,
                pa.pbs_base_log, pa.pbs_level, pa.ks_base_log, pa.ks_level) == \
            (pb.lwe_dimension, pb.glwe_dimension, pb.polynomial_size,
             pb.pbs_base_log, pb.pbs_level, pb.ks_base_log, pb.ks_level)
        assert a.gates_per_s == b.gates_per_s
        assert a.err_log2 == pytest.approx(b.err_log2, rel=1e-12)


def test_infeasible_target_returns_empty():
    assert design.search(target_err_log2=-500.0, n_range=range(560, 581, 10),
                         shapes=((1, 1024),), levels=range(1, 2),
                         base_logs=range(3, 4)) == []


def test_gpu_cost_model_reproduces_its_anchors():
    model = design.GpuCostModel()
    for p, us in design.K9_ANCHORS:
        assert model.step_us(p, 2048) == pytest.approx(us, rel=0.08)
    # the fitted share is the geometric mean: the anchors' errors cancel
    logs = [math.log(model.step_us(p, 2048) / us) for p, us in design.K9_ANCHORS]
    assert abs(sum(logs)) < 1e-9
    p, ms = design.KS_ANCHOR
    assert model.keyswitch_us(p, 2048) == pytest.approx(ms * 1e3, rel=1e-9)
    # a gate: n steps plus the keyswitch; batch-linear bound, so gates/s is
    # flat in the batch
    rate = model.gates_per_s(TPU128_PARAMETERS, 2048)
    assert rate == pytest.approx(model.gates_per_s(TPU128_PARAMETERS, 4096),
                                 rel=1e-9)
    assert 15_000 < rate < 35_000


def test_search_default_cost_is_the_gpu_model():
    cands = design.search(n_range=range(630, 651, 10),
                          shapes=((4, 256), (2, 512)), levels=range(2, 4),
                          base_logs=range(6, 8))
    assert cands and all(c.err_log2 <= -25.0 for c in cands)
    rates = [c.gates_per_s for c in cands]
    assert rates == sorted(rates, reverse=True)
    model = design.GpuCostModel()
    assert cands[0].gates_per_s == model.gates_per_s(cands[0].params, 2048)
