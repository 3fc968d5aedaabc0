"""The port's LWE-level fixtures and the remaining GLWE ones against
concrete_tpu's, bit for bit (tests/fixture_twins.py); the fixture list and
run_all; and the two testing.py modules' verdicts on the same inputs,
failing ones included."""

import numpy as np
import pytest

import concrete_tpu.fixtures as fx_jax
import concrete_tpu.testing as testing_jax
import concrete_tpu_torch.fixtures as fx_t
import concrete_tpu_torch.testing as testing_t
from concrete_tpu.dispersion import StandardDev as StdJax
from concrete_tpu_torch.dispersion import StandardDev as StdT
from fixture_twins import check_twin

CLASSES = ["LweEncryptDecryptFixture", "GlweEncryptDecryptFixture",
           "LweKeyswitchFixture", "PackingKeyswitchFixture",
           "LweAffineTransformFixture", "SampleExtractFixture",
           "LweTrivialEncryptFixture", "GlweTrivialEncryptFixture",
           "LweListEncryptFixture", "GswExternalProductFixture",
           "LweAddFixture", "LweSubOppositeFixture", "LwePlaintextArithFixture",
           "LweCleartextMulFixture", "PackingKeyswitchBatchFixture",
           "LweKeyDistributionsFixture", "ModulusSwitchFixture",
           "CreationRetrievalFixture"]


@pytest.mark.parametrize("cls_name", CLASSES)
def test_twin(monkeypatch, cls_name):
    check_twin(monkeypatch, cls_name)


def test_fixture_list_matches_jax():
    """Every class of concrete_tpu's grid has a twin test in one of the
    test_torch_fixtures_* files, in the same ALL_FIXTURES order, with the
    same entries, repetitions and sample sizes."""
    names_j = [c.__name__ for c in fx_jax.ALL_FIXTURES]
    assert [c.__name__ for c in fx_t.ALL_FIXTURES] == names_j
    for cj, ct in zip(fx_jax.ALL_FIXTURES, fx_t.ALL_FIXTURES):
        assert (ct.name, ct.PARAMETERS, ct.REPETITIONS, ct.SAMPLE_SIZE) == \
            (cj.name, cj.PARAMETERS, cj.REPETITIONS, cj.SAMPLE_SIZE)


def test_run_all_needs_a_device_here(monkeypatch):
    """run_all resolves device=None to CUDA: without a GPU it raises before
    any fixture runs, instead of falling back to the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fx_t.run_all(repetitions=1, sample_size=4)


def _verdict(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("bits", [32, 64])
def test_testing_verdicts_match_jax(bits):
    rng = np.random.default_rng(bits)
    dt = np.uint32 if bits == 32 else np.uint64
    for size in (8, 100, 2000):
        expected = rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(dt)
        for true_log in (-20.0, -12.0):
            noise = np.round(rng.normal(0.0, 2.0 ** (true_log + bits), size))
            samples = (expected + noise.astype(np.int64).astype(dt)).astype(dt)
            for pred_log in (true_log - 3.0, true_log - 0.4, true_log,
                             true_log + 2.0):
                sj, st = StdJax(2.0 ** pred_log), StdT(2.0 ** pred_log)
                for name, kw in (("assert_delta_std_dev", {}),
                                 ("assert_noise_bounded", {"slack_bits": 0.5}),
                                 ("assert_noise_distribution",
                                  {"seed": size})):
                    got = _verdict(getattr(testing_t, name), samples, expected,
                                   st, bits, **kw)
                    want = _verdict(getattr(testing_jax, name), samples,
                                    expected, sj, bits, **kw)
                    assert got == want, (name, size, true_log, pred_log)
    a = rng.normal(size=300)
    b = rng.normal(0.3, 1.0, size=200)
    assert testing_t._ks_statistic(a, b) == testing_jax._ks_statistic(a, b)
