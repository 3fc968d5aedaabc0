"""Run a fixture class of concrete_tpu and of the port side by side
(tests/test_torch_fixtures_*.py).

Both fixtures run with repetitions=1 and tests/test_fixtures.py's sample
size. The statistical checks of both `fixtures` modules are wrapped, in
the test only, so that every call records its samples, expected values,
predicted variance and arguments before it gives its verdict, and every
`run_one` call records its entry, seed and return value (concrete_tpu's
is None but for the truncation fixture's pooled statistic); the port's records must equal concrete_tpu's
bit for bit (variances to a relative 1e-12), and the reports must be equal
(name, parameters, repetitions, sample size, passed)."""

import numpy as np
import pytest
import torch

import concrete_tpu.fixtures as fx_jax
import concrete_tpu_torch.fixtures as fx_t
from concrete_tpu_torch import torus

SAMPLE_SIZE = 100   # tests/test_fixtures.py's
CHECKS = ("assert_noise_bounded", "assert_noise_distribution")
N8192 = 8192        # the heavyweight Nussbaumer entry: the port runs it alone


def _host(x, bits: int) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return torus.to_numpy(x)
    return np.asarray(x).astype(torus.UNSIGNED[bits])


def run_recorded(monkeypatch, mod, cls_name: str, params=None, **stress_kw):
    """(reports, recorded check calls, recorded run_one calls) of one
    fixture class of `mod`."""
    calls, runs = [], []
    for name in CHECKS:
        orig = getattr(mod, name)

        def rec(samples, expected, predicted, bits, *args, _orig=orig,
                _name=name, **kw):
            calls.append((_name, _host(samples, bits), _host(expected, bits),
                          predicted.get_variance(), bits, args,
                          tuple(sorted(kw.items()))))
            return _orig(samples, expected, predicted, bits, *args, **kw)

        monkeypatch.setattr(mod, name, rec)
    fx = getattr(mod, cls_name)()
    if params is not None:
        fx.PARAMETERS = params
    run_one = fx.run_one

    def rec_run(params, rep_seed):
        out = run_one(params, rep_seed)
        runs.append((params, rep_seed, out))
        return out

    fx.run_one = rec_run
    return fx.stress(1, SAMPLE_SIZE, **stress_kw), calls, runs


def _report_key(r):
    return (r.name, r.parameters, r.repetitions, r.sample_size, r.passed)


def check_twin(monkeypatch, cls_name: str, params=None):
    """The port's fixture against concrete_tpu's; returns the port's
    reports, check records and run_one records."""
    reports_j, calls_j, runs_j = run_recorded(monkeypatch, fx_jax, cls_name,
                                              params)
    reports_t, calls_t, runs_t = run_recorded(monkeypatch, fx_t, cls_name,
                                              params, device="cpu")
    assert [_report_key(r) for r in reports_t] == \
        [_report_key(r) for r in reports_j]
    failed = [(r.parameters, r.detail) for r in reports_t if not r.passed]
    assert not failed, failed
    assert len(calls_t) == len(calls_j)
    for i, (a, b) in enumerate(zip(calls_j, calls_t)):
        name, samples, expected, variance, bits, args, kw = a
        assert b[0] == name and b[4] == bits and b[5:] == a[5:], i
        np.testing.assert_array_equal(b[1], samples, err_msg=f"{name} #{i}")
        np.testing.assert_array_equal(b[2], expected, err_msg=f"{name} #{i}")
        assert b[3] == pytest.approx(variance, rel=1e-12, abs=0), i
    assert [r[:2] for r in runs_t] == [r[:2] for r in runs_j]
    for (_, _, out_j), (_, _, out_t) in zip(runs_j, runs_t):
        if out_j is not None:   # the truncation fixture's pooled statistic
            assert out_t == out_j
    return reports_t, calls_t, runs_t


def without_n8192(cls_name: str) -> list:
    return [p for p in getattr(fx_jax, cls_name).PARAMETERS
            if p.get("N") != N8192]
