"""The port's PBS fixture on the mxu and nuss backends and the limb-drop
truncation fixture against concrete_tpu's (tests/fixture_twins.py), bit
for bit; the truncation fixture's pooled values too."""

import pytest

from fixture_twins import check_twin, without_n8192


@pytest.fixture(scope="module")
def truncation_twin():
    """The truncation fixture's twin run, once for the module: both tests
    below read it, so concrete_tpu's side runs (and compiles) once."""
    with pytest.MonkeyPatch.context() as mp:
        return check_twin(mp, "MxuTruncationNoiseFixture")


def test_twin_pbs_mxu_nuss(monkeypatch):
    entries = [p for p in without_n8192("PbsFixture") if p["backend"] != "ntt"]
    reports, calls, _ = check_twin(monkeypatch, "PbsFixture", entries)
    assert {r.parameters["backend"] for r in reports} == {"mxu", "nuss"}
    assert len(reports) == len(calls) == 4


def test_twin_mxu_truncation_noise(truncation_twin):
    reports, _, _ = truncation_twin
    assert reports and all(r.passed for r in reports)


def test_mxu_truncation_samples_match_jax(truncation_twin):
    """run_one's mean squared phase difference (the pooled statistic) is
    the same float in both packages, for every entry at rep_seed 7 (the
    twin's one repetition); check_twin compares each with concrete_tpu's."""
    reports, _, runs = truncation_twin
    assert [(r[0], r[1]) for r in runs] == [(r.parameters, 7) for r in reports]
    assert all(isinstance(r[2], float) and r[2] > 0 for r in runs)
