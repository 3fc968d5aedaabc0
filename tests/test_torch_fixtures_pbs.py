"""The port's PBS fixture against concrete_tpu's on the ntt backend
(tests/fixture_twins.py), bit for bit; the N=8192 Nussbaumer entry, which
the port runs alone (concrete_tpu's grid already runs it in
tests/test_fixtures.py). test_torch_fixtures_pbs_mxu.py takes the mxu and
nuss entries."""

import concrete_tpu_torch.fixtures as fx_t
from fixture_twins import N8192, SAMPLE_SIZE, check_twin, without_n8192


def test_twin_pbs_ntt(monkeypatch):
    entries = [p for p in without_n8192("PbsFixture") if p["backend"] == "ntt"]
    reports, calls, _ = check_twin(monkeypatch, "PbsFixture", entries)
    assert len(reports) == len(calls) == 3


def test_pbs_n8192_port_only():
    fx = fx_t.PbsFixture()
    fx.PARAMETERS = [p for p in fx.PARAMETERS if p["N"] == N8192]
    (report,) = fx.stress(1, SAMPLE_SIZE, device="cpu")
    assert report.passed, report.detail
    assert (report.repetitions, report.sample_size) == (1, 8)
