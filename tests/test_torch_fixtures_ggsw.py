"""The port's external-product (ntt and mxu backends), GGSW encryption and
GLWE list encryption fixtures against concrete_tpu's, bit for bit
(tests/fixture_twins.py)."""

import pytest

from fixture_twins import check_twin


def test_twin_external_product(monkeypatch):
    reports, calls, _ = check_twin(monkeypatch, "ExternalProductFixture")
    assert {r.parameters["backend"] for r in reports} == {"ntt", "mxu"}


@pytest.mark.parametrize("cls_name", ["GgswEncryptionFixture",
                                      "GlweListEncryptFixture"])
def test_twin(monkeypatch, cls_name):
    check_twin(monkeypatch, cls_name)
