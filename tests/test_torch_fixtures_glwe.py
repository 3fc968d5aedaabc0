"""The port's GLWE NTT-conversion and GLWE arithmetic fixtures against
concrete_tpu's, bit for bit (tests/fixture_twins.py)."""

import pytest

from fixture_twins import check_twin


@pytest.mark.parametrize("cls_name", ["GlweNttConversionFixture",
                                      "GlweArithFixture"])
def test_twin(monkeypatch, cls_name):
    check_twin(monkeypatch, cls_name)
