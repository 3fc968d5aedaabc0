"""The port's u64 PBS, u64 keyswitch and multi-LUT fixtures against
concrete_tpu's, bit for bit (tests/fixture_twins.py)."""

import pytest

from fixture_twins import check_twin


@pytest.mark.parametrize("cls_name", ["U64PbsFixture", "U64KeyswitchFixture",
                                      "MultiLutPbsFixture"])
def test_twin(monkeypatch, cls_name):
    check_twin(monkeypatch, cls_name)
