"""Run the docstring examples of every concrete_tpu_torch module (on the CPU,
where the kernel wrappers take their plain PyTorch versions)."""

import doctest
import importlib
import pkgutil

import pytest

import concrete_tpu_torch

MODULES = sorted(m.name for m in pkgutil.walk_packages(
    concrete_tpu_torch.__path__, prefix="concrete_tpu_torch."))


@pytest.mark.parametrize("name", MODULES)
def test_doctests(name):
    mod = importlib.import_module(name)
    results = doctest.testmod(mod, verbose=False)
    assert results.failed == 0, f"{name}: {results.failed} doctest failures"
    # every plain module with code of its own carries at least one example
    if not hasattr(mod, "__path__"):
        assert results.attempted > 0, f"{name}: no doctests collected"
