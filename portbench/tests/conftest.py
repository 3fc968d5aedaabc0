"""Test configuration of the benchmark's own tests: the checkout's root on
the import path, the `cuda` marker, and tiny configurations. Imports no
JAX: these tests run where the port's GPU tests run too."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny configurations: the published structure (k, base logs, levels) at
# small n and N, little noise
TINY_BOOLEAN = {"lwe_dimension": 10, "glwe_dimension": 2,
                "polynomial_size": 64,
                "lwe_modular_std_dev": 2.0 ** -25,
                "glwe_modular_std_dev": 2.0 ** -28,
                "pbs_base_log": 8, "pbs_level": 2, "ks_base_log": 2,
                "ks_level": 5}
TINY_INT4 = {"lwe_dimension": 12, "lwe_log2_std_dev": -40,
             "glwe_dimension": 1, "polynomial_size": 256,
             "rlwe_log2_std_dev": -50, "pbs_base_log": 7, "pbs_level": 3,
             "ks_base_log": 2, "ks_level": 8}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture
def cuda():
    """Skip where no CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
