"""Statistical conformance helpers: the oracle of the fixture layer.

Mirrors the reference's test tooling, as concrete_tpu/testing.py does:
- assert_delta_std_dev (private/mod.rs:76): every sample within 5 sigma of
  its expected value, distance measured modularly on the torus;
- assert_noise_distribution (concrete-core-fixture/src/raw/statistical_test.rs:14):
  Kolmogorov-Smirnov test at 95% against a freshly sampled gaussian with the
  predicted std-dev, or a 0.5-bit log-sigma slack;
- assert_noise_bounded: measured std-dev <= predicted * 2^slack.

Samples and expected values may be numpy arrays (np.uint32 / np.uint64) or
torus carrier tensors (int32 / int64, any device); the statistics run on
the host in float64.

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.testing import assert_delta_std_dev
    >>> from concrete_tpu_torch.dispersion import StandardDev
    >>> assert_delta_std_dev(np.uint32([5, 6]), np.uint32([5, 6]),
    ...     StandardDev(2.0 ** -20), 32)   # zero error: within 5 sigma
"""

from __future__ import annotations

import numpy as np

from .dispersion import DispersionParameter
from .torus import torus_modular_distance


def assert_delta_std_dev(
    samples,
    expected,
    dispersion: DispersionParameter,
    bits: int,
    factor: float = 5.0,
):
    """Check |sample - expected| <= factor * sigma (modular torus distance)."""
    dist = np.abs(torus_modular_distance(samples, expected, bits))
    bound = factor * dispersion.get_standard_dev()
    worst = float(dist.max()) if dist.size else 0.0
    assert worst <= bound, f"sample deviates {worst:.3e} > {factor} sigma = {bound:.3e}"


def _ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic."""
    a = np.sort(a)
    b = np.sort(b)
    all_vals = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, all_vals, side="right") / len(a)
    cdf_b = np.searchsorted(b, all_vals, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


def assert_noise_distribution(
    samples,
    expected,
    predicted: DispersionParameter,
    bits: int,
    alpha: float = 0.05,
    log_sigma_slack_bits: float = 0.5,
    seed: int = 0,
):
    """KS-test measured noise against a gaussian of the predicted std-dev,
    or accept when the measured log2 std-dev is within
    `log_sigma_slack_bits` of the prediction: the reference's disjunction
    (statistical_test.rs:14-75; a coarsely quantized low-noise distribution
    can fail KS while its sigma is exactly right)."""
    noise = torus_modular_distance(samples, expected, bits).ravel()
    sigma = predicted.get_standard_dev()
    rng = np.random.default_rng(seed)
    reference = rng.normal(0.0, sigma, size=noise.size)
    d = _ks_statistic(noise, reference)
    n, m = len(noise), len(reference)
    critical = np.sqrt(-0.5 * np.log(alpha / 2.0)) * np.sqrt((n + m) / (n * m))
    ks_ok = d <= critical
    measured_log_sigma = np.log2(max(noise.std(), 1e-300))
    sigma_ok = measured_log_sigma <= np.log2(sigma) + log_sigma_slack_bits
    assert ks_ok or sigma_ok, (
        f"KS statistic {d:.4f} > critical {critical:.4f} AND measured log2 "
        f"sigma {measured_log_sigma:.2f} exceeds predicted "
        f"{np.log2(sigma):.2f} + {log_sigma_slack_bits}"
    )


def assert_noise_bounded(
    samples,
    expected,
    predicted: DispersionParameter,
    bits: int,
    slack_bits: float = 0.5,
):
    """One-sided check: measured std-dev <= predicted * 2^slack, the PBS
    fixture's criterion (lwe_ciphertext_discarding_bootstrap_1.rs:254-274).
    Returns (measured std, predicted std) as fractions of the torus."""
    noise = torus_modular_distance(samples, expected, bits).ravel()
    sigma = predicted.get_standard_dev()
    measured = float(noise.std())
    assert measured <= sigma * 2.0 ** slack_bits, (
        f"measured sigma {measured:.3e} > predicted {sigma:.3e} * 2^{slack_bits}"
    )
    return measured, sigma
