"""Noise dispersion parameter types.

Mirrors concrete-commons/src/dispersion.rs: the same three representations
(log standard deviation, standard deviation, variance) with the exact modular
conversion rules (scaling by q = 2^bits), because the noise-propagation
estimator and the statistical conformance tests depend on them.

Example:
    >>> from concrete_tpu_torch.dispersion import StandardDev, LogStandardDev, Variance
    >>> StandardDev(0.25).get_variance()
    0.0625
    >>> LogStandardDev(-2.0).get_standard_dev()
    0.25
    >>> Variance.from_modular_variance(2.0 ** 44, 32).get_log_standard_dev()
    -10.0
"""

from __future__ import annotations

import dataclasses
import math


class DispersionParameter:
    """Base class for noise-amount descriptions of a random distribution.

    All values describe the distribution on the *real torus* [0, 1); "modular"
    variants are scaled to the discretized torus Z_q with q = 2^bits.
    Reference: dispersion.rs:26-70.
    """

    def get_standard_dev(self) -> float:
        raise NotImplementedError

    def get_variance(self) -> float:
        raise NotImplementedError

    def get_log_standard_dev(self) -> float:
        # the reference's sqrt(0).log2() = -inf (dispersion.rs); 2^-inf = 0,
        # so zero dispersion round-trips instead of raising a domain error
        std = self.get_standard_dev()
        return math.log2(std) if std > 0.0 else float("-inf")

    def get_modular_standard_dev(self, bits: int) -> float:
        return 2.0 ** (bits + self.get_log_standard_dev())

    def get_modular_variance(self, bits: int) -> float:
        return 2.0 ** (2.0 * (bits + self.get_log_standard_dev()))

    def get_modular_log_standard_dev(self, bits: int) -> float:
        return bits + self.get_log_standard_dev()


@dataclasses.dataclass(frozen=True)
class LogStandardDev(DispersionParameter):
    """Noise given as log2(standard deviation). Reference: dispersion.rs:73."""

    log_std_dev: float

    @classmethod
    def from_modular_log_standard_dev(cls, log_std: float, bits: int) -> "LogStandardDev":
        return cls(log_std - bits)

    def get_standard_dev(self) -> float:
        return 2.0 ** self.log_std_dev

    def get_variance(self) -> float:
        return 2.0 ** (self.log_std_dev * 2.0)

    def get_log_standard_dev(self) -> float:
        return self.log_std_dev


@dataclasses.dataclass(frozen=True)
class StandardDev(DispersionParameter):
    """Noise given as the standard deviation. Reference: dispersion.rs:140."""

    std_dev: float

    @classmethod
    def from_modular_standard_dev(cls, std: float, bits: int) -> "StandardDev":
        return cls(std / 2.0 ** bits)

    def get_standard_dev(self) -> float:
        return self.std_dev

    def get_variance(self) -> float:
        return self.std_dev ** 2

    def get_log_standard_dev(self) -> float:
        # sqrt(0).log2() = -inf in the reference; keep zero graceful
        return math.log2(self.std_dev) if self.std_dev > 0.0 else float("-inf")


@dataclasses.dataclass(frozen=True)
class Variance(DispersionParameter):
    """Noise given as the variance. Reference: dispersion.rs:206."""

    variance: float

    @classmethod
    def from_modular_variance(cls, var: float, bits: int) -> "Variance":
        return cls(var / 2.0 ** (2 * bits))

    def get_standard_dev(self) -> float:
        return math.sqrt(self.variance)

    def get_variance(self) -> float:
        return self.variance

    def get_log_standard_dev(self) -> float:
        if self.variance <= 0.0:
            return float("-inf")
        return math.log2(self.variance) / 2.0
