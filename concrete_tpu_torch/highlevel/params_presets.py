"""Named security parameter presets.

Mirrors concrete/src/lwe_params.rs:23-168 and rlwe_params.rs:27+ — dimension
and log2(std-dev) pairs calibrated for 128-bit / 80-bit security at the time
of the reference's publication.

Example:
    >>> from concrete_tpu_torch.highlevel.params_presets import LWE128_630, RLWE128_1024_1
    >>> LWE128_630.dimension
    630
    >>> RLWE128_1024_1.polynomial_size
    1024
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LWEParams:
    dimension: int
    log2_std_dev: int

    @property
    def std_dev(self) -> float:
        return 2.0 ** self.log2_std_dev


@dataclasses.dataclass(frozen=True)
class RLWEParams:
    polynomial_size: int
    dimension: int
    log2_std_dev: int

    @property
    def std_dev(self) -> float:
        return 2.0 ** self.log2_std_dev


# 128-bit security (lwe_params.rs:23-90)
LWE128_256 = LWEParams(256, -5)
LWE128_512 = LWEParams(512, -11)
LWE128_630 = LWEParams(630, -14)
LWE128_650 = LWEParams(650, -15)
LWE128_688 = LWEParams(688, -16)
LWE128_710 = LWEParams(710, -17)
LWE128_750 = LWEParams(750, -18)
LWE128_800 = LWEParams(800, -19)
LWE128_830 = LWEParams(830, -20)
LWE128_1024 = LWEParams(1024, -25)
LWE128_2048 = LWEParams(2048, -52)
LWE128_4096 = LWEParams(4096, -105)

# 80-bit security (lwe_params.rs:92-168)
LWE80_256 = LWEParams(256, -9)
LWE80_512 = LWEParams(512, -19)
LWE80_630 = LWEParams(630, -24)
LWE80_650 = LWEParams(650, -25)
LWE80_688 = LWEParams(688, -26)
LWE80_1024 = LWEParams(1024, -40)
LWE80_2048 = LWEParams(2048, -82)

# RLWE presets (rlwe_params.rs:27+)
RLWE128_256_1 = RLWEParams(256, 1, -5)
RLWE128_512_1 = RLWEParams(512, 1, -11)
RLWE128_1024_1 = RLWEParams(1024, 1, -25)
RLWE128_2048_1 = RLWEParams(2048, 1, -52)
RLWE128_4096_1 = RLWEParams(4096, 1, -105)
RLWE128_256_2 = RLWEParams(256, 2, -11)
RLWE128_512_2 = RLWEParams(512, 2, -25)
RLWE128_256_4 = RLWEParams(256, 4, -25)
RLWE80_1024_1 = RLWEParams(1024, 1, -40)
RLWE80_2048_1 = RLWEParams(2048, 1, -82)
