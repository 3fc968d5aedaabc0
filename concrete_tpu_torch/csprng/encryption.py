"""Secret- and encryption-random generators with deterministic fork budgets.

Mirrors concrete-core/src/backends/core/private/crypto/secret/generators/:

- ``SecretRandomGenerator`` (secret.rs): samples secret-key coefficients.
- ``EncryptionRandomGenerator`` (encryption.rs:15-20): two independent
  streams — a (seedable) *mask* stream for uniform mask coefficients and a
  *noise* stream for gaussian noise — plus the exact per-structure fork
  budgets (encryption.rs:246-316) that make parallel and serial key
  generation produce identical bits.

Example (byte budgets, encryption.rs bottom-of-file arithmetic):
    >>> from concrete_tpu_torch.csprng.encryption import mask_bytes_per_coef, mask_bytes_per_lwe
    >>> mask_bytes_per_coef(32)
    4
    >>> mask_bytes_per_lwe(32, 10)
    40
"""

from __future__ import annotations

import numpy as np

from .random import RandomGenerator


# -- byte budgets (encryption.rs:246-316) -----------------------------------

def mask_bytes_per_coef(bits: int) -> int:
    return bits // 8


def mask_bytes_per_polynomial(bits: int, poly_size: int) -> int:
    return poly_size * mask_bytes_per_coef(bits)


def mask_bytes_per_glwe(bits: int, glwe_dimension: int, poly_size: int) -> int:
    return glwe_dimension * mask_bytes_per_polynomial(bits, poly_size)


def mask_bytes_per_ggsw_level(bits: int, glwe_size: int, poly_size: int) -> int:
    return glwe_size * mask_bytes_per_glwe(bits, glwe_size - 1, poly_size)


def mask_bytes_per_lwe(bits: int, lwe_dimension: int) -> int:
    return lwe_dimension * mask_bytes_per_coef(bits)


def mask_bytes_per_gsw_level(bits: int, lwe_size: int) -> int:
    return lwe_size * mask_bytes_per_lwe(bits, lwe_size - 1)


def mask_bytes_per_ggsw(bits: int, level: int, glwe_size: int, poly_size: int) -> int:
    return level * mask_bytes_per_ggsw_level(bits, glwe_size, poly_size)


def noise_bytes_per_coef() -> int:
    # f64 noise needs ~4/pi attempt-inputs per output; 32 keeps a safety
    # margin (encryption.rs:284-288).
    return 8 * 32


def noise_bytes_per_polynomial(poly_size: int) -> int:
    return poly_size * noise_bytes_per_coef()


def noise_bytes_per_glwe(poly_size: int) -> int:
    return noise_bytes_per_polynomial(poly_size)


def noise_bytes_per_ggsw_level(glwe_size: int, poly_size: int) -> int:
    return glwe_size * noise_bytes_per_glwe(poly_size)


def noise_bytes_per_lwe() -> int:
    return noise_bytes_per_coef() * 3


def noise_bytes_per_gsw_level(lwe_size: int) -> int:
    return lwe_size * noise_bytes_per_lwe()


def noise_bytes_per_ggsw(level: int, glwe_size: int, poly_size: int) -> int:
    return level * noise_bytes_per_ggsw_level(glwe_size, poly_size)


class SecretRandomGenerator(RandomGenerator):
    """Generator dedicated to secret key coefficients (generators/secret.rs)."""

    def generate_binary_array(self, size: int, bits: int = 32) -> np.ndarray:
        return self.random_uniform_binary_array(size, bits)

    def generate_ternary_array(self, size: int, bits: int = 32) -> np.ndarray:
        return self.random_uniform_ternary_array(size, bits)

    def generate_uniform_array(self, size: int, bits: int = 32) -> np.ndarray:
        return self.random_uniform_array(size, bits)

    def generate_gaussian_array(self, size: int, bits: int = 32) -> np.ndarray:
        from ..params import GAUSSIAN_KEY_LOG_STD

        return self.fill_gaussian_torus(size, 2.0 ** GAUSSIAN_KEY_LOG_STD[bits], bits)


class EncryptionRandomGenerator:
    """Two-stream generator used by every encryption (encryption.rs:15-36).

    ``mask_seed`` seeds the mask stream (the reference's public seed);
    ``noise_seed`` seeds the noise stream (reference: fresh/unseeded, but
    seedable for tests via seed_noise_generator, encryption.rs:32-36).
    """

    def __init__(self, mask_seed: int | None = None, noise_seed: int | None = None):
        self.mask = RandomGenerator(mask_seed)
        self.noise = RandomGenerator(noise_seed)

    def remaining_bytes(self) -> int | None:
        return self.mask.remaining_bytes()

    def is_bounded(self) -> bool:
        return self.mask.is_bounded()

    # -- forks (encryption.rs:48-166) ------------------------------------

    def _fork(self, n_child: int, mask_bytes: int, noise_bytes: int):
        mask_children = self.mask.try_fork(n_child, mask_bytes)
        noise_children = self.noise.try_fork(n_child, noise_bytes)
        out = []
        for m, n in zip(mask_children, noise_children):
            child = EncryptionRandomGenerator.__new__(EncryptionRandomGenerator)
            child.mask = m
            child.noise = n
            out.append(child)
        return out

    def fork_bsk_to_ggsw(self, bits, lwe_dimension, level, glwe_size, poly_size):
        return self._fork(
            lwe_dimension,
            mask_bytes_per_ggsw(bits, level, glwe_size, poly_size),
            noise_bytes_per_ggsw(level, glwe_size, poly_size),
        )

    def fork_ggsw_to_ggsw_levels(self, bits, level, glwe_size, poly_size):
        return self._fork(
            level,
            mask_bytes_per_ggsw_level(bits, glwe_size, poly_size),
            noise_bytes_per_ggsw_level(glwe_size, poly_size),
        )

    def fork_ggsw_level_to_glwe(self, bits, glwe_size, poly_size):
        return self._fork(
            glwe_size,
            mask_bytes_per_glwe(bits, glwe_size - 1, poly_size),
            noise_bytes_per_glwe(poly_size),
        )

    def fork_gsw_to_gsw_levels(self, bits, level, lwe_size):
        return self._fork(
            level, mask_bytes_per_gsw_level(bits, lwe_size), noise_bytes_per_gsw_level(lwe_size)
        )

    def fork_gsw_level_to_lwe(self, bits, lwe_size):
        return self._fork(
            lwe_size, mask_bytes_per_lwe(bits, lwe_size - 1), noise_bytes_per_lwe()
        )

    # -- sampling ----------------------------------------------------------

    def fill_mask(self, size: int, bits: int) -> np.ndarray:
        """Uniform mask coefficients from the mask stream (encryption.rs:208)."""
        return self.mask.random_uniform_array(size, bits)

    def random_noise(self, std: float, bits: int) -> np.ndarray:
        """A single gaussian noise value (encryption.rs:219): one pair drawn,
        second element discarded (gaussian.rs:71-79)."""
        g1, _ = self.noise.random_gaussian_pairs(1, 0.0, std)
        from ..torus import from_torus_f64

        return from_torus_f64(g1, bits)[0]

    def fill_noise(self, size: int, std: float, bits: int) -> np.ndarray:
        """Gaussian noise tensor from the noise stream (encryption.rs:233)."""
        return self.noise.fill_gaussian_torus(size, std, bits)
