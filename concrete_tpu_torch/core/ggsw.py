"""GGSW encryption of the bootstrap key (crypto/bootstrap/standard/mod.rs).

A GGSW ciphertext is [l, k+1, k+1, N]: `level` matrices of k+1 GLWE rows. A
bootstrap key is one GGSW per LWE key bit, [n, l, k+1, k+1, N] np.uint32
or np.uint64 (the GLWE key's torus). All rows are assembled with one batched
multisum.

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.core.glwe import GlweSecretKey
    >>> from concrete_tpu_torch.core.lwe import LweSecretKey
    >>> from concrete_tpu_torch.torus import EncryptionRandom
    >>> rng = np.random.default_rng(1)
    >>> lsk = LweSecretKey.generate_binary(3, rng)
    >>> gsk = GlweSecretKey.generate_binary(1, 16, rng)
    >>> bsk = StandardBootstrapKey.generate(lsk, gsk, 4, 2, 0.0,
    ...                                     EncryptionRandom.new(2, 3))
    >>> bsk.data.shape            # [n, levels, k+1, k+1, N]
    (3, 2, 2, 2, 16)
    >>> gsk64 = GlweSecretKey.generate_binary(1, 16, rng, bits=64)
    >>> StandardBootstrapKey.generate(lsk, gsk64, 4, 2, 0.0,
    ...     EncryptionRandom.new(2, 3)).data.dtype
    dtype('uint64')
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..torus import UNSIGNED, EncryptionRandom
from .glwe import GlweSecretKey


def assemble_ggsw(glwe_key: GlweSecretKey, base_log: int, level_count: int,
                  masks: np.ndarray, noises: np.ndarray,
                  values: np.ndarray, device=None) -> np.ndarray:
    """GGSW rows from randomness: masks [n, l, k+1, k, N], noises
    [n, l, k+1, N], values [n] -> [n, l, k+1, k+1, N], encryptions of zero
    plus the gadget constants on the diagonals (products on `device`)."""
    rows = glwe_key.encrypt_from_randomness(
        masks, noises, np.zeros(noises.shape, dtype=noises.dtype), device)
    _add_gadget_diagonals(rows, values, base_log, level_count, glwe_key.bits)
    return rows


def _add_gadget_diagonals(rows: np.ndarray, values: np.ndarray,
                          base_log: int, level_count: int, bits: int):
    """Add value_b * q/B^level to coefficient 0 of each level matrix's
    diagonal polynomials, in place (secret/glwe.rs:831-856)."""
    shifts = np.array([bits - base_log * (lev + 1)
                       for lev in range(level_count)], dtype=np.uint64)
    summands = (np.asarray(values).astype(np.uint64)[:, None]
                << shifts[None, :]).astype(UNSIGNED[bits])     # [n, l]
    for row_idx in range(rows.shape[2]):
        rows[:, :, row_idx, row_idx, 0:1] += summands[:, :, None]


@dataclasses.dataclass
class StandardBootstrapKey:
    """Coefficient-domain bootstrap key, data [n, l, k+1, k+1, N] np.uint32
    or np.uint64."""

    data: np.ndarray
    base_log: int
    level_count: int

    @classmethod
    def generate(cls, lwe_key, glwe_key: GlweSecretKey, base_log: int,
                 level_count: int, std: float, rand: EncryptionRandom,
                 device=None) -> "StandardBootstrapKey":
        """One GGSW encryption of each LWE key bit under the GLWE key, with
        uniform masks and Gaussian noise of std `std` from `rand`; the
        mask-times-key products run on `device` (the CPU by default), with
        the same bytes on every device."""
        k, n = glwe_key.dimension, glwe_key.polynomial_size
        n_lwe = lwe_key.dimension
        bits = glwe_key.bits
        masks = rand.fill_mask((n_lwe, level_count, k + 1, k, n), bits)
        noises = rand.fill_noise((n_lwe, level_count, k + 1, n), std, bits)
        data = assemble_ggsw(glwe_key, base_log, level_count, masks, noises,
                             lwe_key.key, device)
        return cls(data=data, base_log=base_log, level_count=level_count)
