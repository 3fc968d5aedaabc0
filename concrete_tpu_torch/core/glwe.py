"""GLWE secret keys and encryption (crypto/secret/glwe.rs), client side.

A GLWE ciphertext is [k+1, N] with the body polynomial last. Keys and
ciphertexts are np.uint32 (u32 torus) or np.uint64 (u64 torus); the
mask-times-key products run through ``math.polynomial.negacyclic_multisum``
(exact, float64), on a device of the caller's choice (the card at large N).

Example:
    >>> import numpy as np
    >>> sk = GlweSecretKey.generate_binary(2, 8, np.random.default_rng(1))
    >>> sk.key.shape, sk.into_lwe_key().dimension
    ((2, 8), 16)
    >>> GlweSecretKey.generate_binary(1, 8, np.random.default_rng(1), bits=64).key.dtype
    dtype('uint64')
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..math import polynomial
from ..torus import UNSIGNED, from_numpy, to_numpy


@dataclasses.dataclass
class GlweSecretKey:
    """A GLWE secret key: [k, N] np.uint32 / np.uint64 key polynomials
    (secret/glwe.rs:31); `bits` is the torus width."""

    key: np.ndarray
    bits: int = 32

    @property
    def dimension(self) -> int:
        return self.key.shape[0]

    @property
    def polynomial_size(self) -> int:
        return self.key.shape[1]

    @classmethod
    def generate_binary(cls, dim: int, poly_size: int,
                        rng: np.random.Generator, bits: int = 32):
        """Uniform binary key drawn from `rng` (a numpy Generator, not the
        JAX package's AES-CTR stream)."""
        return cls(rng.integers(0, 2, size=(dim, poly_size),
                                dtype=UNSIGNED[bits]), bits)

    def into_lwe_key(self):
        """The flattened ("big") LWE key of dimension k*N (secret/glwe.rs:332),
        which decrypts sample-extracted ciphertexts."""
        from .lwe import LweSecretKey

        return LweSecretKey(self.key.reshape(-1).copy(), self.bits)

    def encrypt_from_randomness(self, masks: np.ndarray, noises: np.ndarray,
                                msgs: np.ndarray, device=None) -> np.ndarray:
        """Ciphertexts from pre-drawn randomness: masks [..., k, N], noises
        and msgs [..., N] -> [..., k+1, N] with body = noise + sum_j a_j*s_j
        + msg (secret/glwe.rs:488-516). The products run on `device` (the
        CPU by default); the float64 sums are exact, so every device gives
        the same bytes."""
        products = polynomial.negacyclic_multisum(
            from_numpy(masks, device), from_numpy(self.key, device))
        bodies = noises + to_numpy(products) + msgs
        return np.concatenate([masks, bodies[..., None, :]], axis=-2)
