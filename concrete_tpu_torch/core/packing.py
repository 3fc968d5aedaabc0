"""Packing keyswitch: LWE -> GLWE, and an LWE list -> one packed GLWE
(crypto/glwe/keyswitch.rs, PackingKeyswitchKey).

For each input key coefficient, `level` GLWE ciphertexts encrypt
s_i * q/B^level at coefficient 0 (:349); switching decomposes each input
mask element and subtracts digit * key rows (:545); packing switches a list
and sums each result rotated by X^degree (:596). Key generation is numpy on
the AES-CTR streams (concrete_tpu's bytes for equal seeds); switching runs
on torch tensors, exact mod 2^bits (lwe.wrapping_dot).

Example (the packing keyswitch of an LWE lands in coefficient 0):
    >>> import numpy as np
    >>> from concrete_tpu_torch.core import glwe, lwe
    >>> from concrete_tpu_torch.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sgen = SecretRandomGenerator(1)
    >>> lsk = lwe.LweSecretKey.generate_binary(4, sgen)
    >>> gsk = glwe.GlweSecretKey.generate_binary(1, 16, sgen)
    >>> pksk = PackingKeyswitchKey.generate(lsk, gsk, 8, 2, 0.0,
    ...     EncryptionRandomGenerator(2, 3))
    >>> ct = lsk.encrypt(np.uint32(1 << 24), 0.0, EncryptionRandomGenerator(4, 5))
    >>> out = keyswitch_lwe_to_glwe(pksk.data, ct, base_log=8, level_count=2)
    >>> abs(int(gsk.decrypt(out[None])[0][0]) - (1 << 24)) < (1 << 18)
    True
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csprng import EncryptionRandomGenerator
from ..math import decomposition, polynomial
from ..torus import UNSIGNED, as_torus, to_numpy
from .glwe import GlweSecretKey
from .lwe import LweSecretKey, table_to_limbs, wrapping_dot


@dataclasses.dataclass
class PackingKeyswitchKey:
    """data [n_in, l, k+1, N]: per input key coefficient, the decomposition
    ladder encrypted as GLWEs under the output key."""

    data: np.ndarray
    base_log: int
    level_count: int
    bits: int = 32

    @classmethod
    def generate(cls, in_key: LweSecretKey, out_key: GlweSecretKey,
                 base_log: int, level_count: int, std: float,
                 gen: EncryptionRandomGenerator,
                 device=None) -> "PackingKeyswitchKey":
        """fill_with_packing_keyswitch_key (glwe/keyswitch.rs:349): message
        polynomials zero but for coefficient 0 = s_i * q/B^level, encrypted
        block after block with the shared generator; the products run on
        `device`."""
        bits = in_key.bits
        dt = UNSIGNED[bits]
        n_in, n = in_key.dimension, out_key.polynomial_size
        msgs = np.zeros((n_in, level_count, n), dtype=dt)
        shifts = np.array([bits - base_log * (lev + 1)
                           for lev in range(level_count)], dtype=np.uint64)
        msgs[:, :, 0] = (in_key.key.astype(np.uint64)[:, None]
                         << shifts[None, :]).astype(dt)
        data = out_key.encrypt(msgs.reshape(n_in * level_count, n), std, gen,
                               device).reshape(n_in, level_count,
                                               out_key.dimension + 1, n)
        return cls(data, base_log, level_count, bits)


def keyswitch_lwe_to_glwe(pksk_data, ct, *, base_log: int, level_count: int,
                          limbs: torch.Tensor | None = None) -> torch.Tensor:
    """Switch LWE batches into GLWE ciphertexts (glwe/keyswitch.rs:545):
    pksk_data [n_in, l, k+1, N], ct [..., n_in+1] -> [..., k+1, N] on ct's
    device (CPU for numpy input)."""
    ct = as_torus(ct)
    n_in, l, ks1, n = pksk_data.shape
    if limbs is None:
        limbs = torch.from_numpy(table_to_limbs(
            to_numpy(pksk_data).reshape(n_in * l, ks1 * n))).to(ct.device)
    rounded = decomposition.closest_representable(ct[..., :-1], base_log,
                                                  level_count)
    digits = decomposition.small_sign_decompose(rounded, base_log, level_count)
    flat = digits.reshape(digits.shape[:-2] + (n_in * l,))
    out = (-wrapping_dot(flat, limbs, base_log)).reshape(
        flat.shape[:-1] + (ks1, n))
    out[..., -1, 0] += ct[..., -1]
    return out


def packing_keyswitch(pksk_data, lwe_list, *, base_log: int, level_count: int,
                      limbs: torch.Tensor | None = None) -> torch.Tensor:
    """Pack an LWE list into one GLWE (glwe/keyswitch.rs:596): the i-th
    switched ciphertext lands on monomial degree i.

    lwe_list [..., m, n_in+1] with m <= N -> [..., k+1, N]."""
    lwe_list = as_torus(lwe_list)
    m = lwe_list.shape[-2]
    poly_size = pksk_data.shape[-1]
    if m > poly_size:
        raise ValueError(
            f"cannot pack {m} LWEs into one GLWE of polynomial size "
            f"{poly_size} (degree m-1 wraps negacyclically; "
            f"glwe/keyswitch.rs:596 debug_assert)")
    switched = keyswitch_lwe_to_glwe(pksk_data, lwe_list, base_log=base_log,
                                     level_count=level_count, limbs=limbs)
    degrees = torch.arange(m, device=switched.device).reshape(m, 1)
    return polynomial.negacyclic_monomial_mul(switched, degrees).sum(
        dim=-3).to(switched.dtype)
