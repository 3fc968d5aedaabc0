"""Scalar GSW over LWE: encryption, external product and CMux
(crypto/gsw/ciphertext.rs, secret/lwe.rs:494 encrypt_constant_gsw).

A GSW ciphertext is [l, n+1, n+1]: `level` matrices of n+1 LWE rows, with
the gadget summand m * q/B^level on the diagonal. Encryption is numpy on the
AES-CTR streams (concrete_tpu's bytes for equal seeds); the external
product contracts the decomposed input LWE with the rows in one exact
wrapping product (lwe.wrapping_dot) on torch tensors (CPU or CUDA).

Example (the external product with GSW(0) gives an encryption of 0):
    >>> import numpy as np
    >>> from concrete_tpu_torch.core import lwe
    >>> from concrete_tpu_torch.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sk = lwe.LweSecretKey.generate_binary(8, SecretRandomGenerator(3))
    >>> g = encrypt_constant_gsw(sk, 0, 8, 2, 0.0, EncryptionRandomGenerator(4, 5))
    >>> ct = np.zeros(9, np.uint32); ct[-1] = 1 << 31       # trivial: body only
    >>> out = external_product(g, ct, base_log=8, level_count=2)
    >>> int(sk.decrypt(to_numpy(out)[None])[0]), int(g[0, 0, 0])
    (0, 3860717787)
"""

from __future__ import annotations

import numpy as np
import torch

from ..csprng import EncryptionRandomGenerator
from ..math import decomposition
from ..torus import UNSIGNED, as_torus, to_numpy
from .lwe import LweSecretKey, table_to_limbs, wrapping_dot


def encrypt_constant_gsw(lwe_key: LweSecretKey, value: int, base_log: int,
                         level_count: int, std: float,
                         gen: EncryptionRandomGenerator) -> np.ndarray:
    """GSW(value) -> [l, n+1, n+1] (secret/lwe.rs:494): a fork per level,
    then per row; each row a fresh encryption of zero, the diagonal plus
    value * q/B^level."""
    bits = lwe_key.bits
    dt = UNSIGNED[bits]
    n = lwe_key.dimension
    out = np.zeros((level_count, n + 1, n + 1), dtype=dt)
    for lev_idx, lev_gen in enumerate(
            gen.fork_gsw_to_gsw_levels(bits, level_count, n + 1)):
        summand = dt((int(value) << (bits - base_log * (lev_idx + 1)))
                     % (1 << bits))
        for row_idx, row_gen in enumerate(
                lev_gen.fork_gsw_level_to_lwe(bits, n + 1)):
            row = lwe_key.encrypt(np.zeros((), dtype=dt), std, row_gen)
            row[row_idx:row_idx + 1] += summand
            out[lev_idx, row_idx] = row
    return out


def external_product(gsw, lwe, *, base_log: int, level_count: int,
                     limbs: torch.Tensor | None = None) -> torch.Tensor:
    """<decomp(lwe), GSW> (gsw/ciphertext.rs:416): round the whole input
    ciphertext, decompose it, contract the digits with the GSW rows.

    gsw [l, n+1, n+1] (numpy or carrier tensor), lwe [..., n+1] -> [..., n+1]
    on lwe's device; `limbs` (table_to_limbs of the rows) may be given to
    skip their preparation."""
    lwe = as_torus(lwe)
    size = lwe.shape[-1]
    if limbs is None:
        rows = to_numpy(gsw).reshape(level_count * size, size)
        limbs = torch.from_numpy(table_to_limbs(rows)).to(lwe.device)
    digits = decomposition.decompose_rounded(lwe, base_log, level_count)
    flat = digits.movedim(-1, -2).reshape(lwe.shape[:-1]
                                          + (level_count * size,))
    return wrapping_dot(flat, limbs, base_log)


def cmux(gsw, ct0, ct1, *, base_log: int, level_count: int,
         limbs: torch.Tensor | None = None) -> torch.Tensor:
    """ct0 + extprod(gsw, ct1 - ct0) (gsw/ciphertext.rs:534-559)."""
    ct0, ct1 = as_torus(ct0), as_torus(ct1)
    return ct0 + external_product(gsw, ct1 - ct0, base_log=base_log,
                                  level_count=level_count, limbs=limbs)
