"""GGSW encryption of the bootstrap key (crypto/bootstrap/standard/mod.rs).

A GGSW ciphertext is [l, k+1, k+1, N]: `level` matrices of k+1 GLWE rows. A
bootstrap key is one GGSW per LWE key bit, [n, l, k+1, k+1, N] np.uint32
or np.uint64 (the GLWE key's torus). All rows are assembled with one batched
multisum. bsk_to_ntt converts a key to the ntt backend's spectra.

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
    >>> spectra = bsk_to_ntt(bsk.data, (2013265921, 1811939329), 32)
    >>> spectra.shape, spectra.dtype          # [n, P, levels, k+1, k+1, N]
    (torch.Size([3, 2, 2, 2, 2, 16]), torch.int32)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import crt, ntt
from ..torus import UNSIGNED, EncryptionRandom, as_torus
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


def ggsw_to_ntt(ggsw, primes: tuple[int, ...], bits: int, *,
                device=None) -> torch.Tensor:
    """Forward-NTT every polynomial of a GGSW tensor [..., N] (u32 / u64
    torus) -> [P, ..., N] Montgomery spectra in bit-reversed order, u32
    words as int32 (values below 2^31). Coefficients are centered (signed)
    before the residue reduction, which halves the CRT bound
    (bootstrap/fourier/mod.rs:186 fill_with_forward_fourier). Runs on
    `device`, else the tensor's own, else the CPU for numpy input."""
    g = as_torus(ggsw, device, bits)
    primes = tuple(primes)
    residues = crt.CrtContext.new(primes, bits).residues_from_torus(g)
    sp = ntt.make_stacked_plans(g.shape[-1], primes)
    return ntt.forward_stacked(sp, torch.stack(residues)).to(torch.int32)


def bsk_to_ntt(bsk_data, primes: tuple[int, ...], bits: int, *,
               device=None) -> torch.Tensor:
    """[n, l, k+1, k+1, N] bootstrap key -> [n, P, l, k+1, k+1, N] int32
    spectra (concrete_tpu's bsk_to_ntt, byte for byte), the CMux-chain axis
    leading so each step reads one contiguous slice. Converted on the key's
    device (see ggsw_to_ntt) in slices of the n axis, so the int64
    temporaries stay near a few hundred MB."""
    bsk = as_torus(bsk_data, device, bits)
    n_lwe, per_row = bsk.shape[0], bsk[0].numel()
    out = torch.empty((n_lwe, len(primes)) + tuple(bsk.shape[1:]),
                      dtype=torch.int32, device=bsk.device)
    step = max(1, (1 << 22) // (len(primes) * per_row))
    for i0 in range(0, n_lwe, step):
        out[i0:i0 + step] = ggsw_to_ntt(bsk[i0:i0 + step], primes,
                                        bits).movedim(0, 1)
    return out
