"""LWE layer: secret keys, encryption, keyswitch key, and the limb-plane
keyswitch of the gate pipeline.

A ciphertext is a row [a_0 .. a_{n-1}, b], body last (crypto/lwe/ciphertext.rs).
Client-side code is numpy on np.uint32 (u32 torus) or np.uint64 (u64 torus);
the server-side keyswitch runs on int32 / int64 torch tensors (CPU or CUDA).

Example (encrypt, keyswitch to a second key, decrypt):
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import EncryptionRandom, from_numpy, to_numpy
    >>> rng = np.random.default_rng(1)
    >>> k_in = LweSecretKey.generate_binary(16, rng)
    >>> k_out = LweSecretKey.generate_binary(12, rng)
    >>> rand = EncryptionRandom.new(2, 3)
    >>> ksk = LweKeyswitchKey.generate(k_in, k_out, 4, 5, 0.0, rand)
    >>> ct = k_in.encrypt(np.uint32(1 << 28), 0.0, rand)
    >>> out = keyswitch_limbs(torch.from_numpy(ksk_to_limbs(ksk.data)),
    ...                       from_numpy(ct)[None], base_log=4, level_count=5)
    >>> abs(int(k_out.decrypt(to_numpy(out))[0]) - (1 << 28)) < (1 << 20)
    True
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import decomposition
from ..torus import UNSIGNED, EncryptionRandom, bits_of


@dataclasses.dataclass
class LweSecretKey:
    """An LWE secret key: [n] np.uint32 or np.uint64 coefficients
    (secret/lwe.rs:30); `bits` is the torus width."""

    key: np.ndarray
    bits: int = 32

    @property
    def dimension(self) -> int:
        return self.key.shape[0]

    @classmethod
    def generate_binary(cls, dim: int, rng: np.random.Generator,
                        bits: int = 32):
        """Uniform binary key drawn from `rng` (a numpy Generator, not the
        JAX package's AES-CTR stream)."""
        return cls(rng.integers(0, 2, size=dim, dtype=UNSIGNED[bits]), bits)

    def encrypt(self, plaintexts, std: float,
                rand: EncryptionRandom) -> np.ndarray:
        """Encrypt unsigned plaintexts -> [..., n+1]: b = <a, s> + e + m
        with uniform a and Gaussian e (secret/lwe.rs:320-346)."""
        dt = UNSIGNED[self.bits]
        pts = np.asarray(plaintexts, dtype=dt)
        count = pts.size
        masks = rand.fill_mask((count, self.dimension), self.bits)
        noises = rand.fill_noise(count, std, self.bits)
        bodies = ((masks * self.key[None, :]).sum(axis=1, dtype=dt)
                  + noises + pts.reshape(count))
        out = np.concatenate([masks, bodies[:, None]], axis=1)
        return out.reshape(pts.shape + (self.dimension + 1,))

    def decrypt(self, ct) -> np.ndarray:
        """Phase b - <a, s> (secret/lwe.rs:420), unsigned."""
        dt = UNSIGNED[self.bits]
        ct = np.asarray(ct, dtype=dt)
        return ct[..., -1] - (ct[..., :-1] * self.key).sum(axis=-1, dtype=dt)


@dataclasses.dataclass
class LweKeyswitchKey:
    """[n_in, l, n_out+1] np.uint32 / np.uint64: per input key coefficient,
    the l LWE encryptions of s_i * q/B^level under the output key
    (keyswitch.rs:36)."""

    data: np.ndarray
    base_log: int
    level_count: int
    bits: int = 32

    @classmethod
    def generate(cls, in_key: LweSecretKey, out_key: LweSecretKey,
                 base_log: int, level_count: int, std: float,
                 rand: EncryptionRandom) -> "LweKeyswitchKey":
        """fill_with_keyswitch_key (keyswitch.rs:331-385)."""
        bits = in_key.bits
        dt = UNSIGNED[bits]
        shifts = np.array([bits - base_log * (lev + 1)
                           for lev in range(level_count)], dtype=dt)
        messages = in_key.key.astype(dt)[:, None] << shifts[None, :]
        data = out_key.encrypt(messages, std, rand)
        return cls(data=data, base_log=base_log, level_count=level_count,
                   bits=bits)


def _ks_digits(ct: torch.Tensor, base_log: int, level_count: int):
    """Rounded small-sign digits of the mask, flattened to [..., n_in*l]
    (the carrier's type), plus the body."""
    rounded = decomposition.closest_representable(
        ct[..., :-1], base_log, level_count)
    digits = decomposition.small_sign_decompose(rounded, base_log, level_count)
    return digits.reshape(digits.shape[:-2] + (-1,)), ct[..., -1]


def ksk_to_limbs(ksk_data) -> np.ndarray:
    """[n_in, l, n_out+1] u32 / u64 keyswitch key -> int8 [n_in*l,
    n_limbs*(n_out+1)] of balanced signed-byte limbs (4 for u32, 8 for u64),
    limb plane m contiguous (the same packing as the bootstrap key's rings,
    bootstrap_mxu._limb_pack). A u64 key must come as np.uint64; anything
    else is read as u32."""
    from .bootstrap_mxu import _limb_pack

    k = np.asarray(ksk_data)
    if k.dtype != np.uint64:
        k = k.astype(np.uint32)
    n_limbs = k.dtype.itemsize
    packed = _limb_pack(k.reshape(-1))
    limbs = np.stack(
        [((packed >> k.dtype.type(8 * m)) & k.dtype.type(0xFF)).astype(np.int8)
         for m in range(n_limbs)], axis=0)
    n_in, l, out_sz = k.shape
    limbs = limbs.reshape(n_limbs, n_in * l, out_sz)
    return np.moveaxis(limbs, 0, 1).reshape(n_in * l, n_limbs * out_sz)


def keyswitch_limbs(ksk8: torch.Tensor, ct: torch.Tensor, *, base_log: int,
                    level_count: int) -> torch.Tensor:
    """Keyswitch [..., n_in+1] -> [..., n_out+1] against a limb-prepared key
    (ksk_to_limbs): one int8 x int8 -> int32 product with the negated digits,
    then the wrapping limb recombination sum_m S_m << 8m in the carrier's
    type (int32 for u32, int64 for u64), which is the result mod 2^bits
    (keyswitch.rs:514-560)."""
    from .bootstrap_mxu import int_mm

    if base_log > 7:
        raise ValueError("limb keyswitch needs int8 digits (base_log <= 7)")
    if ksk8.shape[0] * 8192 >= 2 ** 31:
        raise ValueError("int32 accumulation bound exceeded")
    n_limbs = bits_of(ct) // 8
    out_sz = ksk8.shape[-1] // n_limbs
    flat, body = _ks_digits(ct, base_log, level_count)
    lead = flat.shape[:-1]
    neg = (-flat).to(torch.int8).reshape(-1, flat.shape[-1])
    s = int_mm(neg, ksk8).reshape(lead + (n_limbs, out_sz)).to(ct.dtype)
    out = s[..., 0, :]
    for m in range(1, n_limbs):
        out = out + (s[..., m, :] << (8 * m))
    out[..., -1] += body
    return out
