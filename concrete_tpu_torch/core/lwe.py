"""LWE layer: secret keys, encryption, keyswitch keys, and the keyswitch in
its two forms.

A ciphertext is a row [a_0 .. a_{n-1}, b], body last (crypto/lwe/ciphertext.rs).
Client-side code is numpy on np.uint32 (u32 torus) or np.uint64 (u64 torus)
and draws every key coefficient, mask and noise value from the AES-CTR
streams of :mod:`concrete_tpu_torch.csprng`, in concrete_tpu's order: equal
seeds give the same bytes. The server-side keyswitch runs on int32 / int64
torch tensors (CPU or CUDA): ``keyswitch_limbs`` (int8 digits, base_log <= 7)
and the general ``keyswitch`` (any base_log), both exact mod 2^bits.

Example (encrypt, keyswitch to a second key at base_log 8, decrypt):
    >>> import numpy as np
    >>> from concrete_tpu_torch.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> from concrete_tpu_torch.torus import from_numpy, to_numpy
    >>> sgen = SecretRandomGenerator(1)
    >>> k_in = LweSecretKey.generate_binary(16, sgen)
    >>> k_out = LweSecretKey.generate_binary(12, sgen)
    >>> gen = EncryptionRandomGenerator(2, 3)
    >>> ksk = LweKeyswitchKey.generate(k_in, k_out, 8, 3, 0.0, gen)
    >>> ct = k_in.encrypt(np.uint32(1 << 28), 0.0, gen)
    >>> out = keyswitch(ksk.data, from_numpy(ct)[None], base_log=8, level_count=3)
    >>> abs(int(k_out.decrypt(to_numpy(out))[0]) - (1 << 28)) < (1 << 10)
    True
    >>> k_in.key[:8].tolist(), int(ct[-1])
    ([0, 0, 0, 1, 1, 1, 0, 1], 1396831525)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..math import decomposition
from ..torus import UNSIGNED, as_torus, bits_of, from_torus_f64, to_numpy
from . import checks


@dataclasses.dataclass
class LweSecretKey:
    """An LWE secret key: [n] np.uint32 or np.uint64 coefficients
    (secret/lwe.rs:30); `kind` is binary, ternary, gaussian or uniform and
    `bits` the torus width."""

    key: np.ndarray
    kind: str = "binary"
    bits: int = 32

    @property
    def dimension(self) -> int:
        return self.key.shape[0]

    @classmethod
    def generate_binary(cls, dim: int, gen: SecretRandomGenerator,
                        bits: int = 32):
        return cls(gen.generate_binary_array(dim, bits), "binary", bits)

    @classmethod
    def generate_ternary(cls, dim: int, gen: SecretRandomGenerator,
                         bits: int = 32):
        return cls(gen.generate_ternary_array(dim, bits), "ternary", bits)

    @classmethod
    def generate_gaussian(cls, dim: int, gen: SecretRandomGenerator,
                          bits: int = 32):
        return cls(gen.generate_gaussian_array(dim, bits), "gaussian", bits)

    @classmethod
    def generate_uniform(cls, dim: int, gen: SecretRandomGenerator,
                         bits: int = 32):
        return cls(gen.generate_uniform_array(dim, bits), "uniform", bits)

    def encrypt(self, plaintexts, std: float,
                gen: EncryptionRandomGenerator) -> np.ndarray:
        """Encrypt unsigned plaintexts -> [..., n+1]: b = <a, s> + e + m
        with uniform a and Gaussian e (secret/lwe.rs:320-346). Each
        ciphertext takes n mask values, then one Gaussian pair whose first
        value is kept (gaussian.rs:71-79): the stream of encrypt_lwe_list."""
        dt = UNSIGNED[self.bits]
        pts = np.asarray(plaintexts, dtype=dt)
        count = pts.size
        masks = gen.fill_mask(count * self.dimension, self.bits).reshape(
            count, self.dimension)
        g1, _ = gen.noise.random_gaussian_pairs(count, 0.0, std)
        noises = from_torus_f64(g1, self.bits)
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
                 gen: EncryptionRandomGenerator) -> "LweKeyswitchKey":
        """fill_with_keyswitch_key (keyswitch.rs:331-385): the ladder
        s_i << (bits - base_log * level) encrypted row after row with the
        shared generator (no fork)."""
        bits = in_key.bits
        dt = UNSIGNED[bits]
        shifts = np.array([bits - base_log * (lev + 1)
                           for lev in range(level_count)], dtype=dt)
        messages = in_key.key.astype(dt)[:, None] << shifts[None, :]
        data = out_key.encrypt(messages, std, gen)
        return cls(data=data, base_log=base_log, level_count=level_count,
                   bits=bits)


def _ks_digits(ct: torch.Tensor, base_log: int, level_count: int):
    """Rounded small-sign digits of the mask, flattened to [..., n_in*l]
    (the carrier's type), plus the body."""
    rounded = decomposition.closest_representable(
        ct[..., :-1], base_log, level_count)
    digits = decomposition.small_sign_decompose(rounded, base_log, level_count)
    return digits.reshape(digits.shape[:-2] + (-1,)), ct[..., -1]


def table_to_limbs(table) -> np.ndarray:
    """[K, C] u32 / u64 table -> int8 [K, n_limbs*C] of balanced signed-byte
    limbs (sum_m c_m 2^{8m} == v mod 2^bits; 4 limbs for u32, 8 for u64),
    limb plane m contiguous: the packing of the bootstrap key's rings
    (bootstrap_mxu._limb_pack). A u64 table must come as np.uint64;
    anything else is read as u32."""
    from .bootstrap_mxu import _limb_pack

    t = np.asarray(table)
    if t.dtype != np.uint64:
        t = t.astype(np.uint32)
    n_limbs = t.dtype.itemsize
    rows, cols = t.shape
    packed = _limb_pack(t.reshape(-1))
    limbs = np.stack(
        [((packed >> t.dtype.type(8 * m)) & t.dtype.type(0xFF)).astype(np.int8)
         for m in range(n_limbs)], axis=0).reshape(n_limbs, rows, cols)
    return np.moveaxis(limbs, 0, 1).reshape(rows, n_limbs * cols)


def ksk_to_limbs(ksk_data) -> np.ndarray:
    """[n_in, l, n_out+1] keyswitch key -> int8 [n_in*l, n_limbs*(n_out+1)]
    (table_to_limbs of its rows)."""
    k = np.asarray(ksk_data)
    return table_to_limbs(k.reshape(-1, k.shape[-1]))


# rows of one int8 product: |sub-digit| <= 64 times |limb| <= 128, summed,
# stays below 2^31
_INT32_ROWS = (2 ** 31 - 1) // (64 * 128)


def wrapping_dot(digits: torch.Tensor, limbs: torch.Tensor,
                 digit_bits: int) -> torch.Tensor:
    """sum_r digits[..., r] * table[r, :] mod 2^bits, exactly, for signed
    digits [..., K] (int32 / int64 carrier, |d| <= 2^(digit_bits - 1)) and
    a table given by its limbs (table_to_limbs: int8 [K, n_limbs*C]) ->
    [..., C] in the digits' carrier.

    The product of concrete_tpu's dot_general with wrapping int32 / int64
    accumulation (core/lwe.py:277-287), in a form the card runs: each digit
    is split into balanced 7-bit sub-digits e_j (|e_j| <= 64), each
    sub-digit plane times the limbs is one int8 x int8 -> int32 product
    (bootstrap_mxu.int_mm: torch._int_mm, padded for its shape limits) over
    at most 262143 rows, and the planes are summed as S_jm << (7j + 8m)
    with wrapping shifts in the carrier."""
    from .bootstrap_mxu import int_mm

    bits = bits_of(digits)
    n_limbs = bits // 8
    k = digits.shape[-1]
    cols = limbs.shape[-1] // n_limbs
    lead = digits.shape[:-1]
    d = digits.reshape(-1, k).to(torch.int64)
    out = torch.zeros((d.shape[0], cols), dtype=digits.dtype,
                      device=digits.device)
    for j in range(digit_bits // 7 + 1):
        sub = ((d + 64) & 127) - 64
        d = (d - sub) >> 7
        sub8 = sub.to(torch.int8)
        for r0 in range(0, k, _INT32_ROWS):
            r1 = min(k, r0 + _INT32_ROWS)
            s = int_mm(sub8[:, r0:r1].contiguous(), limbs[r0:r1])
            s = s.reshape(-1, n_limbs, cols).to(digits.dtype)
            for m in range(n_limbs):
                if 7 * j + 8 * m < bits:
                    out += s[:, m] << (7 * j + 8 * m)
    return out.reshape(lead + (cols,))


def keyswitch(ksk_data, ct: torch.Tensor, *, base_log: int,
              level_count: int) -> torch.Tensor:
    """Switch [..., n_in+1] ciphertexts to the output key -> [..., n_out+1],
    for any base_log (keyswitch.rs:514-560): the output body is the input
    body, minus the contraction of the rounded small-sign digits of the mask
    with the key's rows, exact mod 2^bits (wrapping_dot). `ksk_data` is the
    [n_in, l, n_out+1] key, numpy or a tensor; its limbs are prepared on
    the ciphertexts' device for this call (keyswitch_prepared takes limbs
    prepared once)."""
    ct = as_torus(ct)
    checks.check_keyswitch_key(ksk_data, ct.shape[-1] - 1, level_count,
                               ksk_data.shape[-1] - 1)
    limbs = torch.from_numpy(ksk_to_limbs(to_numpy(ksk_data))).to(ct.device)
    return _keyswitch_wide(limbs, ct, base_log, level_count)


def _keyswitch_wide(limbs: torch.Tensor, ct: torch.Tensor, base_log: int,
                    level_count: int) -> torch.Tensor:
    flat, body = _ks_digits(ct, base_log, level_count)
    out = -wrapping_dot(flat, limbs, base_log)
    out[..., -1] += body
    return out


def keyswitch_prepared(limbs: torch.Tensor, ct: torch.Tensor, *,
                       base_log: int, level_count: int) -> torch.Tensor:
    """Keyswitch against a key's limb planes (ksk_to_limbs, on ct's device):
    keyswitch_limbs where its int8 digits take the key (limbs_fit), the
    general keyswitch's product elsewhere, as concrete_tpu chooses; both
    give the same bits."""
    if limbs_fit(base_log, limbs.shape[0]):
        return keyswitch_limbs(limbs, ct, base_log=base_log,
                               level_count=level_count)
    return _keyswitch_wide(limbs, ct, base_log, level_count)


def keyswitch_limbs(ksk8: torch.Tensor, ct: torch.Tensor, *, base_log: int,
                    level_count: int) -> torch.Tensor:
    """Keyswitch [..., n_in+1] -> [..., n_out+1] against a limb-prepared key
    (ksk_to_limbs) when the digits fit int8 (base_log <= 7): one int8 x
    int8 -> int32 product with the negated digits, then the wrapping limb
    recombination sum_m S_m << 8m in the carrier's type (int32 for u32,
    int64 for u64), which is the result mod 2^bits (keyswitch.rs:514-560);
    bit for bit the general `keyswitch`."""
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


def limbs_fit(base_log: int, rows: int) -> bool:
    """Does the int8 limb keyswitch take this key (base_log <= 7 and its
    n_in*l rows within the int32 bound)? concrete_tpu's rule for handing
    the limb-prepared key (boolean/server_key.py:147-158,
    highlevel/keys.py:340-358)."""
    return base_log <= 7 and rows * 8192 < 2 ** 31



# ---------------------------------------------------------------------------
# server-side arithmetic (torch, batch-first, on the ciphertexts' device)
# ---------------------------------------------------------------------------


def trivial_encrypt(pt, dimension: int, bits: int = 32,
                    device=None) -> torch.Tensor:
    """Trivial LWE: zero mask, body = plaintext, decryptable under any key
    (lwe_ciphertext_trivial_encryption engine). pt [...] -> [..., n+1] in
    the u`bits` carrier on `device` (the tensor's own for tensor input,
    else the CPU).

    >>> trivial_encrypt(np.uint32([7, 0xFFFFFFFF]), 3).tolist()
    [[0, 0, 0, 7], [0, 0, 0, -1]]
    """
    pt = as_torus(pt, device, bits)
    out = torch.zeros(pt.shape + (dimension + 1,), dtype=pt.dtype,
                      device=pt.device)
    out[..., -1] = pt
    return out


def trivial_decrypt(ct: torch.Tensor) -> torch.Tensor:
    """Body of a trivial LWE (lwe_ciphertext_trivial_decryption engine)."""
    return ct[..., -1]


def add(ct_a, ct_b) -> torch.Tensor:
    """Homomorphic addition (wrapping)."""
    return as_torus(ct_a) + as_torus(ct_b)


def sub(ct_a, ct_b) -> torch.Tensor:
    return as_torus(ct_a) - as_torus(ct_b)


def neg(ct) -> torch.Tensor:
    """Opposite: every coefficient negated (lwe/ciphertext.rs ops)."""
    return -as_torus(ct)


def _as_torus(value, like: torch.Tensor) -> torch.Tensor:
    """(Possibly negative) Python or numpy integers as `like`'s carrier,
    wrapped two's-complement (mod 2^bits), on `like`'s device."""
    signed = np.int32 if like.dtype == torch.int32 else np.int64
    return torch.from_numpy(np.asarray(value).astype(signed)).to(like.device)


def add_plaintext(ct, pt) -> torch.Tensor:
    """Add a plaintext to the body only."""
    ct = as_torus(ct)
    out = ct.clone()
    out[..., -1] += _as_torus(pt, ct)
    return out


def sub_plaintext(ct, pt) -> torch.Tensor:
    ct = as_torus(ct)
    out = ct.clone()
    out[..., -1] -= _as_torus(pt, ct)
    return out


def scalar_mul(ct, cleartext) -> torch.Tensor:
    """Multiply every coefficient by a small (possibly negative) integer
    cleartext, wrapping."""
    ct = as_torus(ct)
    return ct * _as_torus(cleartext, ct)


def affine_transform(cts, weights, bias) -> torch.Tensor:
    """Weighted sum of a ciphertext vector plus a plaintext bias
    (lwe_ciphertext_vector_discarding_affine_transformation).

    cts [..., m, n+1]; weights [m] signed integers; bias a plaintext. The
    products and the sum wrap in the carrier (int32 / int64), so the result
    is exact mod 2^bits.

    >>> cts = torch.tensor([[1, 2], [3, -4]], dtype=torch.int32)
    >>> affine_transform(cts, [2, -1], 5).tolist()
    [-1, 13]
    """
    cts = as_torus(cts)
    w = _as_torus(weights, cts)
    out = (cts * w[..., :, None]).sum(dim=-2, dtype=cts.dtype)
    return add_plaintext(out, bias)
