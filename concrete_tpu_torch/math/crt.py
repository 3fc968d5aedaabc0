"""CRT residues and Garner reconstruction for the exact external product
(concrete_tpu/math/crt.py), on torch tensors.

The negacyclic product of a signed-digit polynomial (|digit| <= B/2) with a
torus polynomial centered in [-q/2, q/2) has integer coefficients bounded by
V = N * n_polys * (B/2) * q/2. It is computed modulo a set of NTT primes
whose product M > 2V, the signed integer is rebuilt by Garner's algorithm in
mixed radix, and reduced mod q = 2^bits.

Torus values arrive in the port's carriers (int32 for u32, int64 for u64),
which already hold the centered signed value; residues are int64 in [0, p).
The Garner digits stay below 2^31, so the signed compares are the unsigned
ones; the last weighted sum is taken mod 2^bits in wrapping int64 (the u64
weights go in as their int64 bit patterns).

Example:
    >>> import torch
    >>> primes = select_primes(2 ** 40)
    >>> ctx = CrtContext.new(primes, 32)
    >>> x = torch.tensor([123456789, -5], dtype=torch.int32)
    >>> ctx.combine_to_torus(ctx.residues_from_torus(x)).tolist()
    [123456789, -5]
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..torus import i32, i64
from .mod_arith import MontgomeryContext, mod_add, mod_sub
from .ntt import DEFAULT_PRIMES


def select_primes(bound: int, candidates=DEFAULT_PRIMES) -> tuple[int, ...]:
    """Smallest prefix of `candidates` with product > 2 * bound (with margin)."""
    prod = 1
    out = []
    for p in candidates:
        out.append(p)
        prod *= p
        if prod > 4 * bound:  # x2 for sign, x2 safety margin
            return tuple(out)
    raise ValueError(f"prime pool too small for bound {bound}")


def external_product_bound(n: int, n_polys: int, base: int, bits: int) -> int:
    """Max |coefficient| of the accumulated decomposed-GLWE x GGSW product:
    n_polys = level_count * glwe_size polynomial products, digits in
    [-B/2, B/2], torus values centered in [-q/2, q/2)."""
    return n * n_polys * (base // 2) * (1 << (bits - 1))


@dataclasses.dataclass(frozen=True)
class CrtContext:
    """Garner reconstruction constants for a prime set and torus width."""

    primes: tuple[int, ...]
    bits: int
    garner_inv: tuple[int, ...]               # inv(p_1..p_{i-1}) mod p_i
    prefix_mod_pi: tuple[tuple[int, ...], ...]  # (p_1..p_{j-1}) mod p_i, j < i
    prefix_mod_q: tuple[int, ...]             # (p_1..p_{i-1}) mod 2^bits
    half_digits: tuple[int, ...]              # mixed-radix digits of ceil(M/2)
    m_mod_q: int                              # M mod 2^bits

    @classmethod
    @functools.lru_cache(maxsize=None)
    def new(cls, primes: tuple[int, ...], bits: int) -> "CrtContext":
        k = len(primes)
        M = 1
        for p in primes:
            M *= p
        q = 1 << bits
        garner_inv, prefix_mod_pi = [], []
        for i in range(k):
            pref = 1
            mods = []
            for j in range(i):
                mods.append(pref % primes[i])
                pref *= primes[j]
            prefix_mod_pi.append(tuple(mods))
            garner_inv.append(pow(pref % primes[i], -1, primes[i]) if i else 1)
        prefix_mod_q = []
        pref = 1
        for i in range(k):
            prefix_mod_q.append(pref % q)
            pref *= primes[i]
        # mixed-radix digits of T = ceil(M/2): v >= T  <=>  v - M/2 >= 0
        t = (M + 1) // 2
        half_digits = []
        for p in primes:
            half_digits.append(t % p)
            t //= p
        return cls(primes=primes, bits=bits, garner_inv=tuple(garner_inv),
                   prefix_mod_pi=tuple(prefix_mod_pi),
                   prefix_mod_q=tuple(prefix_mod_q),
                   half_digits=tuple(half_digits), m_mod_q=M % q)

    def residues_from_torus(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Residues of torus values read as centered signed integers: the
        int32 / int64 carrier is that value. -> P int64 tensors in [0, p)."""
        s = x.to(torch.int64)
        return [s % p for p in self.primes]

    def residues_from_signed(self, d: torch.Tensor) -> list[torch.Tensor]:
        """Residues of small signed integers (decomposition digits)."""
        s = d.to(torch.int64)
        return [s % p for p in self.primes]

    def combine_to_torus(self, residues) -> torch.Tensor:
        """Garner-reconstruct the signed value mod 2^bits: residues, P plain
        (not Montgomery) int64 tensors in [0, p_i) -> the torus carrier
        (int32 for 32 bits, int64 for 64). The digit recurrences are the
        JAX package's Montgomery steps."""
        k = len(self.primes)
        xs = [residues[0].to(torch.int64)]  # mixed-radix digits, < p_i
        for i in range(1, k):
            ctx = MontgomeryContext.new(self.primes[i])
            r = (1 << 32) % self.primes[i]
            t = None
            for j in range(i):
                cj = self.prefix_mod_pi[i][j] * r % self.primes[i]
                term = ctx.mont_mul(xs[j], cj)
                t = term if t is None else mod_add(t, term, ctx.p)
            diff = mod_sub(residues[i].to(torch.int64), t, ctx.p)
            ci = self.garner_inv[i] * r % self.primes[i]
            xs.append(ctx.mont_mul(diff, ci))
        # v >= ceil(M/2)? a lexicographic compare of the mixed-radix digits,
        # folded from the least significant digit up
        ge = xs[0] >= self.half_digits[0]
        for i in range(1, k):
            ti = self.half_digits[i]
            ge = (xs[i] > ti) | ((xs[i] == ti) & ge)
        weight = i32 if self.bits == 32 else i64
        v = torch.zeros_like(xs[0])
        for i in range(k):
            v = v + weight(self.prefix_mod_q[i]) * xs[i]    # wraps mod 2^64
        v = v - torch.where(ge, weight(self.m_mod_q), 0)
        if self.bits == 32:
            return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
        return v
