"""Modular arithmetic for the NTT primes p < 2^31: Montgomery products with
R = 2^32 on int64 tensors (concrete_tpu/math/mod_arith.py).

Residues ride int64 tensors holding values in [0, p). The JAX package builds
its 32x32 -> 64-bit product from 16-bit limbs because the TPU has no wide
multiply; here a product of two residues below 2^31 is exact in int64, and
REDC takes its two partial products apart, as the JAX code does, so that no
sum exceeds int64: hi = (a*b) >> 32 and the high word of m*p are shifted
separately and then added. The one product that can pass 2^63, lo * n_prime,
is needed mod 2^32 only and wraps. The results are the JAX package's,
canonical residues in [0, p), bit for bit.

Example:
    >>> import torch
    >>> ctx = MontgomeryContext.new(12289)
    >>> five, seven = ctx.to_mont(torch.tensor(5)), ctx.to_mont(torch.tensor(7))
    >>> int(ctx.from_mont(ctx.mont_mul(five, seven)))
    35
    >>> ctx.pow_mod_host(ctx.root_of_unity(16), 16)
    1
"""

from __future__ import annotations

import dataclasses

import torch

_MASK32 = 0xFFFFFFFF


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e14."""
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _find_generator(p: int) -> int:
    """Smallest generator of Z_p^* (p prime)."""
    factors = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise RuntimeError("no generator found")


def redc(a: torch.Tensor, b, p, n_prime) -> torch.Tensor:
    """Montgomery product a*b*2^-32 mod p of residues (int64 tensors or
    ints; p and n_prime may be tensors that broadcast), the JAX package's
    REDC step for step: t = hi(a*b) + hi(m*p) + (lo(a*b) != 0), m =
    lo(a*b) * n_prime mod 2^32, then one conditional subtraction."""
    ab = a * b                                   # < 2^62
    lo = ab & _MASK32
    m = (lo * n_prime) & _MASK32                 # wraps; only mod 2^32 used
    t = (ab >> 32) + ((m * p) >> 32) + (lo != 0).to(torch.int64)
    return torch.where(t >= p, t - p, t)


def mod_add(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    s = a + b
    return torch.where(s >= p, s - p, s)


def mod_sub(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    return torch.where(a >= b, a - b, a + (p - b))


@dataclasses.dataclass(frozen=True)
class MontgomeryContext:
    """Montgomery arithmetic mod a prime p < 2^31 with R = 2^32."""

    p: int
    n_prime: int  # -p^{-1} mod 2^32
    r1: int       # R mod p   (Montgomery form of 1)
    r2: int       # R^2 mod p (to_mont multiplier)

    @classmethod
    def new(cls, p: int) -> "MontgomeryContext":
        assert p < (1 << 31) and p % 2 == 1 and _is_prime(p), p
        p_inv = pow(p, -1, 1 << 32)
        return cls(p=p, n_prime=(-p_inv) % (1 << 32), r1=(1 << 32) % p,
                   r2=(1 << 64) % p)

    def mont_mul(self, a: torch.Tensor, b) -> torch.Tensor:
        """REDC(a*b) = a*b*R^-1 mod p; a, b in [0, p) (int64 results)."""
        return redc(a.to(torch.int64), b, self.p, self.n_prime)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.r2)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, 1)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mod_add(a.to(torch.int64), b, self.p)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mod_sub(a.to(torch.int64), b, self.p)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        a = a.to(torch.int64)
        return torch.where(a == 0, a, self.p - a)

    def pow_mod_host(self, base: int, exp: int) -> int:
        return pow(base % self.p, exp, self.p)

    def root_of_unity(self, order: int) -> int:
        """A primitive order-th root of unity mod p (order | p-1)."""
        assert (self.p - 1) % order == 0, (self.p, order)
        g = _find_generator(self.p)
        psi = pow(g, (self.p - 1) // order, self.p)
        assert pow(psi, order // 2, self.p) == self.p - 1
        return psi
