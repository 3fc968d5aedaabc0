"""Exact negacyclic NTT over Z_p[X]/(X^N + 1) for the primes of the exact
backend (concrete_tpu/math/ntt.py), on int64 tensors of residues.

Plans hold host numpy tables, the JAX package's bit for bit: the twist
psi^i * R^2 (to Montgomery form and negacyclic twist in one product), the
untwist psi^-i * N^-1 (from Montgomery form, untwist and 1/N in one), and
per stage s the Montgomery twiddles omega^(j * 2^s) * R, j < N >> (s+1).

The forward transform is a decimation in frequency: natural order in,
Montgomery spectra in bit-reversed order out; the inverse consumes that
order, so a pointwise product needs no permutation. The stacked form runs
every CRT prime of a configuration in one tensor [P, ..., N].

The JAX package's roll plans (forward_roll / inverse_roll) and batch-last
transforms are TPU layouts of the same values and are not ported: the CUDA
kernel of the CMux step (csrc/ntt_kernels.cu) reads the per-stage tables of
make_plan directly.

Example (X * X^7 == -1 mod X^8 + 1):
    >>> import torch
    >>> plan = make_plan(8, 97)
    >>> a = torch.zeros(8, dtype=torch.int64); a[1] = 1
    >>> b = torch.zeros(8, dtype=torch.int64); b[7] = 1
    >>> negacyclic_polymul_mod_p(plan, a, b).tolist()
    [96, 0, 0, 0, 0, 0, 0, 0]
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .mod_arith import MontgomeryContext, mod_add, mod_sub, redc

# NTT-friendly primes < 2^31 with high 2-adicity, largest first (the JAX
# package's pool). (p - 1) factorizations: 2013265921 = 15*2^27+1,
# 1811939329 = 27*2^26+1, 2113929217 = 63*2^25+1, 469762049 = 7*2^26+1.
DEFAULT_PRIMES = (2013265921, 1811939329, 2113929217, 469762049)


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Per-(N, p) transform plan: Montgomery context + twiddle tables."""

    n: int
    ctx: MontgomeryContext
    twist_fwd: np.ndarray     # [N]  psi^i * R^2 mod p
    untwist_inv: np.ndarray   # [N]  psi^-i * N^-1 mod p
    w_fwd: tuple              # per stage s: [N >> (s+1)] omega^(j*N/L) * R mod p
    w_inv: tuple              # per stage s: inverse twiddles, Montgomery form


@functools.lru_cache(maxsize=None)
def make_plan(n: int, p: int) -> NttPlan:
    ctx = MontgomeryContext.new(p)
    psi = ctx.root_of_unity(2 * n)
    psi_inv = pow(psi, -1, p)
    omega = psi * psi % p
    omega_inv = pow(omega, -1, p)
    n_inv = pow(n, -1, p)
    r = (1 << 32) % p
    r2 = (1 << 64) % p
    twist_fwd = np.array([pow(psi, i, p) * r2 % p for i in range(n)],
                         dtype=np.uint32)
    untwist_inv = np.array([pow(psi_inv, i, p) * n_inv % p for i in range(n)],
                           dtype=np.uint32)
    w_fwd, w_inv = [], []
    for s in range(n.bit_length() - 1):
        L = n >> s
        wf = pow(omega, n // L, p)
        wi = pow(omega_inv, n // L, p)
        w_fwd.append(np.array([pow(wf, j, p) * r % p for j in range(L // 2)],
                              dtype=np.uint32))
        w_inv.append(np.array([pow(wi, j, p) * r % p for j in range(L // 2)],
                              dtype=np.uint32))
    return NttPlan(n=n, ctx=ctx, twist_fwd=twist_fwd, untwist_inv=untwist_inv,
                   w_fwd=tuple(w_fwd), w_inv=tuple(w_inv))


_DEVICE_TABLES: dict = {}


def _on_device(arr: np.ndarray, device) -> torch.Tensor:
    """A plan table as an int64 tensor on `device`, copied once per device
    (the entry keeps the table alive, so its id stays its own)."""
    key = (id(arr), str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = (arr, torch.from_numpy(
            np.asarray(arr, dtype=np.int64)).to(device))
    return _DEVICE_TABLES[key][1]


@dataclasses.dataclass(frozen=True)
class StackedNttPlans:
    """Every CRT prime in one tensor: per-prime constants are [P]-leading
    arrays broadcast against [P, ..., N] data."""

    n: int
    primes: tuple
    p: np.ndarray            # [P] uint32
    n_prime: np.ndarray      # [P] uint32  (-p^-1 mod 2^32)
    twist_fwd: np.ndarray    # [P, N]
    untwist_inv: np.ndarray  # [P, N]
    w_fwd: tuple             # per stage: [P, m]
    w_inv: tuple

    def _bc(self, arr: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        """A [P, ...] constant as an int64 tensor on x's device, shaped to
        broadcast against x = [P, ..., trailing]."""
        a = _on_device(arr, x.device)
        return a.reshape(a.shape[:1] + (1,) * (x.ndim - a.ndim) + a.shape[1:])

    def mont_mul(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return redc(x, y, self._bc(self.p, x), self._bc(self.n_prime, x))

    def add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return mod_add(x, y, self._bc(self.p, x))

    def sub(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return mod_sub(x, y, self._bc(self.p, x))


@functools.lru_cache(maxsize=None)
def make_stacked_plans(n: int, primes: tuple) -> StackedNttPlans:
    plans = [make_plan(n, p) for p in primes]
    stages = range(len(plans[0].w_fwd))
    return StackedNttPlans(
        n=n,
        primes=primes,
        p=np.array(primes, dtype=np.uint32),
        n_prime=np.array([pl.ctx.n_prime for pl in plans], dtype=np.uint32),
        twist_fwd=np.stack([pl.twist_fwd for pl in plans]),
        untwist_inv=np.stack([pl.untwist_inv for pl in plans]),
        w_fwd=tuple(np.stack([pl.w_fwd[s] for pl in plans]) for s in stages),
        w_inv=tuple(np.stack([pl.w_inv[s] for pl in plans]) for s in stages),
    )


def forward_stacked(sp: StackedNttPlans, x: torch.Tensor) -> torch.Tensor:
    """Stacked negacyclic forward NTT: x [P, ..., N] plain residues ->
    Montgomery spectra, bit-reversed, all primes in one pass (int64)."""
    n = sp.n
    lead = x.shape[:-1]
    x = x.to(torch.int64)
    x = sp.mont_mul(x, sp._bc(sp.twist_fwd, x))
    for s in range(n.bit_length() - 1):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2 * m))
        a, b = xr[..., :m], xr[..., m:]
        hi = sp.mont_mul(sp.sub(a, b), sp._bc(sp.w_fwd[s], xr))
        x = torch.stack([sp.add(a, b), hi], dim=-2).reshape(lead + (n,))
    return x


def inverse_stacked(sp: StackedNttPlans, x: torch.Tensor) -> torch.Tensor:
    """Stacked inverse: [P, ..., N] Montgomery spectra -> plain residues."""
    n = sp.n
    lead = x.shape[:-1]
    x = x.to(torch.int64)
    for s in reversed(range(n.bit_length() - 1)):
        m = n >> (s + 1)
        xr = x.reshape(lead + (1 << s, 2, m))
        u = xr[..., 0, :]
        v = sp.mont_mul(xr[..., 1, :], sp._bc(sp.w_inv[s], u))
        x = torch.cat([sp.add(u, v), sp.sub(u, v)], dim=-1).reshape(lead + (n,))
    return sp.mont_mul(x, sp._bc(sp.untwist_inv, x))


def _single(plan: NttPlan) -> StackedNttPlans:
    return make_stacked_plans(plan.n, (plan.ctx.p,))


def forward(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT for one prime: [..., N] residues in [0, p) ->
    [..., N] Montgomery spectrum in bit-reversed order."""
    return forward_stacked(_single(plan), x[None])[0]


def inverse(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse NTT: [..., N] Montgomery spectrum (bit-reversed)
    -> [..., N] plain residues."""
    return inverse_stacked(_single(plan), x[None])[0]


def negacyclic_polymul_mod_p(plan: NttPlan, a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Exact a*b mod (X^N + 1, p) of residue polynomials (a test helper)."""
    return inverse(plan, plan.ctx.mont_mul(forward(plan, a), forward(plan, b)))
