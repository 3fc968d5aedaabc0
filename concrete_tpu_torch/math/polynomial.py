"""Negacyclic polynomial operations (mod X^N + 1) on u32 / u64 torus tensors
(int32 / int64 carriers).

A monomial product is a signed gather: coefficient c of X^d * p is
p[(c - d) mod N], negated when (c - d) mod 2N >= N (X^N == -1). The JAX
package writes the same product as a barrel of static rolls because its
TPU compiler hung on dynamic rolls; the values are identical.

Example (multiply by X: the wrapped coefficient is negated):
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import from_numpy, to_numpy
    >>> poly = from_numpy(np.arange(4))
    >>> to_numpy(negacyclic_monomial_mul(poly, 1)).tolist()
    [4294967293, 0, 1, 2]
    >>> to_numpy(negacyclic_monomial_div(negacyclic_monomial_mul(poly, 1), 1)).tolist()
    [0, 1, 2, 3]
    >>> key = torch.tensor([[0, 1, 0, 0]])               # X
    >>> to_numpy(negacyclic_multisum(poly[None], key)).tolist()
    [4294967293, 0, 1, 2]
    >>> poly64 = from_numpy(np.array([1 << 63, 0, 0, 5], dtype=np.uint64))
    >>> to_numpy(negacyclic_multisum(poly64[None], key)).tolist()
    [18446744073709551611, 9223372036854775808, 0, 0]
"""

from __future__ import annotations

import numbers

import torch

from ..torus import bits_of


def negacyclic_monomial_mul(poly: torch.Tensor, degree) -> torch.Tensor:
    """poly * X^degree mod (X^N + 1) (polynomial.rs:685-707).

    poly: [..., N] int32 or int64; degree: int or integer tensor broadcastable against
    poly.shape[:-1], read mod 2N. An int is filled in on the device: a copy
    from the host is what a CUDA graph capture refuses."""
    n = poly.shape[-1]
    if isinstance(degree, numbers.Integral):
        degree = torch.full((), int(degree), dtype=torch.int64,
                            device=poly.device)
    degree = torch.as_tensor(degree, dtype=torch.int64, device=poly.device)
    lead = torch.broadcast_shapes(poly.shape[:-1], degree.shape)
    src = (torch.arange(n, device=poly.device)
           - degree.expand(lead)[..., None]) & (2 * n - 1)
    vals = torch.gather(poly.expand(lead + (n,)), -1, src & (n - 1))
    return torch.where(src >= n, -vals, vals)


def negacyclic_monomial_div(poly: torch.Tensor, degree) -> torch.Tensor:
    """poly * X^-degree mod (X^N + 1) (polynomial.rs:709-744)."""
    if not isinstance(degree, numbers.Integral):
        degree = torch.as_tensor(degree, dtype=torch.int64, device=poly.device)
    return negacyclic_monomial_mul(poly, -degree)


def negacyclic_multisum(torus_polys: torch.Tensor, key: torch.Tensor):
    """sum_j torus_polys[..., j, :] * key[j, :] mod (X^N + 1, 2^bits) for
    u32 (int32) or u64 (int64) torus polynomials and a key [k, N] in the
    same carrier (or any integer tensor), exactly, for every key kind.

    Key generation's mask-times-key product, in float64 products whose
    every partial sum stays below 2^53 for k*N <= 2^21, recombined mod
    2^bits in int64. A key with entries in {-1, 0, 1} (binary and ternary
    keys, concrete_tpu's small_max = 1) multiplies each unsigned 32-bit
    word of the torus values (one for u32, two for u64); any other key is
    split into 16-bit limbs, as the torus values are, and the limb products
    that reach below 2^bits are summed (3 for u32, 10 for u64)."""
    k, n = key.shape
    if k * n > (1 << 21):
        raise ValueError(f"k*N={k * n}: float64 sums would not stay exact")
    bits = bits_of(torus_polys)
    dev = torus_polys.device
    key = key.to(dev)
    small = int(key.to(torch.int64).abs().max()) <= 1
    rows = torch.arange(n, device=dev)
    wide = torus_polys.to(torch.int64).reshape(-1, k * n)
    out = torch.zeros((wide.shape[0], n), dtype=torch.int64, device=dev)
    if small:
        key_limbs, width = [key.to(torch.int64)], 32
    else:
        key_limbs, width = [(key.to(torch.int64) >> s) & 0xFFFF
                            for s in range(0, bits, 16)], 16
    mask = (1 << width) - 1
    for l, limb in enumerate(key_limbs):
        # M[j, i, :] = X^i * limb_j, so (a_j * limb_j) = sum_i a_j[i] M[j, i, :]
        mats = negacyclic_monomial_mul(limb[:, None, :], rows[None, :])
        mats = mats.reshape(k * n, n).to(torch.float64)
        for w in range(bits // width - l * (width == 16)):
            word = (wide >> (width * w)) & mask
            shift = width * w + (16 * l if width == 16 else 0)
            out += (word.to(torch.float64) @ mats).to(torch.int64) << shift
    lead = torus_polys.shape[:-2]
    if bits == 32:
        out = out & 0xFFFFFFFF
        out = (out - ((out >> 31) << 32)).to(torch.int32)
    return out.reshape(lead + (n,))
