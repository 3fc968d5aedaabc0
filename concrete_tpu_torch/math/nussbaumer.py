"""Nussbaumer polynomial transform on int32 / int64 tensors: the negacyclic
product of size N = L*M as 2L exact M-point negacyclic products, with
rotation-only transforms (the counterpart of concrete_tpu/math/nussbaumer.py).

The ring isomorphism (strided chunking, Z = X^L):

    Z[X]/(X^N + 1)  ~=  R_M[Y] / (Y^L - Z),   R_M = Z[Z]/(Z^M + 1)

chunk i of a polynomial a is a_i(Z) = sum_j a[jL + i] Z^j. The product mod
(Y^L - Z) is the linear convolution of the zero-padded chunk sequences,
computed with a cyclic 2L-point polynomial transform whose root is
omega = Z^(M/L), then folded: c_t <- c_t + Z * c_{t+L}. Every twiddle is a
negacyclic rotation of the M axis, so the transforms have no multiplies. The
inverse transform leaves a factor 2L, which the callers remove with a right
shift after carrying log2(2L) extra bits.

Wrapping adds on int32 / int64 are arithmetic mod 2^32 / 2^64, as JAX's
uint32 / uint64. Host numpy arrays are taken as well (unsigned or signed
integer arrays, returned in their own type), as the JAX module's ``_xp``
takes them.

Example (the round trip leaves 2L times the chunks, before the fold):
    >>> import numpy as np
    >>> x = np.arange(16, dtype=np.uint32)
    >>> back = inverse_raw(forward(chunk(x, 4), 4), 4)
    >>> bool((back[:4] == chunk(x, 4)[:4] * 8).all())
    True
    >>> m = monomial_mul_chunked(chunk(x, 4)[:4], 1, 4)   # x * X, chunk-major
    >>> unchunk(m, 4)[:3].tolist()
    [4294967281, 0, 1]
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..torus import lshr

_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def _host_numpy(fn):
    """Run `fn` on torch views of numpy arguments and hand numpy back in the
    first argument's type (unsigned arrays travel as their signed views,
    which wrap the same way)."""

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        if not isinstance(x, np.ndarray):
            return fn(x, *args, **kwargs)
        dt = x.dtype
        arr = np.require(x, requirements=["C", "W"])
        t = torch.from_numpy(arr.view(_SIGNED.get(dt, dt)))
        return fn(t, *args, **kwargs).numpy().view(dt)

    return wrapper


def pick_l(n: int, max_m: int = 1024, min_m: int = 128) -> int:
    """Largest power-of-two L with M = N/L in [min_m, max_m] and L <= M
    (the 2L-th root Z^(M/L) needs L | M). Returns 1 when N <= min_m.

    >>> pick_l(8192), pick_l(64)
    (64, 1)
    """
    l = 1
    while n // (2 * l) >= min_m and 2 * l <= n // (2 * l):
        l *= 2
    while n // l > max_m and l < n // l:
        l *= 2
    return l


@_host_numpy
def chunk(x: torch.Tensor, l: int) -> torch.Tensor:
    """[..., N] -> [..., 2L, M] strided chunks, zero-padded to 2L:
    out[..., i, j] = x[..., j*L + i] for i < L, 0 for i >= L."""
    m = x.shape[-1] // l
    xr = x.reshape(x.shape[:-1] + (m, l)).transpose(-1, -2)
    return torch.cat([xr, torch.zeros_like(xr)], dim=-2)


@_host_numpy
def unchunk(c: torch.Tensor, l: int) -> torch.Tensor:
    """Inverse of chunk on the first L chunks: [..., L, M] -> [..., N]."""
    return c.transpose(-1, -2).reshape(c.shape[:-2] + (c.shape[-1] * l,))


def twiddle_gather(rows: int, m: int, step: int, shift: int, device):
    """(index, negate) [rows, m] of row j times Z^(j*step + shift) in
    R_M = Z[Z]/(Z^M + 1): out[c] = x[(c - s) mod M], negated when
    (c - s) mod 2M >= M. The JAX package writes one slice+concat per row
    because its TPU compiler needed that form; this is the same function as
    one signed gather."""
    s = torch.arange(rows, device=device) * step + shift
    t = (torch.arange(m, device=device) - s[:, None]) % (2 * m)
    return t % m, t >= m


def _neg_roll_rows(x: torch.Tensor, step: int, shift: int = 0) -> torch.Tensor:
    """Row j of x [..., R, M] times Z^(j*step + shift): the twiddles of a
    transform stage (shift 0) or one static rotation (step 0)."""
    idx, neg = twiddle_gather(x.shape[-2], x.shape[-1], step, shift, x.device)
    vals = torch.gather(x, -1, idx.expand(x.shape))
    return torch.where(neg, -vals, vals)


@_host_numpy
def forward(c: torch.Tensor, l: int) -> torch.Tensor:
    """Cyclic 2L-point polynomial transform of chunk sequences c [..., 2L, M]
    (decimation in frequency, bit-reversed output): the twiddle of element j
    of the high half at stage s is omega^(j * 2^s) = Z^(root * j * 2^s)."""
    two_l, m = c.shape[-2], c.shape[-1]
    if two_l != 2 * l:
        raise ValueError(f"expected 2L={2 * l} chunks, got {two_l}")
    root = m // l
    x = c
    for s in range(two_l.bit_length() - 1):
        half = two_l >> (s + 1)
        xr = x.reshape(x.shape[:-2] + (1 << s, 2 * half, m))
        a, b = xr[..., :half, :], xr[..., half:, :]
        hi = _neg_roll_rows(a - b, root << s)
        x = torch.stack([a + b, hi], dim=-3).reshape(c.shape)
    return x


@_host_numpy
def inverse_raw(f: torch.Tensor, l: int) -> torch.Tensor:
    """Inverse transform without the 1/(2L) scaling: bit-reversed spectra
    [..., 2L, M] -> 2L * chunks in natural order."""
    two_l, m = f.shape[-2], f.shape[-1]
    if two_l != 2 * l:
        raise ValueError(f"expected 2L={2 * l} chunks, got {two_l}")
    root = m // l
    x = f
    for s in reversed(range(two_l.bit_length() - 1)):
        half = two_l >> (s + 1)
        xr = x.reshape(x.shape[:-2] + (1 << s, 2, half, m))
        u = xr[..., 0, :, :]
        v = _neg_roll_rows(xr[..., 1, :, :], -(root << s))
        x = torch.cat([u + v, u - v], dim=-2).reshape(f.shape)
    return x


@_host_numpy
def fold(c2l: torch.Tensor, l: int) -> torch.Tensor:
    """Reduce the 2L-term chunk convolution mod (Y^L - Z):
    out_t = c_t + Z * c_{t+L}, t in [0, L). [..., 2L, M] -> [..., L, M]."""
    return c2l[..., :l, :] + _neg_roll_rows(c2l[..., l:, :], 0, 1)


def _chunk_source(l: int, m: int, degree: torch.Tensor):
    """(flat index, negate) of c * X^degree in the chunk-major layout: the
    standard coefficient n = j*L + i lives at chunk i, position j (flat
    i*M + j); output n takes input (n - degree) mod 2N, negated past N.
    degree [...] int -> index and mask [..., L*M]."""
    n = l * m
    dev = degree.device
    flat = torch.arange(n, device=dev)
    std = (flat % m) * l + flat // m                  # standard index of flat
    t = (std - degree[..., None].to(torch.int64)) % (2 * n)
    src = t % n
    return (src % l) * m + src // l, t >= n


@_host_numpy
def monomial_mul_chunked(c: torch.Tensor, degree, l: int) -> torch.Tensor:
    """c * X^degree on chunk-major data c [..., L, M] (chunk(x, l) without
    its zero padding); degree an int or integer tensor broadcastable against
    the leading axes, read mod 2N. One signed gather: the JAX package's
    log2(2N)-stage barrel of static rolls computes the same values."""
    m = c.shape[-1]
    degree = torch.as_tensor(degree, device=c.device)
    lead = torch.broadcast_shapes(c.shape[:-2], degree.shape)
    idx, neg = _chunk_source(l, m, degree.expand(lead))
    vals = torch.gather(c.expand(lead + (l, m)).reshape(lead + (l * m,)), -1,
                        idx)
    return torch.where(neg, -vals, vals).reshape(lead + (l, m))


def negacyclic_polymul_nuss(a, b, l: int, mulm):
    """a * b mod (X^N + 1) through the Nussbaumer domain, the reference
    composition of the tests. `mulm(x, y)` is the exact negacyclic M-point
    product of the trailing axes. All arithmetic runs in the inputs' type;
    the 2L factor leaves by a logical right shift, so the result is exact
    mod 2^(bits - log2(2L)) (the JAX contract)."""
    prod = mulm(forward(chunk(a, l), l), forward(chunk(b, l), l))
    c = fold(inverse_raw(prod, l), l)
    shift = (2 * l).bit_length() - 1
    if isinstance(c, np.ndarray):
        return unchunk(c >> c.dtype.type(shift), l)
    return unchunk(lshr(c, shift), l)
