"""u32 and u64 torus carriers and torus numerics for the PyTorch port.

A torus value t of width bits stands for the real t / 2^bits. The port
carries u32 values as ``torch.int32`` and u64 values as ``torch.int64`` bit
patterns: CPU torch implements wrapping ``+``, ``-``, ``*`` and ``<<`` on
the signed types but not the unsigned arithmetic the JAX package relies on,
so the unsigned view exists only at the numpy boundary (``np.uint32``,
``np.uint64``). Signed ``>>`` is arithmetic; every right shift that the JAX
package makes on an unsigned array is a logical one and goes through
:func:`lshr` here. Signed ``<`` and ``>`` are not the unsigned order.

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import from_numpy, to_numpy, lshr, i32, i64
    >>> t = from_numpy(np.array([0xFFFFFFF0, 7], dtype=np.uint32))
    >>> t.dtype, to_numpy(lshr(t, 4)).tolist()
    (torch.int32, [268435455, 0])
    >>> i32(0xE0000000)
    -536870912
    >>> w = from_numpy(np.array([1 << 63], dtype=np.uint64))
    >>> w.dtype, to_numpy(lshr(w, 60)).tolist(), i64(1 << 63)
    (torch.int64, [8], -9223372036854775808)
    >>> from concrete_tpu_torch.torus import from_torus_f64
    >>> int(from_torus_f64(0.5)), int(from_torus_f64(0.5, 64))
    (2147483648, 9223372036854775808)
    >>> from concrete_tpu_torch.torus import torus_modular_distance
    >>> float(torus_modular_distance(np.uint32(1), np.uint32(0xFFFFFFFF), 32)) * 2.0 ** 32
    2.0
"""

from __future__ import annotations

import numpy as np
import torch

UNSIGNED = {32: np.uint32, 64: np.uint64}
_SIGNED_NP = {32: np.int32, 64: np.int64}
_CARRIER = {32: torch.int32, 64: torch.int64}
_BITS = {torch.int32: 32, torch.int64: 64}


def bits_of(t: torch.Tensor) -> int:
    """Torus width carried by an int32 (32) or int64 (64) tensor."""
    if t.dtype not in _BITS:
        raise TypeError(f"torus tensors are int32 or int64, got {t.dtype}")
    return _BITS[t.dtype]


def carrier(bits: int) -> torch.dtype:
    """The signed tensor type that carries a u`bits` torus value."""
    return _CARRIER[bits]


def from_numpy(x, device=None, bits: int | None = None) -> torch.Tensor:
    """np.uint32 / np.uint64 (or anything numpy casts to it) -> int32 /
    int64 tensor, same bits. `bits` defaults to 64 for a np.uint64 array and
    to 32 for anything else."""
    if bits is None:
        bits = 64 if getattr(x, "dtype", None) == np.uint64 else 32
    arr = np.require(np.asarray(x, dtype=UNSIGNED[bits]),
                     requirements=["C", "W"])
    return torch.from_numpy(arr.view(_SIGNED_NP[bits])).to(device)


def to_numpy(t) -> np.ndarray:
    """int32 / int64 tensor (any device) -> np.uint32 / np.uint64 array, same
    bits. numpy input passes through; it becomes uint32 unless it is u64."""
    if isinstance(t, torch.Tensor):
        bits = bits_of(t)
        return t.detach().cpu().numpy().view(UNSIGNED[bits])
    if getattr(t, "dtype", None) == np.uint64:
        return np.asarray(t)
    return np.asarray(t, dtype=np.uint32)


def as_torus(x, device=None, bits: int | None = None) -> torch.Tensor:
    """Tensor view of a torus array: int32 / int64 tensors pass through
    (moved to `device` when one is given), numpy / Python values go through
    :func:`from_numpy`."""
    if isinstance(x, torch.Tensor):
        if bits is not None and bits_of(x) != bits:
            raise TypeError(f"expected a u{bits} torus tensor, got {x.dtype}")
        return x if device is None else x.to(device)
    return from_numpy(x, device, bits)


def i32(u: int) -> int:
    """The int32 bit pattern of a u32 value given as a Python int (for
    constants such as -1/8 = 0xE0000000 that do not fit int32)."""
    return ((int(u) + (1 << 31)) % (1 << 32)) - (1 << 31)


def i64(u: int) -> int:
    """The int64 bit pattern of a u64 value given as a Python int (for
    constants >= 2^63, which overflow a torch int64 scalar)."""
    return ((int(u) + (1 << 63)) % (1 << 64)) - (1 << 63)


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u32 / u64 bit patterns held in int32 / int64:
    the arithmetic shift followed by a mask of the bits - s low bits."""
    bits = bits_of(x)
    if s == 0:
        return x
    if s >= bits:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (bits - s)) - 1)


def from_torus_f64(x, bits: int = 32) -> np.ndarray:
    """Closest unsigned representation of real torus values: take the
    fractional part, scale by 2^bits, round half up, then saturate like
    Rust's ``as`` (the same rule as concrete_tpu/torus.py)."""
    x = np.asarray(x, dtype=np.float64)
    fract = (x - np.floor(x)) * 2.0 ** bits
    carry = fract - np.floor(fract)
    fract = np.where(carry >= 0.5, fract + 1.0, fract)
    fract = np.minimum(fract, 2.0 ** bits - 1)
    return np.floor(fract).astype(UNSIGNED[bits])


def into_torus_f64(t, bits: int) -> np.ndarray:
    """Closest float of an unsigned torus element (torus/mod.rs:50-55)."""
    return np.asarray(t).astype(np.float64) * 2.0 ** -bits



def into_signed_torus_f64(t, bits: int) -> np.ndarray:
    """Signed-centered float view in [-1/2, 1/2): the torus value read as a
    signed integer before the float conversion (fft/transform.rs:732-760).
    Takes numpy arrays or carrier tensors."""
    return np.asarray(to_numpy(t)).astype(_SIGNED_NP[bits]).astype(
        np.float64) * 2.0 ** -bits


def torus_modular_distance(a, b, bits: int) -> np.ndarray:
    """Signed distance a - b on the torus, as a float fraction of the torus
    (private/mod.rs:64-74): the wrapped difference read as a signed
    integer, scaled. Takes numpy arrays or carrier tensors."""
    dt = UNSIGNED[bits]
    ua = np.asarray(to_numpy(a) if isinstance(a, torch.Tensor) else a)
    ub = np.asarray(to_numpy(b) if isinstance(b, torch.Tensor) else b)
    with np.errstate(over="ignore"):
        d = (dt(0) + ua.astype(dt, copy=False)) - ub.astype(dt, copy=False)
    return d.astype(dt).astype(_SIGNED_NP[bits]).astype(np.float64) * 2.0 ** -bits
