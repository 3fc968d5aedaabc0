"""u32 torus carriers and torus numerics for the PyTorch port.

A u32 torus value t stands for the real t / 2^32. The port carries such
values as ``torch.int32`` bit patterns: CPU torch implements wrapping
``+``, ``-``, ``*`` and ``<<`` on int32 but raises on uint32 arithmetic, so
the unsigned view exists only at the numpy boundary (``np.uint32``).
int32 ``>>`` is arithmetic; every right shift that the JAX package makes on
a uint32 array is a logical one and goes through :func:`lshr` here.

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import from_numpy, to_numpy, lshr, i32
    >>> t = from_numpy(np.array([0xFFFFFFF0, 7], dtype=np.uint32))
    >>> t.dtype, to_numpy(lshr(t, 4)).tolist()
    (torch.int32, [268435455, 0])
    >>> i32(0xE0000000)
    -536870912
    >>> from concrete_tpu_torch.torus import from_torus_f64
    >>> int(from_torus_f64(0.5))
    2147483648
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def from_numpy(x, device=None) -> torch.Tensor:
    """np.uint32 (or anything numpy casts to it) -> int32 tensor, same bits."""
    arr = np.require(np.asarray(x, dtype=np.uint32), requirements=["C", "W"])
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(t) -> np.ndarray:
    """int32 tensor (any device) -> np.uint32 array, same bits. numpy input
    passes through as uint32."""
    if isinstance(t, torch.Tensor):
        if t.dtype != torch.int32:
            raise TypeError(f"u32 torus tensors are int32, got {t.dtype}")
        return t.detach().cpu().numpy().view(np.uint32)
    return np.asarray(t, dtype=np.uint32)


def as_torus(x, device=None) -> torch.Tensor:
    """Tensor view of a u32 torus array: int32 tensors pass through (moved to
    `device` when one is given), numpy / Python values go via np.uint32."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"u32 torus tensors are int32, got {x.dtype}")
        return x if device is None else x.to(device)
    return from_numpy(x, device)


def i32(u: int) -> int:
    """The int32 bit pattern of a u32 value given as a Python int (for
    constants such as -1/8 = 0xE0000000 that do not fit int32)."""
    return ((int(u) + (1 << 31)) % (1 << 32)) - (1 << 31)


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u32 bit patterns held in int32: the arithmetic
    shift followed by a mask of the 32 - s low bits."""
    if s == 0:
        return x
    if s >= 32:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (32 - s)) - 1)


def from_torus_f64(x) -> np.ndarray:
    """Closest u32 representation of real torus values: take the fractional
    part, scale by 2^32, round half up, then saturate like Rust's ``as``
    (the same rule as concrete_tpu/torus.py)."""
    x = np.asarray(x, dtype=np.float64)
    fract = (x - np.floor(x)) * 2.0 ** 32
    carry = fract - np.floor(fract)
    fract = np.where(carry >= 0.5, fract + 1.0, fract)
    fract = np.minimum(fract, 2.0 ** 32 - 1)
    return np.floor(fract).astype(np.uint32)


@dataclasses.dataclass
class EncryptionRandom:
    """Mask and noise streams for encryption and key generation: two
    ``numpy.random.Generator`` objects seeded from ``mask_seed`` and
    ``noise_seed``. Masks are uniform u32; noise is Gaussian on the real
    torus, rounded with :func:`from_torus_f64`.

    These are not the AES-CTR streams of ``concrete_tpu.csprng``, so keys and
    ciphertexts made here differ from the JAX package's for the same seeds;
    keys made by the JAX package can be loaded (``ClientKey.load``,
    ``ServerKey.load``)."""

    mask: np.random.Generator
    noise: np.random.Generator

    @classmethod
    def new(cls, mask_seed: int | None = None, noise_seed: int | None = None):
        return cls(np.random.default_rng(mask_seed),
                   np.random.default_rng(noise_seed))

    def fill_mask(self, shape) -> np.ndarray:
        return self.mask.integers(0, 1 << 32, size=shape, dtype=np.uint32)

    def fill_noise(self, shape, std: float) -> np.ndarray:
        return from_torus_f64(self.noise.normal(0.0, std, size=shape))
