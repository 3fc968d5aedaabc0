"""Signed gadget decomposition on u32 / u64 torus values held in int32 /
int64 tensors.

The same two decomposition flavours as concrete_tpu/math/decomposition.py,
bit for bit: the external-product iterator (round to the closest
representable value, then digits with the carry rule of decomposer.rs) and
the keyswitch's small-sign decomposition. Every shift that the JAX code
makes on an unsigned type is logical and goes through ``lshr``; the ``<<``
shifts wrap in the signed carrier exactly as they wrap unsigned. Digits come
back in the carrier's type (int32 for u32, int64 for u64).

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import from_numpy, to_numpy
    >>> x = from_numpy(np.array([0x12345678], dtype=np.uint32))
    >>> d = decompose_rounded(x, base_log=8, levels=2)
    >>> d.tolist()
    [[18, 52]]
    >>> hex(int(to_numpy(recompose(d, 8, 2))[0]))      # top 16 bits, rounded
    '0x12340000'
    >>> x64 = from_numpy(np.array([0x123456789ABCDEF0], dtype=np.uint64))
    >>> decompose_rounded(x64, base_log=16, levels=2).tolist()
    [[4660, 22137]]
"""

from __future__ import annotations

import torch

from ..torus import bits_of, lshr


def closest_representable(x: torch.Tensor, base_log: int, levels: int):
    """Round half up to the closest sum_{i<=l} d_i q/B^i lattice point; a
    value that rounds up to q wraps to 0 (decomposer.rs:99-116)."""
    non_rep = bits_of(x) - levels * base_log
    if non_rep == 0:
        return x
    msb = lshr(x, non_rep - 1) & 1
    return (lshr(x, non_rep) + msb) << non_rep


def decompose_levels(x: torch.Tensor, base_log: int, levels: int):
    """Signed digits of pre-rounded values on a new last axis, level 1..l
    (the input's type). The iterator yields level l first; the output is
    filled back to front (iter.rs:200-284)."""
    mask = (1 << base_log) - 1
    state = lshr(x, bits_of(x) - base_log * levels)
    out = [None] * levels
    for step in range(levels):
        res = state & mask
        state = lshr(state, base_log)
        carry = ((res - 1) | state) & res
        carry = lshr(carry, base_log - 1)
        state = state + carry
        out[levels - 1 - step] = res - (carry << base_log)
    return torch.stack(out, dim=-1)


def decompose_rounded(x: torch.Tensor, base_log: int, levels: int):
    """closest_representable + decompose_levels (decomposer.rs:169-186)."""
    return decompose_levels(closest_representable(x, base_log, levels),
                            base_log, levels)


def small_sign_decompose(x: torch.Tensor, base_log: int, levels: int):
    """The keyswitch decomposition (decomposition/mod.rs:45-67) of values
    already rounded with closest_representable: digits on a new last axis,
    level 1..l, carried LSB to MSB with the carry-OR rule."""
    bits = bits_of(x)
    block_mask = (1 << base_log) - 1
    msb_mask = 1 << (base_log - 1)
    carry = torch.zeros_like(x)
    out = [None] * levels
    for i in reversed(range(levels)):
        prev_carry = carry
        tmp = lshr(x, bits - base_log * (i + 1)) & block_mask
        carry = tmp & msb_mask
        tmp = tmp + prev_carry
        carry = carry | (tmp & msb_mask)
        out[i] = tmp - (carry << 1)
        carry = lshr(carry, base_log - 1)
    return torch.stack(out, dim=-1)


def recompose(digits: torch.Tensor, base_log: int, levels: int):
    """sum_i digit_i * q / B^i mod 2^bits, bits the width of the digits'
    type (int32: 32, int64: 64) (decomposer.rs:216-240)."""
    bits = bits_of(digits)
    acc = torch.zeros_like(digits[..., 0])
    for i in range(levels):
        acc = acc + (digits[..., i] << (bits - base_log * (i + 1)))
    return acc
