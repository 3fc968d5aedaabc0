"""Encrypted boolean circuits built from gates: the workload layer.

The canonical circuit is the 8-bit ripple-carry adder (BASELINE.md config
5): per bit position a full adder of
    axb = a XOR b;  sum = axb XOR c;  c' = MUX(axb, c, a)
costs 2 bootstrapped gates + 1 MUX (2 PBS). Every gate is batched: adding
two vectors of m integers costs the same number of sequential gate calls as
adding one, m riding the batch axis. Ciphertexts are int32 tensors on the
server key's device; encrypt_uint and decrypt_uint run on the host.

Each adder call is the span ``circuit.adder`` (ops/graphs.py); its gate
calls are the gates' own spans inside it (an 8-bit add: ``gate.xor`` 15,
``gate.and`` 1, ``gate.mux`` 7). Between its first and last gate call no
call synchronises with the device: each call's inputs are earlier calls'
outputs on the device. Only a launch queue full of earlier calls' work holds
a graph launch back.

Example (2-bit adds on tiny insecure parameters, on the CPU):
    >>> from concrete_tpu_torch import boolean
    >>> from concrete_tpu_torch.params import BooleanParameters
    >>> from concrete_tpu_torch.dispersion import StandardDev
    >>> tiny = BooleanParameters(4, 1, 64, StandardDev(2.0 ** -20),
    ...     StandardDev(2.0 ** -25), 7, 3, 2, 5)
    >>> cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2,
    ...                             noise_seed=3, device="cpu")
    >>> a = encrypt_uint(cks, [1, 2], 2, mask_seed=4, noise_seed=5)
    >>> b = encrypt_uint(cks, [2, 3], 2, mask_seed=6, noise_seed=7)
    >>> bits, carry = ripple_carry_adder(sks, a, b)
    >>> decrypt_uint(cks, bits).tolist(), cks.decrypt(carry).tolist()
    ([3, 1], [False, True])
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import graphs
from ..torus import as_torus, to_numpy
from .server_key import ServerKey


def ripple_carry_adder(sks: ServerKey, a_bits, b_bits, carry_in=None):
    """Add two little-endian encrypted bit arrays [nbits, ..., n+1] (bit 0
    the least significant; np.uint32 or int32 tensors) -> (sum bits
    [nbits, ..., n+1], carry out [..., n+1]), int32 tensors on the key's
    device."""
    with graphs.span("circuit.adder"):
        a_bits = as_torus(a_bits, sks.device)
        b_bits = as_torus(b_bits, sks.device)
        carry = None if carry_in is None else as_torus(carry_in, sks.device)
        sums = []
        for a, b in zip(a_bits, b_bits):
            axb = sks.xor(a, b)
            if carry is None:
                s = axb
                carry = sks.and_(a, b)
            else:
                s = sks.xor(axb, carry)
                carry = sks.mux(axb, carry, a)
            sums.append(s)
        return torch.stack(sums), carry


def encrypt_uint(cks, values, nbits: int, *, mask_seed=None,
                 noise_seed=None) -> np.ndarray:
    """Encrypt unsigned integers as little-endian bit vectors
    -> [nbits, batch, n+1] np.uint32.

    Seeds are per call: bit plane i takes the sub-seeds (seed << 16) + i
    (one seed for every plane would give every plane the same mask and
    noise, and ct_i - ct_j would show whether the bits differ)."""
    values = np.atleast_1d(np.asarray(values, dtype=np.uint64))
    bits = ((values[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None])
            & 1).astype(bool)
    planes = []
    for i in range(nbits):
        seeds = {}
        if mask_seed is not None:
            seeds["mask_seed"] = (int(mask_seed) << 16) + i
        if noise_seed is not None:
            seeds["noise_seed"] = (int(noise_seed) << 16) + i
        planes.append(cks.encrypt(bits[i], **seeds))
    return np.stack(planes)


def decrypt_uint(cks, bit_cts) -> np.ndarray:
    """Decrypt [nbits, batch, n+1] little-endian bit vectors (np.uint32 or
    int32 tensors) to np.uint64 integers."""
    bit_cts = to_numpy(bit_cts)
    vals = np.zeros(bit_cts.shape[1:-1], dtype=np.uint64)
    for i in range(bit_cts.shape[0]):
        vals |= cks.decrypt(bit_cts[i]).astype(np.uint64) << np.uint64(i)
    return vals
