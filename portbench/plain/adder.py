"""Plain reference of the 8-bit ripple-carry adder (BASELINE.json config
5), composed from plain/boolean.py's gates in the program's gate order
(concrete_tpu_torch/boolean/circuits.py): bit 0 is a half adder,
    sum = a XOR b;  carry = a AND b,
and every later bit a full adder,
    axb = a XOR b;  sum = axb XOR carry;  carry = MUX(axb, carry, a).
Integers are little-endian bit planes [bits, B, n+1] of LWE ciphertexts;
every word is exact mod 2^32, whatever the batch.
"""

from __future__ import annotations

import torch

from . import boolean


def gate_rows(bits: int) -> int:
    """Gate calls of one add of `bits`-bit integers: a half adder's two
    and a full adder's three for each later bit (8 bits: 23)."""
    return 3 * bits - 1


def add(keys: dict, p: dict, a_bits: torch.Tensor,
        b_bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference (sum planes [bits, B, n+1], carry out [B, n+1]) of adding
    the integers of two little-endian bit-plane batches."""
    sums, carry = [], None
    for a, b in zip(a_bits, b_bits):
        axb = boolean.gate(keys, p, "xor", [a, b])
        if carry is None:
            s = axb
            carry = boolean.gate(keys, p, "and", [a, b])
        else:
            s = boolean.gate(keys, p, "xor", [axb, carry])
            carry = boolean.gate(keys, p, "mux", [axb, carry, a])
        sums.append(s)
    return torch.stack(sums), carry


def encrypt(gen, keys: dict, p: dict, values: torch.Tensor,
            bits: int) -> torch.Tensor:
    """Little-endian bit planes [bits, B, n+1] of integers [B] in
    [0, 2^bits)."""
    shifts = torch.arange(bits, device=values.device)[:, None]
    return boolean.encrypt(gen, keys, p, ((values[None, :] >> shifts) & 1)
                           .bool())


def decrypt(keys: dict, planes: torch.Tensor) -> torch.Tensor:
    """Integers [B] of little-endian bit planes [bits, B, n+1]."""
    bits = boolean.decrypt(keys, planes).to(torch.int64)
    shifts = torch.arange(planes.shape[0], device=planes.device)[:, None]
    return (bits << shifts).sum(0)
