"""Plain reference of concrete-boolean's gates (server_key/mod.rs), on
plain/tfhe.py: each bootstrapped gate is a linear combination of its
inputs plus an offset, a PBS whose test polynomial is the constant +1/8,
and a keyswitch back to the LWE key; MUX bootstraps c + t - 1/8 and
e - c - 1/8, adds their outputs and +1/8, then keyswitches. Booleans
encrypt as +1/8 (true) and -1/8 (false) on the u32 torus.
"""

from __future__ import annotations

import torch

from . import tfhe

BITS = 32
EIGHTH = 1 << 29
QUARTER = 1 << 30
TRUE, FALSE = EIGHTH, (1 << 32) - EIGHTH

# lin(a, b) and offset of each two-input gate; the booleans it computes
GATES = {
    "and": (lambda a, b: a + b, -EIGHTH, lambda x, y: x & y),
    "nand": (lambda a, b: -a - b, EIGHTH, lambda x, y: ~(x & y)),
    "or": (lambda a, b: a + b, EIGHTH, lambda x, y: x | y),
    "nor": (lambda a, b: -a - b, -EIGHTH, lambda x, y: ~(x | y)),
    "xor": (lambda a, b: 2 * (a + b), QUARTER, lambda x, y: x ^ y),
    "xnor": (lambda a, b: -2 * (a + b), -QUARTER, lambda x, y: ~(x ^ y)),
}
OPERANDS = {**{g: 2 for g in GATES}, "mux": 3}


def truth(gate: str, bits: list[torch.Tensor]) -> torch.Tensor:
    """The boolean each row of the gate should give."""
    if gate == "mux":
        c, t, e = bits
        return torch.where(c, t, e)
    return GATES[gate][2](*bits)


def encode(bits: torch.Tensor) -> torch.Tensor:
    return torch.where(bits, TRUE, FALSE).to(torch.int64)


def linear_rows(gate: str, cts: list[torch.Tensor]) -> torch.Tensor:
    """The ciphertexts the gate's blind rotation takes: [B, n+1] (two
    stacked on a new first axis for MUX)."""
    wrap = (lambda x: tfhe.wrap(x, BITS))
    if gate == "mux":
        c, t, e = cts
        lin = torch.stack([wrap(c + t), wrap(e - c)])
        lin[..., -1] = wrap(lin[..., -1] - EIGHTH)
        return lin
    lin_fn, offset, _ = GATES[gate]
    lin = wrap(lin_fn(*cts))
    lin[:, -1] = wrap(lin[:, -1] + offset)
    return lin


def gate(keys: dict, p: dict, gate_name: str, cts: list[torch.Tensor],
         block: int = 4096) -> torch.Tensor:
    """Reference outputs [B, n+1] of one gate over rows of [B, n+1]
    ciphertexts (a list with one tensor per operand)."""
    lin = linear_rows(gate_name, cts)
    flat = lin.reshape(-1, lin.shape[-1])
    k, n = p["glwe_dimension"], p["polynomial_size"]
    luts = torch.zeros((flat.shape[0], k + 1, n), dtype=torch.int64,
                       device=flat.device)
    luts[:, -1, :] = EIGHTH

    def pbs(rows, lut):
        acc = tfhe.blind_rotate(keys["bsk"], lut, rows, p["pbs_base_log"],
                                p["pbs_level"], BITS)
        return tfhe.sample_extract(acc, BITS)

    big = tfhe.in_blocks(pbs, flat.shape[0], block, flat, luts)
    if gate_name == "mux":
        big = big.reshape(2, -1, big.shape[-1])
        big = tfhe.wrap(big[0] + big[1], BITS)
        big[:, -1] = tfhe.wrap(big[:, -1] + EIGHTH, BITS)
    return tfhe.keyswitch(keys["ksk"], big, p["ks_base_log"], p["ks_level"],
                          BITS)


def decrypt(keys: dict, cts: torch.Tensor) -> torch.Tensor:
    """The booleans of [B, n+1] ciphertexts under the LWE key."""
    return tfhe.lwe_phase(keys["lwe_key"], cts, BITS) < (1 << 31)


def make_keys(gen, p: dict, device) -> dict:
    """Secret keys, bootstrapping key and keyswitching key from `gen`."""
    n, k, big_n = p["lwe_dimension"], p["glwe_dimension"], p["polynomial_size"]
    lwe_key = tfhe.binary_key(gen, (n,), device)
    glwe_key = tfhe.binary_key(gen, (k, big_n), device)
    bsk = tfhe.bootstrap_key(gen, lwe_key, glwe_key, p["pbs_base_log"],
                             p["pbs_level"], p["glwe_modular_std_dev"], BITS)
    ksk = tfhe.keyswitch_key(gen, glwe_key.reshape(-1), lwe_key,
                             p["ks_base_log"], p["ks_level"],
                             p["lwe_modular_std_dev"], BITS)
    return {"lwe_key": lwe_key, "glwe_key": glwe_key, "bsk": bsk, "ksk": ksk}


def encrypt(gen, keys: dict, p: dict, bits: torch.Tensor) -> torch.Tensor:
    """Fresh encryptions [..., n+1] of booleans under the LWE key."""
    return tfhe.lwe_encrypt(gen, keys["lwe_key"], encode(bits),
                            p["lwe_modular_std_dev"], BITS)
