"""Plain reference of concrete's programmable bootstrapping of small
integers on the u64 torus (lwe_bsk.rs, encoder/mod.rs, vector_lwe), on
plain/tfhe.py: a value m of an interval [min, max] with `precision` bits
and `padding` padding bits encodes as ((m - min) / delta) * 2^64 >>
padding, delta = max - min + (max - min) / (2^precision - 1); the test
polynomial samples the function at the value that each coefficient's
rotation decodes to, with the wrap-around tail negated; the PBS output is
keyswitched back to the small key.
"""

from __future__ import annotations

import math

import torch

from . import tfhe

BITS = 64


def delta(enc: dict) -> float:
    span = enc["max"] - enc["min"]
    return span + span / (2.0 ** enc["precision"] - 1.0)


def torus_from_real(y: float) -> int:
    """The closest u64 torus value of a real (its fractional part),
    halves rounded up."""
    scaled = (y - math.floor(y)) * 2.0 ** BITS
    if scaled - math.floor(scaled) >= 0.5:
        scaled += 1.0
    return min(int(math.floor(scaled)), (1 << BITS) - 1)


def encode(enc: dict, m: float) -> int:
    return torus_from_real((m - enc["min"]) / delta(enc)) >> enc["padding"]


def decode_lut_point(enc: dict, t: int) -> float:
    """The real that the input encoder, with one padding bit, decodes the
    torus value t to: padding removed, a value within the top 2^-precision
    of the torus rounded to the message lattice, then affine."""
    prec = enc["precision"]
    mod = 1 << BITS
    tmp = (t << 1) % mod
    margin_start = (((1 << (prec + 1)) - 1) << (BITS - prec)) % mod
    if tmp > margin_start:
        shift = BITS - prec
        tmp = ((((tmp >> (shift - 1)) + 1) >> 1) << shift) % mod
    return tmp / 2.0 ** BITS * delta(enc) + enc["min"]


def function(table: list[int]):
    """The real function of a table of integers: table[m] at the nearest
    integer m, read mod len(table)."""
    return lambda x: float(table[int(math.floor(x + 0.5)) % len(table)])


def test_polynomial(table: list[int], enc_in: dict, enc_out: dict,
                    n: int) -> list[int]:
    """The N coefficients of the function's test polynomial."""
    f = function(table)
    shift = BITS - (n.bit_length() - 1) - 1
    minus_start = n - (n >> (1 + enc_in["precision"]))
    out = []
    for i in range(n):
        v = encode_outside(enc_out, f(decode_lut_point(enc_in, i << shift)))
        out.append(v if i < minus_start else (-v) % (1 << BITS))
    return out


def encode_outside(enc: dict, y: float) -> int:
    return torus_from_real((y - enc["min"]) / delta(enc)) >> enc["padding"]


def as_signed(values: list[int]) -> list[int]:
    """u64 values as int64 bit patterns."""
    return [v - (1 << BITS) if v >= 1 << (BITS - 1) else v for v in values]


def pbs_keyswitch(keys: dict, p: dict, cts: torch.Tensor,
                  polys: torch.Tensor, block: int = 2048):
    """Reference (PBS outputs [B, k*N+1], keyswitched [B, n+1]) of
    ciphertexts [B, n+1], each through its own test polynomial [B, N]."""
    k = p["glwe_dimension"]
    luts = torch.zeros((cts.shape[0], k + 1, polys.shape[-1]),
                       dtype=torch.int64, device=cts.device)
    luts[:, -1, :] = polys

    def pbs(rows, lut):
        acc = tfhe.blind_rotate(keys["bsk"], lut, rows, p["pbs_base_log"],
                                p["pbs_level"], BITS)
        return tfhe.sample_extract(acc, BITS)

    big = tfhe.in_blocks(pbs, cts.shape[0], block, cts, luts)
    small = tfhe.keyswitch(keys["ksk"], big, p["ks_base_log"], p["ks_level"],
                           BITS)
    return big, small


def decode_ints(keys: dict, cts: torch.Tensor, enc: dict,
                big_key: bool) -> torch.Tensor:
    """The integers that ciphertexts decrypt to: the phase rounded to the
    encoder's lattice (1 / 2^(precision + padding) of the torus)."""
    key = keys["glwe_key"].reshape(-1) if big_key else keys["lwe_key"]
    phase = tfhe.lwe_phase(key, cts, BITS)
    shift = BITS - enc["precision"] - enc["padding"]
    step = tfhe.lshr(phase + (1 << (shift - 1)), shift, BITS)
    return step % (1 << (enc["precision"] + enc["padding"]))


def make_keys(gen, p: dict, device) -> dict:
    """Secret keys, bootstrapping key and keyswitching key from `gen`."""
    n, k, big_n = p["lwe_dimension"], p["glwe_dimension"], p["polynomial_size"]
    lwe_key = tfhe.binary_key(gen, (n,), device)
    glwe_key = tfhe.binary_key(gen, (k, big_n), device)
    bsk = tfhe.bootstrap_key(gen, lwe_key, glwe_key, p["pbs_base_log"],
                             p["pbs_level"], 2.0 ** p["rlwe_log2_std_dev"],
                             BITS)
    ksk = tfhe.keyswitch_key(gen, glwe_key.reshape(-1), lwe_key,
                             p["ks_base_log"], p["ks_level"],
                             2.0 ** p["lwe_log2_std_dev"], BITS)
    return {"lwe_key": lwe_key, "glwe_key": glwe_key, "bsk": bsk, "ksk": ksk}


def encrypt(gen, keys: dict, p: dict, enc: dict,
            values: torch.Tensor) -> torch.Tensor:
    """Fresh encryptions [..., n+1] of integers under the LWE key."""
    pts = torch.tensor(as_signed([encode(enc, float(m)) for m in range(
        1 << enc["precision"])]), dtype=torch.int64, device=values.device)
    return tfhe.lwe_encrypt(gen, keys["lwe_key"], pts[values],
                            2.0 ** p["lwe_log2_std_dev"], BITS)
