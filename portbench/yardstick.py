"""The benchmark's frozen yardstick: the H100's published peaks and the work
counts of the two algorithms the cells run, copied from
concrete_tpu_torch/profiling.py (and the keyswitch's int8 product from
concrete_tpu_torch/design.py) so that a change to the program cannot move
them. tests/test_portbench_yardstick.py holds them equal to the program's
own at the cells' shapes.

A roofline share here is the least time the card could take for the work
of a call, counted from the call's shapes, over the device-busy time of
every device operation of that call: the larger of the 32-bit integer
instructions at the integer pipes' rate, the int8 operations at the tensor
rate and the fewest HBM bytes at the HBM rate (Roofline.bound_seconds).
"""

from __future__ import annotations

import dataclasses

# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# HBM bytes/s and the int8 tensor rate
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# the integer pipes of compute capability 9.0: lanes per clock and SM (64
# for the multiply pipe and for the ALU pipe, 128 of issue over both) x 132
# SMs x the 1,980 MHz boost clock
SM_CLOCKS_PER_S = 132 * 1.98e9
PIPE_LANES, ISSUE_LANES = 64, 128

# the fewest instructions of one operation, as (multiplies, adds,
# ALU-only): a Montgomery product; a modular add or subtract; two MAC terms
# sharing one lazy reduction; one Garner step of a coefficient
MONT, MODADD, MAC_PAIR, GARNER = (3, 1, 1), (0, 2, 1), (4, 2, 0), (4, 6, 5)
# K4's fewest instructions a coefficient: the gather, a level on the 32-bit
# state, the last level, a level on the 64-bit state, a 7-bit sub-digit,
# the byte packing
GATHER64, LEVEL32, LAST32, LEVEL64 = (0, 6, 4), (1, 2, 4), (1, 1, 3), (1, 3, 5)
SUBDIGIT, PACK = (1, 1, 1), (0, 0, 0.75)


def int_ops_s(mul: float, add: float, alu: float) -> float:
    """Least seconds for these 32-bit integer instructions: each pipe at
    its rate, both within the issue rate."""
    return max(mul / PIPE_LANES, alu / PIPE_LANES,
               (mul + add + alu) / ISSUE_LANES) / SM_CLOCKS_PER_S


def _weighted(count: dict) -> tuple:
    return tuple(sum(c * op[i] for op, c in count.items()) for i in range(3))


def ntt_cmux_work(n: int, glwe_size: int, level: int, b: int,
                  primes: int = 2) -> tuple:
    """Instructions (multiplies, adds, ALU-only) of one NTT-domain CMux step
    at batch b: per row, l*(k+1) forward NTTs per prime, the MAC against
    k+1 key spectra, (k+1) inverse NTTs per prime and the Garner
    recombination (profiling.ntt_cmux_work)."""
    butterflies = n // 2 * (n.bit_length() - 1)
    fwd, inv = b * glwe_size * level * primes, b * glwe_size * primes
    macs = fwd * glwe_size * n
    garner = b * glwe_size * n * (primes - 1)
    return _weighted({MONT: (fwd + inv) * (n + butterflies) + inv * n,
                      MODADD: (fwd + inv) * 2 * butterflies,
                      MAC_PAIR: macs // 2, GARNER: garner})


def rotdig64_work(base_log: int, level: int, n_sub: int) -> tuple:
    """K4's fewest instructions a coefficient (profiling.rotdig64_work)."""
    prefix = base_log * level
    wide = max(0, -(-(prefix - 32) // base_log))
    return _weighted({GATHER64: 1, (0, 0, 2 if prefix > 32 else 1): 1,
                      LEVEL64: wide, LEVEL32: level - 1 - wide, LAST32: 1,
                      SUBDIGIT: level * (n_sub - 1), PACK: level * n_sub})


def n_sub(base_log: int) -> int:
    """int8 sub-digits of a gadget digit on the toeplitz path."""
    return 1 if base_log <= 7 else (base_log - 8) // 7 + 2


def mxu_gemm_ops(p: dict, b: int, limb_drop: int = 0) -> int:
    """int8 operations (2 a MAC) of the CMux products of one toeplitz blind
    rotation at batch b: per step [b, R*N] x [R*N, (k+1)*limbs*N],
    R = l*(k+1)*n_sub (profiling.mxu_gemm_ops)."""
    n, ks1 = p["polynomial_size"], p["glwe_dimension"] + 1
    rows = p["pbs_level"] * ks1 * n_sub(p["pbs_base_log"])
    limbs = p["bits"] // 8 - limb_drop
    return 2 * p["lwe_dimension"] * b * rows * n * ks1 * limbs * n


def keyswitch_int8_ops(p: dict, b: int) -> float:
    """int8 operations of the keyswitch product: digits [b, kN*l_ks*n_sub]
    x the key's byte limbs [.., (n+1)*bits/8] (design._ks_int8_ops)."""
    subs = -(-p["ks_base_log"] // 7)
    rows = (p["glwe_dimension"] * p["polynomial_size"] * p["ks_level"]
            * subs)
    return 2.0 * b * rows * (p["lwe_dimension"] + 1) * (p["bits"] // 8)


def key_bytes(p: dict) -> int:
    """Bytes of the standard bootstrapping and keyswitching keys."""
    n, k, big_n = p["lwe_dimension"], p["glwe_dimension"], p["polynomial_size"]
    word = p["bits"] // 8
    bsk = n * p["pbs_level"] * (k + 1) ** 2 * big_n
    ksk = k * big_n * p["ks_level"] * (n + 1)
    return (bsk + ksk) * word


@dataclasses.dataclass
class Work:
    """The work of one call: integer instructions, int8 operations, bytes."""

    int_instr: tuple = (0.0, 0.0, 0.0)
    int8_ops: float = 0.0
    hbm_bytes: float = 0.0

    def bound_seconds(self) -> float:
        """The least time on the H100 (profiling.Roofline.bound_seconds)."""
        return max(int_ops_s(*self.int_instr),
                   self.int8_ops / INT8_TENSOR_OPS_PER_S,
                   self.hbm_bytes / HBM_BYTES_PER_S)


def ntt_gate_work(p: dict, rows: int, pbs_rows: int, operands: int) -> Work:
    """A gate call on the ntt backend: n CMux steps at the rows the blind
    rotation needs (two a MUX row), the keyswitch's int8 product, the
    standard keys, the input ciphertexts and the output once."""
    ct = (p["lwe_dimension"] + 1) * p["bits"] // 8
    step = ntt_cmux_work(p["polynomial_size"], p["glwe_dimension"] + 1,
                         p["pbs_level"], pbs_rows)
    return Work(tuple(p["lwe_dimension"] * x for x in step),
                keyswitch_int8_ops(p, rows),
                key_bytes(p) + rows * ct * (operands + 1))


def mxu_pbs_work(p: dict, rows: int) -> Work:
    """A u64 PBS + keyswitch call on the toeplitz (mxu) backend: the CMux
    products, K4's digits of every step, the keyswitch's int8 product, the
    standard keys, the input, the PBS output and the keyswitched output
    once."""
    ks1, n = p["glwe_dimension"] + 1, p["polynomial_size"]
    big = p["glwe_dimension"] * n + 1
    word = p["bits"] // 8
    per_coef = rotdig64_work(p["pbs_base_log"], p["pbs_level"],
                             n_sub(p["pbs_base_log"]))
    coefs = p["lwe_dimension"] * rows * ks1 * n
    return Work(tuple(coefs * x for x in per_coef),
                mxu_gemm_ops(p, rows) + keyswitch_int8_ops(p, rows),
                key_bytes(p) + rows * word * (2 * (p["lwe_dimension"] + 1)
                                              + big))
