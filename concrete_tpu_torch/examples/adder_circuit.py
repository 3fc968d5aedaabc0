"""8-bit homomorphic ripple-carry adder over an encrypted batch (BASELINE
config 5; the port of examples/adder_circuit.py).

    python -m concrete_tpu_torch.examples.adder_circuit [--device cuda]

The answers it checks (tests/test_torch_examples.py runs it on the CPU):
    >>> ((A + B) % 256).tolist(), (A + B >= 256).tolist()
    ([42, 255, 132], [False, False, False])
"""

from __future__ import annotations

import numpy as np

from .. import boolean
from ..boolean import circuits
from ..params import DEFAULT_PARAMETERS
from . import Lines, expect, parse

A = np.array([17, 200, 33], dtype=np.uint64)
B = np.array([25, 55, 99], dtype=np.uint64)


def run(device=None, params=DEFAULT_PARAMETERS, nbits: int = 8) -> dict:
    """a + b on `nbits`-bit encrypted integers: {"sum": [nbits, 3, n+1],
    "carry": [3, n+1] int32 ciphertexts, "lines"}."""
    out = Lines()
    cks, sks = boolean.gen_keys(params, secret_seed=1, mask_seed=2,
                                noise_seed=3, device=device)
    a_bits = circuits.encrypt_uint(cks, A, nbits, mask_seed=4, noise_seed=5)
    b_bits = circuits.encrypt_uint(cks, B, nbits, mask_seed=6, noise_seed=7)
    sum_bits, carry = circuits.ripple_carry_adder(sks, a_bits, b_bits)
    total = circuits.decrypt_uint(cks, sum_bits)
    want = (A + B) % (1 << nbits)
    out("a + b =", total, "(expect", want, "), carry", cks.decrypt(carry))
    expect(np.array_equal(total, want), "the sums")
    expect(np.array_equal(cks.decrypt(carry), A + B >= (1 << nbits)),
           "the carry")
    return {"sum": sum_bits, "carry": carry, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    return run(parse(argv, __doc__).device, **sizes)["lines"]


if __name__ == "__main__":
    main()
