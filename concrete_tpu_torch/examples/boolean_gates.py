"""Homomorphic boolean gates end to end (concrete-boolean's README example,
batched; the port of examples/boolean_gates.py).

    python -m concrete_tpu_torch.examples.boolean_gates [--device cuda]

The answers it checks (tests/test_torch_examples.py runs it on the CPU):
    >>> (A & B).tolist(), np.where(A & B, A, B).tolist()
    ([True, False, False, False], [True, False, True, False])
"""

from __future__ import annotations

import numpy as np

from .. import boolean
from ..params import DEFAULT_PARAMETERS
from . import Lines, expect, parse

A = np.array([True, True, False, False])
B = np.array([True, False, True, False])


def run(device=None, params=DEFAULT_PARAMETERS) -> dict:
    """AND, then a MUX chained on its output (the noise is refreshed):
    {"and", "mux": int32 ciphertexts, "lines"}."""
    out = Lines()
    # gen_keys() defaults to DEFAULT_PARAMETERS (128-bit security); seeded
    # here for reproducibility
    cks, sks = boolean.gen_keys(params, secret_seed=1, mask_seed=2,
                                noise_seed=3, device=device)
    ct_a = cks.encrypt(A, mask_seed=4, noise_seed=5)
    ct_b = cks.encrypt(B, mask_seed=6, noise_seed=7)
    ct_and = sks.and_(ct_a, ct_b)
    ct_mux = sks.mux(ct_and, ct_a, ct_b)
    got_and, got_mux = cks.decrypt(ct_and), cks.decrypt(ct_mux)
    out("a AND b      =", got_and)
    out("mux(and,a,b) =", got_mux)
    expect(np.array_equal(got_and, A & B), "AND's truth table")
    expect(np.array_equal(got_mux, np.where(A & B, A, B)), "MUX")
    return {"and": ct_and, "mux": ct_mux, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    return run(parse(argv, __doc__).device, **sizes)["lines"]


if __name__ == "__main__":
    main()
