"""Programmable bootstrapping with an arbitrary real function (the
`concrete` crate's LWE::bootstrap_with_function, lwe/mod.rs:1781; the port
of examples/function_bootstrap.py).

    python -m concrete_tpu_torch.examples.function_bootstrap [--device cuda]

The answers it checks, within one step of the 5-bit output encoder
(tests/test_torch_examples.py runs it on the CPU):
    >>> np.square(XS).tolist(), 64.0 / 2 ** 5
    ([2.25, 4.0, 49.0], 2.0)
"""

from __future__ import annotations

import numpy as np

from ..highlevel import (
    LWE, LWEBSK, Encoder, LWEParams, LWESecretKey, RLWEParams, RLWESecretKey,
)
from . import Lines, expect, parse

XS = [1.5, 2.0, 7.0]


def run(device=None, lwe=LWEParams(dimension=128, log2_std_dev=-30),
        rlwe=RLWEParams(polynomial_size=512, dimension=1, log2_std_dev=-40),
        pbs=(10, 3)) -> dict:
    """x -> x^2 through the bootstrap's test polynomial, output decoded
    within one step of its 5-bit encoder: {"out", "lines"}. The default
    parameters are the reference's moderate, insecure demo sizes."""
    out = Lines()
    sk = LWESecretKey.new(lwe, secret_seed=1)
    rlwe_sk = RLWESecretKey.new(rlwe, secret_seed=2)
    bsk = LWEBSK.new(sk, rlwe_sk, base_log=pbs[0], level=pbs[1], mask_seed=3,
                     noise_seed=4, device=device)
    enc_in = Encoder.new(0.0, 8.0, nb_bit_precision=5, nb_bit_padding=1)
    enc_out = Encoder.new(0.0, 64.0, nb_bit_precision=5, nb_bit_padding=1)
    ct = LWE.encode_encrypt(sk, XS, enc_in, mask_seed=5, noise_seed=6)
    sq = ct.bootstrap_with_function(bsk, lambda x: x * x, enc_out)
    got = np.round(sq.decrypt_decode(rlwe_sk.to_lwe_secret_key()), 2)
    step = 64.0 / 2 ** 5
    out("x^2 =", got, f"(expect ~[2.25, 4.0, 49.0], within {step})")
    expect(np.all(np.abs(got - np.square(XS)) <= step), "x^2")
    return {"out": sq, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    return run(parse(argv, __doc__).device, **sizes)["lines"]


if __name__ == "__main__":
    main()
