"""Programmable bootstrapping with an arbitrary LUT on 4-bit encrypted
integers (BASELINE config 3; the port of examples/int4_lut.py): blind
rotate + sample extract + keyswitch.

Encodes 4-bit values on the torus with one padding bit, bootstraps through
an integer table (x -> (3x + 1) mod 16), and decrypts. The bootstrap's
output rows must decode to the table under the big (GLWE) key. The
keyswitch back to LWE128_630 (base_log 2, 8 levels) leaves ~2.8% of rows
wrong by design (the NPE's noise at these parameters), so the keyswitched
rows are reported, not asserted.

    python -m concrete_tpu_torch.examples.int4_lut [--device cuda]

The table's answers (tests/test_torch_examples.py runs it on the CPU):
    >>> [int(table(x)) for x in XS]
    [1, 4, 0, 12, 14]
"""

from __future__ import annotations

import numpy as np

from ..highlevel import (
    LWE128_630, RLWE128_1024_1, LWEBSK, LWEKSK, Encoder, LWESecretKey,
    RLWESecretKey, VectorLWE,
)
from . import Lines, expect, parse

XS = np.array([0.0, 1.0, 5.0, 9.0, 15.0])


def table(x) -> float:
    return float((3 * int(round(x)) + 1) % 16)


def run(device=None, lwe=LWE128_630, rlwe=RLWE128_1024_1, pbs=(7, 3),
        ks=(2, 8)) -> dict:
    """The table through one batched PBS, then the keyswitch:
    {"pbs", "out": VectorLWEs, "lines"}."""
    out = Lines()
    sk = LWESecretKey.new(lwe, secret_seed=5)
    rlwe_sk = RLWESecretKey.new(rlwe, secret_seed=6)
    bsk = LWEBSK.new(sk, rlwe_sk, base_log=pbs[0], level=pbs[1], mask_seed=1,
                     noise_seed=2, device=device)
    ksk = LWEKSK.new(rlwe_sk.to_lwe_secret_key(), sk, base_log=ks[0],
                     level=ks[1], mask_seed=3, noise_seed=4, device=device)
    # 4-bit integers in [0, 16) with one padding bit
    enc_in = Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    enc_out = Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    v = VectorLWE.encode_encrypt(sk, XS, enc_in, mask_seed=7, noise_seed=8)
    pbs_out = v.bootstrap_all_with_function(bsk, table, enc_out)
    want = [int(table(x)) for x in XS]
    big = np.round(pbs_out.decrypt_decode(rlwe_sk.to_lwe_secret_key()))
    switched = pbs_out.keyswitch(ksk)           # back to the small key
    got = np.round(switched.decrypt_decode(sk)).astype(int)
    out("LUT(3x+1 mod 16) of", XS.astype(int).tolist(), "->",
        big.astype(int).tolist(), "(expect", want, ");",
        f"after the keyswitch {int((got == want).sum())}/{len(XS)} right")
    expect(big.astype(int).tolist() == want, "the PBS rows")
    return {"pbs": pbs_out, "out": switched, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    return run(parse(argv, __doc__).device, **sizes)["lines"]


if __name__ == "__main__":
    main()
