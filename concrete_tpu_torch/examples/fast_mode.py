"""Reduced-precision fast mode: the same keys, fewer PBS decomposition
levels (the port of examples/fast_mode.py).

`ServerKey.with_fast_mode()` evaluates TFHE_LIB_PARAMETERS with the two
most significant PBS decomposition levels of the same bootstrapping key.
Chained-gate error probability ~2^-24 (design.gate_error_log2), the grade
of the reference's own DEFAULT_PARAMETERS design point.

    python -m concrete_tpu_torch.examples.fast_mode [--device cuda]

The evaluation view (tests/test_torch_examples.py runs it on the CPU):
    >>> from ..core.bootstrap import ServerConfig
    >>> ServerConfig.from_boolean_parameters(
    ...     TFHE_LIB_PARAMETERS).with_fast_mode(limb_drop=0, levels=2).pbs_level
    2
"""

from __future__ import annotations

import numpy as np

from .. import boolean
from ..params import TFHE_LIB_PARAMETERS
from . import Lines, expect, parse


def run(device=None, params=TFHE_LIB_PARAMETERS, rows: int = 256) -> dict:
    """(a AND b) XOR (a OR b) on a fast-mode twin of the key (fast-mode
    outputs feed fast-mode inputs: the chained noise budget): {"out",
    "lines"}."""
    out = Lines()
    cks, sks = boolean.gen_keys(params, secret_seed=1, mask_seed=2,
                                noise_seed=3, device=device)
    fast = sks.with_fast_mode()          # levels=2 on the same key material
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, rows).astype(bool)
    b = rng.integers(0, 2, rows).astype(bool)
    cta = cks.encrypt(a, mask_seed=4, noise_seed=5)
    ctb = cks.encrypt(b, mask_seed=6, noise_seed=7)
    ct = fast.xor(fast.and_(cta, ctb), fast.or_(cta, ctb))
    got = cks.decrypt(ct)
    want = (a & b) ^ (a | b)
    out(f"chained fast-mode gates: {int((got == want).sum())}/{rows} correct")
    expect(bool((got == want).all()), "a fast-mode gate row")
    return {"out": ct, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    return run(parse(argv, __doc__).device, **sizes)["lines"]


if __name__ == "__main__":
    main()
