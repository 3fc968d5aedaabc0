"""A minimal gate-serving loop: warmup, padded batching, throughput
accounting (the port of examples/serving.py).

After warmup, every request is padded up to the smallest warmed batch tier
that fits (ServerKey._pad_size), so a server that warms its top tier once
serves any request size up to it at the shapes it has already run (on the
card the kernels are built once, at the first call). Reference workload
analog: the per-gate loop in concrete-boolean/src/server_key/mod.rs:133-166;
here a whole batch of independent gates is one call.

    python -m concrete_tpu_torch.examples.serving [--device cuda] [PRESET]

PRESET names a parameter set of concrete_tpu_torch.params (DEFAULT,
TFHE_LIB, TPU128; default DEFAULT); the gates run on the key's auto backend
on the card unless --device cpu is given.

The requests it serves (tests/test_torch_examples.py runs it on the CPU):
    >>> sum(REQUESTS), max(REQUESTS)
    (129, 64)
"""

from __future__ import annotations

import time

import numpy as np

from .. import boolean, params as presets
from . import Lines, expect, parse

REQUESTS = (3, 17, 64, 40, 5)


def run(device=None, params=presets.DEFAULT_PARAMETERS, tier: int = 64,
        requests=REQUESTS) -> dict:
    """Warm the AND and XOR tier, then serve AND requests of mixed sizes,
    every row decrypted against its truth table: {"served", "seconds",
    "lines"}."""
    out = Lines()
    cks, sks = boolean.gen_keys(params, secret_seed=1, mask_seed=2,
                                noise_seed=3, device=device)
    # 1) warm the tiers this server accepts (here: up to `tier` rows)
    for (gate, padded), secs in sks.warmup(batch_sizes=(tier,),
                                           gates=("and", "xor")).items():
        out(f"warmup {gate:>4} @ batch {padded}: {secs:.2f}s")
    # 2) serve mixed sizes: every size <= tier reuses the warmed shapes
    rng = np.random.default_rng(0)
    served = 0
    t0 = time.perf_counter()
    for i, size in enumerate(requests):
        a = rng.integers(0, 2, size).astype(bool)
        b = rng.integers(0, 2, size).astype(bool)
        ct_a = cks.encrypt(a, mask_seed=100 + i, noise_seed=200 + i)
        ct_b = cks.encrypt(b, mask_seed=300 + i, noise_seed=400 + i)
        got = cks.decrypt(sks.and_(ct_a, ct_b))      # a host pull
        expect(np.array_equal(got, a & b), f"request {i}: AND")
        served += size
    dt = time.perf_counter() - t0
    out(f"served {served} gates in {dt:.2f}s "
        f"({served / dt:.0f} gates/s incl. encrypt/decrypt round trips)")
    return {"served": served, "seconds": dt, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    args = parse(argv, __doc__, preset={"nargs": "?", "default": "DEFAULT"})
    sizes.setdefault("params", getattr(presets, f"{args.preset}_PARAMETERS"))
    return run(args.device, **sizes)["lines"]


if __name__ == "__main__":
    main()
