"""TPU128: the co-designed boolean parameter set, end to end (the port of
examples/tpu128_codesign.py).

The round trip from hardware model to running gates:
1. the co-design sweep (design.search) on the H100's cost model
   (design.GpuCostModel): its top candidate is logged beside TPU128's
   rank. TPU128 (k=4, N=256, base_log 7, level 2) was the top candidate of
   a TPU's cost model; the H100 model may rank another shape first, so the
   reference's pin on it is not carried over;
2. TPU128's security pins and chained worst-case gate error;
3. keys and encrypted AND / XOR gates at the headline batch;
4. the measured output noise against the NPE's prediction.

    python -m concrete_tpu_torch.examples.tpu128_codesign [--device cuda]

The shape the reference pins:
    >>> TPU128_SHAPE == (TPU128_PARAMETERS.glwe_dimension,
    ...     TPU128_PARAMETERS.polynomial_size, TPU128_PARAMETERS.pbs_base_log,
    ...     TPU128_PARAMETERS.pbs_level)
    True
"""

from __future__ import annotations

import math
import time

import numpy as np

from .. import boolean, design
from ..params import TPU128_PARAMETERS
from ..torus import to_numpy
from . import Lines, expect, parse

TPU128_SHAPE = (4, 256, 7, 2)


def run(device=None, params=TPU128_PARAMETERS, batch: int = 2048) -> dict:
    """The four steps: {"top": the sweep's first candidate, "tpu128_rank",
    "lines"}."""
    out = Lines()
    p = params
    out("== 1. the operating point the sweep selects ==")
    cands = design.search(n_range=range(630, 651, 10),
                          shapes=((4, 256), (2, 512), (1, 1024)))
    top = cands[0].params
    out(f"   top candidate on the H100 model: n={top.lwe_dimension} "
        f"k={top.glwe_dimension} N={top.polynomial_size} "
        f"bl={top.pbs_base_log} l={top.pbs_level} "
        f"(modeled {cands[0].gates_per_s:.0f} gates/s)")
    shapes = [(c.params.glwe_dimension, c.params.polynomial_size,
               c.params.pbs_base_log, c.params.pbs_level) for c in cands]
    rank = shapes.index(TPU128_SHAPE) + 1 if TPU128_SHAPE in shapes else None
    out(f"   TPU128's shape (k=4 N=256 bl=7 l=2): rank {rank} of "
        f"{len(cands)}")

    out("== 2. security + error grade ==")
    out(f"   sigma_lwe  = 2^{math.log2(p.lwe_modular_std_dev.std_dev):.0f} "
        f"(curve minimum 2^{design.min_log2_std(p.lwe_dimension):.0f})")
    kn = p.glwe_dimension * p.polynomial_size
    out(f"   sigma_glwe = 2^{math.log2(p.glwe_modular_std_dev.std_dev):.0f} "
        f"(curve minimum 2^{design.min_log2_std(kn):.0f} at kN={kn})")
    out(f"   worst-chain gate error 2^{design.gate_error_log2(p):.1f} "
        f"(fresh-input 2^{design.gate_error_log2(p, worst_chain=False):.1f})")

    out("== 3. encrypted gates ==")
    cks, sks = boolean.gen_keys(p, secret_seed=1, mask_seed=2, noise_seed=3,
                                device=device)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, batch).astype(bool)
    b = rng.integers(0, 2, batch).astype(bool)
    ca = cks.encrypt(a, mask_seed=4, noise_seed=5)
    cb = cks.encrypt(b, mask_seed=6, noise_seed=7)
    expect(np.array_equal(cks.decrypt(sks.and_(ca, cb)), a & b), "AND")
    to_numpy(sks.xor(ca, cb))                # the XOR's first call
    t0 = time.perf_counter()
    ct = to_numpy(sks.xor(ca, cb))
    dt = time.perf_counter() - t0
    expect(np.array_equal(cks.decrypt(ct), a ^ b), "XOR")
    out(f"   {batch} XOR gates in {dt * 1e3:.0f} ms -> {batch / dt:.0f} "
        "gates/s (incl. host pull)")

    out("== 4. noise vs the NPE ==")
    phase = cks.lwe_secret_key.decrypt(ct).astype(np.int64)
    enc = np.where(a ^ b, 1 << 29, 7 << 29).astype(np.int64)
    err = ((phase - enc + (1 << 31)) % (1 << 32)) - (1 << 31)
    v = design._fresh_gate_variance(p)
    out(f"   measured 2^{math.log2(err.std() / 2 ** 32):.2f} vs "
        f"NPE 2^{math.log2(math.sqrt(v.get_variance())):.2f}")
    return {"top": top, "tpu128_rank": rank, "lines": out}


def main(argv=None, **sizes) -> list[str]:
    return run(parse(argv, __doc__).device, **sizes)["lines"]


if __name__ == "__main__":
    main()
