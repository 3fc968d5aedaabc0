"""Engine-style generic checks — the specification layer's error system.

The reference gives every operation a checked entry point with a dedicated
error enum built by the engine_error! macro (specification/engines/mod.rs:
88-140): dimension mismatches and inconsistent parameters fail loudly before
any work happens. The port runs the same checks as concrete_tpu where it
runs them (the blind rotations and the general keyswitch); they read
shapes only, before any kernel is launched.

Raise hierarchy: CoreError -> {LweDimensionMismatch, GlweDimensionMismatch,
PolynomialSizeMismatch, KeyParameterMismatch}.

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.core import checks
    >>> checks.check_lwe(np.zeros((3, 11), np.uint32), 10)   # n+1 == 11: ok
    >>> try:
    ...     checks.check_lwe(np.zeros((3, 9), np.uint32), 10)
    ... except checks.LweDimensionMismatch as e:
    ...     print("caught")
    caught
"""

from __future__ import annotations


class CoreError(ValueError):
    """Base class for engine-check failures (engine_error! analog)."""


class LweDimensionMismatch(CoreError):
    pass


class GlweDimensionMismatch(CoreError):
    pass


class PolynomialSizeMismatch(CoreError):
    pass


class KeyParameterMismatch(CoreError):
    pass


class ShardingMismatch(CoreError):
    """A tensor-parallel degree that does not divide the sharded axis."""


def check_tp_divides(what: str, extent: int, tp: int, hint: str = ""):
    """Typed divisibility guard for tensor-parallel pipelines: raise a
    ShardingMismatch with an actionable message instead of an assert."""
    if extent % tp:
        raise ShardingMismatch(
            f"tp={tp} does not divide {what} ({extent}); choose tp from "
            f"{sorted(d for d in range(1, extent + 1) if extent % d == 0)}"
            + (f" — {hint}" if hint else ""))


def check_lwe(ct, dimension: int, what: str = "lwe ciphertext"):
    """ct: [..., n+1]."""
    if ct.shape[-1] != dimension + 1:
        raise LweDimensionMismatch(
            f"{what}: expected lwe_size {dimension + 1} (dimension {dimension}), "
            f"got trailing axis {ct.shape[-1]}"
        )


def check_glwe(ct, glwe_size: int, poly_size: int, what: str = "glwe ciphertext"):
    """ct: [..., k+1, N]."""
    if ct.ndim < 2 or ct.shape[-2] != glwe_size:
        raise GlweDimensionMismatch(
            f"{what}: expected glwe_size {glwe_size}, got {ct.shape[-2:]}"
        )
    if ct.shape[-1] != poly_size:
        raise PolynomialSizeMismatch(
            f"{what}: expected polynomial_size {poly_size}, got {ct.shape[-1]}"
        )


def check_keyswitch_key(ksk, input_dimension: int, level: int, output_dimension: int):
    """ksk: [n_in, l, n_out+1]."""
    want = (input_dimension, level, output_dimension + 1)
    if tuple(ksk.shape) != want:
        raise KeyParameterMismatch(
            f"keyswitch key: expected shape {want} "
            f"([n_in, level, n_out+1]), got {tuple(ksk.shape)}"
        )


def check_bsk_ntt(bsk, cfg):
    """NTT-domain bootstrap key: [n, P, l, k+1, k+1, N]."""
    want = (
        cfg.lwe_dimension,
        len(cfg.primes),
        cfg.pbs_level,
        cfg.glwe_size,
        cfg.glwe_size,
        cfg.polynomial_size,
    )
    if tuple(bsk.shape) != want:
        raise KeyParameterMismatch(
            f"NTT bootstrap key: expected {want} "
            f"([n, P, l, k+1, k+1, N]), got {tuple(bsk.shape)}"
        )


def check_bsk_mxu(rings, cfg):
    """Toeplitz rotation rings: [n, R, (k+1)*n_words, 2N]
    (bootstrap_mxu.bsk_to_mxu)."""
    from .bootstrap_mxu import MxuPlan

    plan = MxuPlan.from_config(cfg)
    want = (
        cfg.lwe_dimension,
        plan.row_blocks,
        cfg.glwe_size * plan.n_words,
        2 * cfg.polynomial_size,
    )
    if tuple(rings.shape) != want:
        raise KeyParameterMismatch(
            f"toeplitz bootstrap rings: expected {want} "
            f"([n, R, (k+1)*n_words, 2N]), got {tuple(rings.shape)}"
        )
