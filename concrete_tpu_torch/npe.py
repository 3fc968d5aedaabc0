"""Noise-propagation estimator: analytic variance formulas per operation.

Re-implements `concrete-npe` (concrete-npe/src/operators.rs, formulas from
eprint 2021/729): given operation parameters and input dispersions, predict
the output noise Variance. Used at runtime by the high-level encoder API and
as the oracle of the statistical conformance tests (SURVEY.md §4).

All formulas work on *modular* variances (scaled by q^2 = 2^(2 bits)) exactly
as the reference does, so values are comparable digit for digit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .dispersion import DispersionParameter, Variance


def _sq(x: float) -> float:
    return x * x


# ---------------------------------------------------------------------------
# key dispersion (concrete-npe/src/key_dispersion.rs)
# ---------------------------------------------------------------------------

GAUSSIAN_MODULAR_STDEV = 3.2


@dataclass(frozen=True)
class KeyDispersion:
    """Per-key-kind moments of key coefficients (key_dispersion.rs:16)."""

    kind: str

    def variance_key_coefficient(self, bits: int) -> float:
        """Modular variance of one key coefficient."""
        if self.kind == "binary":
            return 1.0 / 4.0
        if self.kind == "ternary":
            return 2.0 / 3.0
        if self.kind == "gaussian":
            return _sq(GAUSSIAN_MODULAR_STDEV)
        if self.kind == "zero":
            return 0.0
        raise ValueError(self.kind)

    def expectation_key_coefficient(self) -> float:
        if self.kind == "binary":
            return 1.0 / 2.0
        if self.kind in ("ternary", "gaussian", "zero"):
            return 0.0
        raise ValueError(self.kind)

    def variance_key_coefficient_squared(self, bits: int) -> float:
        if self.kind == "binary":
            return 1.0 / 4.0
        if self.kind == "ternary":
            return 2.0 / 9.0
        if self.kind == "gaussian":
            return 2.0 * _sq(_sq(GAUSSIAN_MODULAR_STDEV))
        if self.kind == "zero":
            return 0.0
        raise ValueError(self.kind)

    def expectation_key_coefficient_squared(self, bits: int) -> float:
        if self.kind == "binary":
            return 1.0 / 2.0
        if self.kind == "ternary":
            return 2.0 / 3.0
        if self.kind == "gaussian":
            return _sq(GAUSSIAN_MODULAR_STDEV)
        if self.kind == "zero":
            return 0.0
        raise ValueError(self.kind)

    def variance_odd_coefficient_in_polynomial_key_squared(
        self, poly_size: int, bits: int
    ) -> float:
        if poly_size == 1:
            return 0.0
        if self.kind == "binary":
            return 3.0 * poly_size / 8.0
        if self.kind == "ternary":
            return 8.0 * poly_size / 9.0
        if self.kind == "gaussian":
            return 2.0 * poly_size * _sq(_sq(GAUSSIAN_MODULAR_STDEV))
        if self.kind == "zero":
            return 0.0
        raise ValueError(self.kind)

    def variance_even_coefficient_in_polynomial_key_squared(
        self, poly_size: int, bits: int
    ) -> float:
        if poly_size == 1:
            return 2.0 * self.variance_key_coefficient_squared(bits)
        if self.kind == "binary":
            return (3.0 * poly_size - 2.0) / 8.0
        if self.kind == "ternary":
            return 4.0 * (2.0 * poly_size - 3.0) / 9.0
        if self.kind == "gaussian":
            return 2.0 * poly_size * _sq(_sq(GAUSSIAN_MODULAR_STDEV))
        if self.kind == "zero":
            return 0.0
        raise ValueError(self.kind)

    def squared_expectation_mean_in_polynomial_key_squared(
        self, poly_size: int, bits: int
    ) -> float:
        if poly_size == 1:
            return _sq(self.expectation_key_coefficient_squared(bits))
        if self.kind == "binary":
            return (_sq(float(poly_size)) + 2.0) / 48.0
        return 0.0

    def variance_coefficient_in_polynomial_key_times_key(
        self, poly_size: int, bits: int
    ) -> float:
        if self.kind == "binary":
            return 3.0 * poly_size / 16.0
        if self.kind == "ternary":
            return 4.0 * poly_size / 9.0
        if self.kind == "gaussian":
            return poly_size * _sq(_sq(GAUSSIAN_MODULAR_STDEV))
        if self.kind == "zero":
            return 0.0
        raise ValueError(self.kind)

    def square_expectation_mean_in_polynomial_key_times_key(self, poly_size: int) -> float:
        if self.kind == "binary":
            return (_sq(float(poly_size)) + 2.0) / 48.0
        return 0.0


BINARY_KEY = KeyDispersion("binary")
TERNARY_KEY = KeyDispersion("ternary")
GAUSSIAN_KEY = KeyDispersion("gaussian")
ZERO_KEY = KeyDispersion("zero")

_KINDS = {
    "binary": BINARY_KEY,
    "ternary": TERNARY_KEY,
    "gaussian": GAUSSIAN_KEY,
    "zero": ZERO_KEY,
}


def key_dispersion(kind: str) -> KeyDispersion:
    return _KINDS[kind]


# ---------------------------------------------------------------------------
# operator formulas (operators.rs)
# ---------------------------------------------------------------------------


def _doctest_example():
    """
    >>> from concrete_tpu_torch.npe import estimate_addition_noise, estimate_number_of_noise_bits
    >>> from concrete_tpu_torch.dispersion import Variance
    >>> v = estimate_addition_noise(Variance(1e-10), Variance(1e-10), 32)
    >>> round(v.get_variance() / 1e-10, 3)
    2.0
    >>> estimate_number_of_noise_bits(Variance(2.0 ** -40), 32)
    14
    """


def estimate_addition_noise(d1: DispersionParameter, d2: DispersionParameter, bits: int) -> Variance:
    """Var(ct1 + ct2) (operators.rs:24)."""
    return Variance.from_modular_variance(
        d1.get_modular_variance(bits) + d2.get_modular_variance(bits), bits
    )


def estimate_several_additions_noise(dispersions, bits: int) -> Variance:
    return Variance.from_modular_variance(
        sum(d.get_modular_variance(bits) for d in dispersions), bits
    )


def estimate_integer_plaintext_multiplication_noise(d: DispersionParameter, n: int) -> Variance:
    """Var(n * ct) for a signed integer cleartext n (operators.rs:75)."""
    return Variance(d.get_variance() * float(n) * float(n))


def estimate_weighted_sum_noise(dispersions, weights) -> Variance:
    """Var(sum w_i ct_i) (operators.rs:96)."""
    return Variance(
        sum(
            estimate_integer_plaintext_multiplication_noise(d, w).get_variance()
            for d, w in zip(dispersions, weights)
        )
    )


def estimate_polynomial_plaintext_multiplication_noise(d, scalar_polynomial) -> Variance:
    """Var(ct * scalar poly) (operators.rs:124)."""
    return estimate_weighted_sum_noise([d] * len(scalar_polynomial), scalar_polynomial)


def estimate_modulus_switching_noise_with_binary_key(
    lwe_dimension: int, nb_msb: int, var_in: DispersionParameter, bits: int
) -> Variance:
    """Noise of rounding to nb_msb bits (operators.rs:410)."""
    w = float(1 << nb_msb)
    n = float(lwe_dimension)
    q2 = 2.0 ** (2 * bits)
    return Variance.from_modular_variance(
        var_in.get_modular_variance(bits)
        + 1.0 / 12.0 * q2 / _sq(w)
        - 1.0 / 12.0
        + n / 24.0 * q2 / _sq(w)
        + n / 48.0,
        bits,
    )


def estimate_keyswitch_noise_with_constant_terms(
    lwe_dimension: int,
    dispersion_lwe: DispersionParameter,
    dispersion_ksk: DispersionParameter,
    base_log: int,
    level: int,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """LWE->GLWE keyswitch, constant terms (operators.rs:453)."""
    n = float(lwe_dimension)
    base = float(1 << base_log)
    q2 = 2.0 ** (2 * bits)
    r1 = dispersion_lwe.get_modular_variance(bits)
    r2 = n * (q2 / (12.0 * base ** (2 * level)) - 1.0 / 12.0) * (
        key.variance_key_coefficient(bits) + _sq(key.expectation_key_coefficient())
    )
    r3 = n / 4.0 * key.variance_key_coefficient(bits)
    r4 = n * level * dispersion_ksk.get_modular_variance(bits) * (_sq(base) + 2.0) / 12.0
    return Variance.from_modular_variance(r1 + r2 + r3 + r4, bits)


def estimate_keyswitch_noise_with_non_constant_terms(
    lwe_dimension: int,
    dispersion_ksk: DispersionParameter,
    base_log: int,
    level: int,
    bits: int,
) -> Variance:
    """LWE->GLWE keyswitch, non-constant terms (operators.rs:511)."""
    n = float(lwe_dimension)
    base = float(1 << base_log)
    return Variance.from_modular_variance(
        n * level * dispersion_ksk.get_modular_variance(bits) * (_sq(base) + 2.0) / 12.0,
        bits,
    )


def estimate_msb_noise_rlwe(poly_size: int, bits: int, key: KeyDispersion = BINARY_KEY) -> Variance:
    """RLWE MSB bound (operators.rs:542)."""
    q2 = 2.0 ** (2 * bits)
    n = float(poly_size)
    return Variance.from_modular_variance(
        1.0
        / q2
        * (
            (q2 - 1.0)
            / 12.0
            * (1.0 + n * key.variance_key_coefficient(bits) + n * _sq(key.expectation_key_coefficient()))
            + n / 4.0 * key.variance_key_coefficient(bits)
        ),
        bits,
    )


def estimate_external_product_noise_with_binary_ggsw(
    poly_size: int,
    glwe_dimension: int,
    var_glwe: DispersionParameter,
    var_ggsw: DispersionParameter,
    base_log: int,
    level: int,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """External product with a fresh *uniform-binary-message* GGSW
    (operators.rs:586): the message-dependent terms are averaged over
    m ~ Bernoulli(1/2) — the bootstrap-key regime (E[m] = E[m^2] = 1/2,
    Var(m) = 1/4). For a DETERMINISTIC message (e.g. the GGSW(1) the
    conformance fixtures drive) use
    estimate_external_product_noise_with_ggsw_message, which is 2x larger
    in the decomposition-rounding term — hardware/CPU-validated to a few
    percent at kN in [128, 1024] (docs/performance.md "noise model").

    NOTE: with our exact NTT the FFT rounding contribution of the reference's
    f64 path is absent; this bound is therefore conservative for us.
    """
    return estimate_external_product_noise_with_ggsw_message(
        poly_size, glwe_dimension, var_glwe, var_ggsw, base_log, level,
        bits, key, msg_mean=0.5, msg_second_moment=0.5)


def estimate_external_product_noise_with_ggsw_message(
    poly_size: int,
    glwe_dimension: int,
    var_glwe: DispersionParameter,
    var_ggsw: DispersionParameter,
    base_log: int,
    level: int,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
    *,
    msg_mean: float = 1.0,
    msg_second_moment: float = 1.0,
) -> Variance:
    """External product noise with explicit GGSW-message moments.

    extprod(GGSW(m), c) = m*round(c) + e: the decomposition-rounding
    residual u (body + mask-convolved-with-key) enters the phase as m*u, so
    its variance scales with E[m^2]; the key-correction terms scale the same
    way; the constant bias term scales with Var(m). The reference's binary
    formula is this one at msg_mean = msg_second_moment = 1/2 (its /24 and
    /8 denominators are /12 and /4 times E[m^2]). Validated by measurement:
    a deterministic GGSW(1) external product at (k=4, N=256, bl=7, l=2)
    measures 4.07e-4 phase std vs 4.07e-4 predicted here (the
    binary-averaged formula predicts 2.88e-4 — the 1.4x gap the round-3
    fixture caught).
    """
    l = float(level)
    k = float(glwe_dimension)
    n = float(poly_size)
    b = float(1 << base_log)
    b2l = b ** (2.0 * l)
    q2 = 2.0 ** (2 * bits)
    m2 = float(msg_second_moment)
    mvar = max(float(msg_second_moment) - _sq(float(msg_mean)), 0.0)
    r1 = l * (k + 1.0) * n * var_ggsw.get_modular_variance(bits) * (_sq(b) + 2.0) / 12.0
    r2 = m2 * var_glwe.get_modular_variance(bits)  # operand noise rides m
    r3 = m2 * (q2 - b2l) / (12.0 * b2l) * (
        1.0 + k * n * (key.variance_key_coefficient(bits) + _sq(key.expectation_key_coefficient()))
    )
    r4 = m2 * k * n / 4.0 * key.variance_key_coefficient(bits)
    r5 = mvar / 4.0 * _sq(1.0 - k * n * key.expectation_key_coefficient())
    return Variance.from_modular_variance(r1 + r2 + r3 + r4 + r5, bits)


def estimate_cmux_noise_with_binary_ggsw(
    glwe_dimension: int,
    poly_size: int,
    base_log: int,
    level: int,
    d_ct0: DispersionParameter,
    d_ct1: DispersionParameter,
    d_ggsw: DispersionParameter,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """CMux noise (operators.rs:646)."""
    ep = estimate_external_product_noise_with_binary_ggsw(
        poly_size,
        glwe_dimension,
        estimate_addition_noise(d_ct0, d_ct1, bits),
        d_ggsw,
        base_log,
        level,
        bits,
        key,
    )
    return estimate_addition_noise(ep, d_ct0, bits)


def estimate_pbs_noise(
    lwe_dimension: int,
    poly_size: int,
    glwe_dimension: int,
    base_log: int,
    level: int,
    dispersion_bsk: DispersionParameter,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """Programmable bootstrap output noise (operators.rs:698-729)."""
    n = float(lwe_dimension)
    k = float(glwe_dimension)
    b = float(1 << base_log)
    l = float(level)
    b2l = b ** (2.0 * l)
    big_n = float(poly_size)
    q2 = 2.0 ** (2 * bits)
    r1 = n * l * (k + 1.0) * big_n * (_sq(b) + 2.0) / 12.0 * dispersion_bsk.get_modular_variance(bits)
    r2 = (
        n * (q2 - b2l) / (24.0 * b2l)
        * (1.0 + k * big_n * (key.variance_key_coefficient(bits) + _sq(key.expectation_key_coefficient())))
        + n * k * big_n / 8.0 * key.variance_key_coefficient(bits)
        + n / 16.0 * _sq(1.0 - k * big_n * key.expectation_key_coefficient())
    )
    return Variance.from_modular_variance(r1 + r2, bits)


def estimate_mxu_truncation_noise(
    lwe_dimension: int,
    poly_size: int,
    glwe_dimension: int,
    base_log: int,
    level: int,
    limb_drop: int,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """Extra PBS output noise from the reduced-precision MXU external product
    (ServerConfig.mxu_limb_drop).

    Dropping the ``limb_drop`` lowest *balanced* byte limbs rounds every GGSW
    coefficient to the nearest multiple of 2^{8d} — an unbiased error of
    modular variance 2^{16d}/12 per coefficient, accumulated over the
    n*l*(k+1)*N MAC terms with digit second moment (B^2+2)/12.

    UNLIKE bootstrap-key encryption noise (which lives only in the GGSW
    rows' body components and therefore enters the phase directly), this
    rounding corrupts the raw table values of the MASK components too; at
    decryption the mask errors convolve with the secret key, amplifying the
    per-component variance by (1 + k*N*E[s^2]). Validated on hardware:
    measured blind-rotate phase error tracks this model at N in {256, 1024}
    (docs/performance.md "reduced-precision modes"). Zero when
    limb_drop == 0 (the exact default).
    """
    if limb_drop == 0:
        return Variance.from_modular_variance(0.0, bits)
    n = float(lwe_dimension)
    k = float(glwe_dimension)
    l = float(level)
    big_n = float(poly_size)
    var_round = (2.0 ** (16 * limb_drop)) / 12.0
    # digit second moment PER MXU ROW: for base_log > 7 the path splits each
    # gadget digit into n_sub balanced 7-bit sub-chunks (|e| <= 64, rings
    # pre-scaled by 2^{7j} before limb packing — bootstrap_mxu.MxuPlan), so
    # each of the l*(k+1)*n_sub*N rows carries a 2^7-bounded digit, not a
    # 2^base_log one. Slightly conservative for the narrower last chunk.
    if base_log <= 7:
        n_sub, digit_m2 = 1.0, (_sq(float(1 << base_log)) + 2.0) / 12.0
    else:
        n_sub = float((base_log - 8) // 7 + 2)
        digit_m2 = (_sq(128.0) + 2.0) / 12.0
    per_component = n * l * (k + 1.0) * n_sub * big_n * digit_m2 * var_round
    key_e2 = key.variance_key_coefficient(bits) + _sq(
        key.expectation_key_coefficient()
    )
    r = per_component * (1.0 + k * big_n * key_e2)
    return Variance.from_modular_variance(r, bits)


def estimate_tensor_product_noise(
    poly_size: int,
    glwe_dimension: int,
    d_glwe1: DispersionParameter,
    d_glwe2: DispersionParameter,
    delta_1: float,
    delta_2: float,
    max_msg_1: float,
    max_msg_2: float,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """GLWE tensor product (operators.rs:168)."""
    n = float(poly_size)
    k = float(glwe_dimension)
    delta = min(delta_1, delta_2)
    d2 = _sq(delta)
    q2 = 2.0 ** (2 * bits)
    v1 = d_glwe1.get_modular_variance(bits)
    v2 = d_glwe2.get_modular_variance(bits)
    r1 = n / d2 * (v1 * _sq(delta_2) * _sq(max_msg_2) + v2 * _sq(delta_1) * _sq(max_msg_1) + v1 * v2)
    r2 = (
        (q2 - 1.0) / 12.0
        * (
            1.0
            + k * n * key.variance_key_coefficient(bits)
            + k * n * _sq(key.expectation_key_coefficient())
        )
        + k * n / 4.0 * key.variance_key_coefficient(bits)
        + 1.0 / 4.0 * _sq(1.0 + k * n * key.expectation_key_coefficient())
    ) * (v1 + v2) * n / d2
    r3 = (
        1.0 / 12.0
        + k * n / (12.0 * d2) * (
            (d2 - 1.0)
            * (key.variance_key_coefficient(bits) + _sq(key.expectation_key_coefficient()))
            + 3.0 * key.variance_key_coefficient(bits)
        )
        + k * (k - 1.0) * n / (24.0 * d2) * (
            (d2 - 1.0)
            * (
                key.variance_coefficient_in_polynomial_key_times_key(poly_size, bits)
                + key.square_expectation_mean_in_polynomial_key_times_key(poly_size)
            )
            + 3.0 * key.variance_coefficient_in_polynomial_key_times_key(poly_size, bits)
        )
        + k * n / (24.0 * d2) * (
            (d2 - 1.0)
            * (
                key.variance_odd_coefficient_in_polynomial_key_squared(poly_size, bits)
                + key.variance_even_coefficient_in_polynomial_key_squared(poly_size, bits)
                + 2.0 * key.squared_expectation_mean_in_polynomial_key_squared(poly_size, bits)
            )
            + 3.0
            * (
                key.variance_odd_coefficient_in_polynomial_key_squared(poly_size, bits)
                + key.variance_even_coefficient_in_polynomial_key_squared(poly_size, bits)
            )
        )
    )
    return Variance.from_modular_variance(r1 + r2 + r3, bits)


def estimate_relinearization_noise(
    poly_size: int,
    glwe_dimension: int,
    dispersion_rlk: DispersionParameter,
    base_log: int,
    level: int,
    bits: int,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """Relinearization after tensor product (operators.rs:263)."""
    n = float(poly_size)
    k = float(glwe_dimension)
    base = float(1 << base_log)
    q2 = 2.0 ** (2 * bits)
    r1 = (
        k * level * n * dispersion_rlk.get_modular_variance(bits) * (k + 1.0) / 2.0
        * (_sq(base) + 2.0) / 12.0
    )
    r2 = k * n / 2.0 * (q2 / (12.0 * base ** (2 * level)) - 1.0 / 12.0) * (
        (k - 1.0)
        * (
            key.variance_coefficient_in_polynomial_key_times_key(poly_size, bits)
            + key.square_expectation_mean_in_polynomial_key_times_key(poly_size)
        )
        + key.variance_odd_coefficient_in_polynomial_key_squared(poly_size, bits)
        + key.variance_even_coefficient_in_polynomial_key_squared(poly_size, bits)
        + 2.0 * key.square_expectation_mean_in_polynomial_key_times_key(poly_size)
    )
    r3 = k * n / 8.0 * (
        (k - 1.0) * key.variance_coefficient_in_polynomial_key_times_key(poly_size, bits)
        + key.variance_odd_coefficient_in_polynomial_key_squared(poly_size, bits)
        + key.variance_even_coefficient_in_polynomial_key_squared(poly_size, bits)
    )
    return Variance.from_modular_variance(r1 + r2 + r3, bits)


def estimate_multiplication_noise(
    poly_size: int,
    glwe_dimension: int,
    d_glwe1,
    d_glwe2,
    delta_1,
    delta_2,
    max_msg_1,
    max_msg_2,
    dispersion_rlk,
    base_log,
    level,
    bits,
    key: KeyDispersion = BINARY_KEY,
) -> Variance:
    """Full GLWE multiplication = tensor product + relinearization
    (operators.rs:349)."""
    r1 = estimate_tensor_product_noise(
        poly_size, glwe_dimension, d_glwe1, d_glwe2, delta_1, delta_2,
        max_msg_1, max_msg_2, bits, key,
    )
    r2 = estimate_relinearization_noise(
        poly_size, glwe_dimension, dispersion_rlk, base_log, level, bits, key
    )
    return estimate_addition_noise(r1, r2, bits)


def estimate_number_of_noise_bits(dispersion: DispersionParameter, bits: int) -> int:
    """ceil(log2(4 * modular_std_dev)), clamped at 0 (tools.rs:7)."""
    tmp = math.log2(max(dispersion.get_modular_standard_dev(bits), 1e-300) * 4.0)
    return 0 if tmp < 0.0 else math.ceil(tmp)
