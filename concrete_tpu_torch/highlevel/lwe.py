"""Noise-tracked LWE ciphertexts with encoders — the user-facing workhorse.

Mirrors concrete/src/lwe/mod.rs: every operation updates the encoder (offset,
delta, padding, precision) and the tracked noise variance via the NPE; users
see real-valued semantics with automatic precision-loss warnings.

Batch-first: `data` holds a ciphertext batch of any leading shape sharing one
encoder. The reference's single-LWE API is the shape-() special case.
Ciphertext data stays a host np.uint64 array, as in concrete_tpu;
bootstrap and keyswitch run on the key's device and come back to the host.

Example:
    >>> from concrete_tpu_torch.highlevel import LWE, Encoder, LWESecretKey, LWEParams
    >>> sk = LWESecretKey.new(LWEParams(dimension=32, log2_std_dev=-40), secret_seed=1)
    >>> enc = Encoder.new(0.0, 10.0, nb_bit_precision=6, nb_bit_padding=1)
    >>> ct = LWE.encode_encrypt(sk, 4.0, enc, mask_seed=2, noise_seed=3)
    >>> abs(float(ct.decrypt_decode(sk)) - 4.0) < enc.get_granularity()
    True
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .. import npe
from ..csprng import EncryptionRandomGenerator
from ..dispersion import Variance
from ..torus import to_numpy
from . import errors
from .encoder import BITS, DTYPE, Encoder
from .keys import LWEBSK, LWEKSK, LWESecretKey


def _deltas_eq(d1: float, d2: float) -> bool:
    """Float-tolerant delta comparison (concrete/src/lib.rs deltas_eq!)."""
    return abs(d1 - d2) <= max(abs(d1), abs(d2)) * 2.0 ** -45


def _opposite_correction(encoder: Encoder) -> np.uint64:
    """Body correction for ciphertext negation (lwe/mod.rs:1550-1563):
    (1 << (B-pad)) - (1 << (B-pad-prec)), computed wrapping for pad == 0."""
    with np.errstate(over="ignore"):
        hi = (
            DTYPE(1) << DTYPE(BITS - encoder.nb_bit_padding)
            if encoder.nb_bit_padding > 0
            else DTYPE(0)
        )
        lo = DTYPE(1) << DTYPE(
            BITS - encoder.nb_bit_padding - encoder.nb_bit_precision
        )
        return (hi - lo).astype(DTYPE)


def log2_rounding_noise(dimension: int) -> float:
    """log2 std-dev (in 2N-step units) of the PBS modulus-switch rounding.

    Analog of the published npe 0.1.x `lwe::log2_rounding_noise` used at
    concrete/src/lwe/mod.rs:1855: rounding each of n mask elements and the
    body to Z_{2N} adds variance ~ (n/2 + 1)/12 in step units.
    """
    return 0.5 * np.log2(dimension / 24.0 + 1.0 / 12.0)


@dataclasses.dataclass
class LWE:
    """ciphertext batch [..., n+1] u64 + encoder + tracked variance."""

    data: np.ndarray
    encoder: Encoder
    variance: float

    # -- constructors --------------------------------------------------------

    @classmethod
    def encode_encrypt(
        cls,
        sk: LWESecretKey,
        messages,
        encoder: Encoder,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> "LWE":
        """Encode reals then encrypt (lwe/mod.rs encode_encrypt)."""
        pts = encoder.encode_core(messages)
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        data = sk.inner.encrypt(pts, sk.std_dev, gen)
        out = cls(data=data, encoder=encoder.copy(), variance=sk.variance)
        out.encoder.update_precision_from_variance(out.variance)
        return out

    @classmethod
    def encrypt_raw(
        cls,
        sk: LWESecretKey,
        plaintexts,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> "LWE":
        """Encrypt raw torus values without encoding (lwe/mod.rs:168
        encrypt_raw): the encoder is left as the zero/invalid marker and the
        variance is the key's. Raises NoNoiseInCiphertext when the key's
        noise is too small for the integer representation."""
        if sk.std_dev < 2.0 ** (-(BITS) + 2):
            raise errors.NoNoiseInCiphertext(sk.variance)
        pts = np.asarray(plaintexts, dtype=DTYPE)
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        data = sk.inner.encrypt(pts, sk.std_dev, gen)
        return cls(data=data, encoder=Encoder.zero(), variance=sk.variance)

    def decrypt_raw(self, sk: LWESecretKey) -> np.ndarray:
        """Raw phase (torus values, no decode) — vector_lwe/mod.rs:565
        decrypt_raw semantics on the batch."""
        if sk.dimension != self.dimension:
            raise errors.DimensionError(self.dimension, sk.dimension)
        return np.asarray(sk.inner.decrypt(self.data), dtype=DTYPE)

    @classmethod
    def zero(cls, dimension: int, shape=()) -> "LWE":
        """Trivial zero ciphertext (lwe/mod.rs zero)."""
        return cls(
            data=np.zeros(tuple(shape) + (dimension + 1,), dtype=DTYPE),
            encoder=Encoder(0.0, 1.0, 1, 0),
            variance=0.0,
        )

    @property
    def dimension(self) -> int:
        return self.data.shape[-1] - 1

    @property
    def shape(self):
        return self.data.shape[:-1]

    def copy(self) -> "LWE":
        return LWE(self.data.copy(), self.encoder.copy(), self.variance)

    # -- decryption ------------------------------------------------------------

    def decrypt_decode(self, sk: LWESecretKey) -> np.ndarray:
        """Decrypt then decode to reals (lwe/mod.rs decrypt_decode)."""
        phase = sk.inner.decrypt(self.data)
        return self.encoder.decode_core(phase)

    def decrypt_decode_round(self, sk: LWESecretKey) -> np.ndarray:
        enc = self.encoder.copy()
        enc.round = True
        phase = sk.inner.decrypt(self.data)
        return enc.decode_core(phase)

    # -- constant addition (lwe/mod.rs:313-487) ---------------------------------

    def add_constant_static_encoder(self, constants) -> "LWE":
        """message + constant, same encoder: add encode(constant) to the body
        without the interval offset (lwe/mod.rs:313)."""
        out = self.copy()
        c = np.asarray(constants, dtype=np.float64)
        from ..torus import from_torus_f64

        correction = from_torus_f64(c / self.encoder.delta, BITS)
        if self.encoder.nb_bit_padding > 0:
            correction = correction >> DTYPE(self.encoder.nb_bit_padding)
        out.data[..., -1] += correction
        return out

    def add_constant_dynamic_encoder(self, constant) -> "LWE":
        """Ciphertext unchanged; the encoder's interval shifts (lwe/mod.rs:413).

        The batch shares ONE encoder, so only a scalar constant is
        representable; per-slot constants need VectorLWE."""
        if np.ndim(constant) and np.asarray(constant).size != 1:
            raise errors.DimensionError(int(np.asarray(constant).size), 1)
        out = self.copy()
        out.encoder.o += float(np.asarray(constant).ravel()[0])
        return out

    # -- ciphertext addition -----------------------------------------------------

    def add_with_new_min(self, other: "LWE", new_min: float) -> "LWE":
        """Add with an explicitly chosen output minimum (lwe/mod.rs:489)."""
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        if not _deltas_eq(self.encoder.delta, other.encoder.delta):
            raise errors.DeltaError(self.encoder.delta, other.encoder.delta)
        out = self.copy()
        out.data = self.data + other.data
        # correction: + encode_{o=new_min}(o1 + o2), computed outside the
        # interval check (lwe/mod.rs:545-556: wrapping_add of
        # encode_outside_interval_operators on a tmp encoder with o=new_min)
        tmp_enc = self.encoder.copy()
        tmp_enc.o = new_min
        correction = tmp_enc.encode_outside_interval(
            np.float64(self.encoder.o + other.encoder.o)
        )
        out.data[..., -1] += correction
        out.encoder.o = new_min
        out.variance = self.variance + other.variance
        out.encoder.nb_bit_precision = min(
            self.encoder.nb_bit_precision, other.encoder.nb_bit_precision
        )
        out.encoder.update_precision_from_variance(out.variance)
        return out

    def add_centered(self, other: "LWE") -> "LWE":
        """Add, recentering the output interval (lwe/mod.rs:625)."""
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        if not _deltas_eq(self.encoder.delta, other.encoder.delta):
            raise errors.DeltaError(self.encoder.delta, other.encoder.delta)
        out = self.copy()
        out.data = self.data + other.data
        tmp_enc = self.encoder.copy()
        tmp_enc.o = 0.0
        correction = tmp_enc.encode_core(np.float64(self.encoder.delta / 2.0))
        out.data[..., -1] -= correction
        out.encoder.o += other.encoder.o + self.encoder.delta / 2.0
        out.variance = self.variance + other.variance
        out.encoder.update_precision_from_variance(out.variance)
        return out

    def add_with_padding(self, other: "LWE") -> "LWE":
        """Add consuming one padding bit (lwe/mod.rs:742)."""
        if self.encoder.nb_bit_padding != other.encoder.nb_bit_padding:
            raise errors.PaddingError(
                self.encoder.nb_bit_padding, other.encoder.nb_bit_padding
            )
        if self.encoder.nb_bit_padding == 0:
            raise errors.NotEnoughPaddingError(0, 1)
        if not _deltas_eq(self.encoder.delta, other.encoder.delta):
            raise errors.DeltaError(self.encoder.delta, other.encoder.delta)
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        out = self.copy()
        out.data = self.data + other.data
        out.variance = self.variance + other.variance
        out.encoder.o += other.encoder.o
        out.encoder.delta *= 2.0
        out.encoder.nb_bit_padding -= 1
        out.encoder.nb_bit_precision = min(
            self.encoder.nb_bit_precision, other.encoder.nb_bit_precision
        )
        out.encoder.update_precision_from_variance(out.variance)
        return out

    def add_with_padding_exact(self, other: "LWE") -> "LWE":
        """Add consuming one padding bit, *growing* the message precision:
        nb_bit_precision = max(nb1, nb2) + 1 (lwe/mod.rs:858
        add_with_padding_exact_inplace). Unlike add_with_padding, the sum is
        tracked exactly — no correction term, no precision clamp to min."""
        if self.encoder.nb_bit_padding != other.encoder.nb_bit_padding:
            raise errors.PaddingError(
                self.encoder.nb_bit_padding, other.encoder.nb_bit_padding
            )
        if self.encoder.nb_bit_padding == 0:
            raise errors.NotEnoughPaddingError(0, 1)
        if not _deltas_eq(self.encoder.delta, other.encoder.delta):
            raise errors.DeltaError(self.encoder.delta, other.encoder.delta)
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        out = self.copy()
        out.data = self.data + other.data
        out.variance = self.variance + other.variance
        out.encoder.o += other.encoder.o
        out.encoder.delta *= 2.0
        out.encoder.nb_bit_padding -= 1
        out.encoder.nb_bit_precision = (
            max(self.encoder.nb_bit_precision, other.encoder.nb_bit_precision) + 1
        )
        out.encoder.update_precision_from_variance(out.variance)
        return out

    def sub_with_padding_exact(self, other: "LWE") -> "LWE":
        """Subtract consuming one padding bit, growing the precision to
        max(nb1, nb2) + 1 (lwe/mod.rs:1095 sub_with_padding_exact_inplace).
        The body correction is the plain padding-bit recentering
        1 << (BITS - padding) — no granularity adjustment."""
        if self.encoder.nb_bit_padding != other.encoder.nb_bit_padding:
            raise errors.PaddingError(
                self.encoder.nb_bit_padding, other.encoder.nb_bit_padding
            )
        if self.encoder.nb_bit_padding == 0:
            raise errors.NotEnoughPaddingError(0, 1)
        if not _deltas_eq(self.encoder.delta, other.encoder.delta):
            raise errors.DeltaError(self.encoder.delta, other.encoder.delta)
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        out = self.copy()
        out.data = self.data - other.data
        correction = DTYPE(1) << DTYPE(BITS - self.encoder.nb_bit_padding)
        out.data[..., -1] += correction
        out.encoder.o -= other.encoder.o + other.encoder.delta
        out.encoder.delta *= 2.0
        out.encoder.nb_bit_padding -= 1
        out.encoder.nb_bit_precision = (
            max(self.encoder.nb_bit_precision, other.encoder.nb_bit_precision) + 1
        )
        out.variance = self.variance + other.variance
        out.encoder.update_precision_from_variance(out.variance)
        return out

    def sub_with_padding(self, other: "LWE") -> "LWE":
        """Subtract consuming one padding bit (lwe/mod.rs:977)."""
        if self.encoder.nb_bit_padding != other.encoder.nb_bit_padding:
            raise errors.PaddingError(
                self.encoder.nb_bit_padding, other.encoder.nb_bit_padding
            )
        if self.encoder.nb_bit_padding == 0:
            raise errors.NotEnoughPaddingError(0, 1)
        if not _deltas_eq(self.encoder.delta, other.encoder.delta):
            raise errors.DeltaError(self.encoder.delta, other.encoder.delta)
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        out = self.copy()
        out.data = self.data - other.data
        # re-center: the result lives in [o1 - max2, ...]; the reference adds
        # encode(max2 - o2) = encode(delta - granularity) on a zero-offset copy
        tmp_enc = self.encoder.copy()
        tmp_enc.o = 0.0
        correction = tmp_enc.encode_core(
            np.float64(self.encoder.delta - self.encoder.get_granularity())
        )
        out.data[..., -1] += correction
        out.variance = self.variance + other.variance
        out.encoder.o -= other.encoder.o + other.encoder.delta - other.encoder.get_granularity()
        out.encoder.delta *= 2.0
        out.encoder.nb_bit_padding -= 1
        out.encoder.nb_bit_precision = min(
            self.encoder.nb_bit_precision, other.encoder.nb_bit_precision
        )
        out.encoder.update_precision_from_variance(out.variance)
        return out

    # -- constant multiplication ---------------------------------------------------

    def mul_constant_static_encoder(self, constants) -> "LWE":
        """Multiply by small integers, same encoder (lwe/mod.rs:1214)."""
        out = self.copy()
        c = np.asarray(constants, dtype=np.int64)
        # b -= (c - 1) * encode(0): keeps the interval offset consistent
        # (lwe/mod.rs:1214 mul_constant_static_encoder)
        zero_pt = self.encoder.encode_outside_interval(np.float64(0.0))
        out.data = (self.data * c.astype(np.uint64)[..., None]).astype(DTYPE)
        out.data[..., -1] -= ((c - 1).astype(np.uint64) * zero_pt).astype(DTYPE)
        out.variance = npe.estimate_integer_plaintext_multiplication_noise(
            Variance(self.variance), int(np.max(np.abs(c)))
        ).get_variance()
        out.encoder.update_precision_from_variance(out.variance)
        return out

    def mul_constant_with_padding(
        self, constant: float, max_constant: float, nb_bit_padding: int
    ) -> "LWE":
        """Multiply by a real constant in [-max, max], consuming padding
        (lwe/mod.rs:1320)."""
        if abs(constant) > max_constant:
            raise errors.ConstantMaximumError(constant, max_constant)
        if self.encoder.o > 0.0 or self.encoder.o + self.encoder.delta < 0.0:
            raise errors.ZeroInIntervalError(self.encoder.o, self.encoder.delta)
        if self.encoder.nb_bit_padding < nb_bit_padding:
            raise errors.NotEnoughPaddingError(self.encoder.nb_bit_padding, nb_bit_padding)
        negative = constant < 0.0
        c_abs = abs(constant)
        scal = int(round(c_abs / max_constant * 2.0 ** nb_bit_padding))
        out = self.copy()
        zero_enc = self.encoder.encode_core(np.float64(0.0))
        out.data[..., -1] -= zero_enc
        out.data = (out.data.astype(np.uint64) * np.uint64(scal)).astype(DTYPE)
        new_o = self.encoder.o * max_constant
        new_max = (
            self.encoder.o + self.encoder.delta - self.encoder.get_granularity()
        ) * max_constant
        new_delta = new_max - new_o
        discret_c_abs = scal * 2.0 ** (-nb_bit_padding) * max_constant
        rounding_error = abs(discret_c_abs - c_abs)
        granularity = self.encoder.get_granularity()
        mx = max(
            abs(self.encoder.o + self.encoder.delta - granularity), abs(self.encoder.o)
        )
        new_granularity = 2.0 * abs(
            granularity * rounding_error / 2.0
            + granularity / 2.0 * discret_c_abs
            + rounding_error * mx
        )
        new_precision = min(
            int(np.floor(np.log2(new_delta / max(new_granularity, 1e-300)))),
            self.encoder.nb_bit_precision,
        )
        out.encoder = Encoder(
            o=new_o,
            delta=new_delta,
            nb_bit_precision=max(new_precision, 1),
            nb_bit_padding=self.encoder.nb_bit_padding - nb_bit_padding,
            round=self.encoder.round,
        )
        # the zero-offset multiply left the phase as c*x/delta_out; re-add the
        # output interval offset so decode sees encode_out(c*x)
        out.data[..., -1] += out.encoder.encode_core(np.float64(0.0))
        out.variance = npe.estimate_integer_plaintext_multiplication_noise(
            Variance(self.variance), scal
        ).get_variance()
        out.encoder.update_precision_from_variance(out.variance)
        if negative:
            out = out.opposite()
        return out

    def opposite(self) -> "LWE":
        """Negate (lwe/mod.rs:1531). The body correction re-aligns the negated
        phase with the opposite encoder's lattice: -(t·2^{B-pad}) mod 2^B sits
        one interval-plus-granularity off the encoding of (max - x)
        (lwe/mod.rs:1550-1563)."""
        if not self.encoder.is_valid():
            raise errors.InvalidEncoderError(
                self.encoder.nb_bit_precision, self.encoder.delta
            )
        out = self.copy()
        out.data = (np.zeros_like(self.data) - self.data).astype(DTYPE)
        out.data[..., -1] += _opposite_correction(self.encoder)
        out.encoder = self.encoder.opposite()
        return out

    # -- padding management -----------------------------------------------------------

    def remove_padding(self, nb: int) -> "LWE":
        """Shift out padding MSBs (lwe/mod.rs remove_padding_inplace)."""
        if self.encoder.nb_bit_padding < nb:
            raise errors.NotEnoughPaddingError(self.encoder.nb_bit_padding, nb)
        out = self.copy()
        out.data = (self.data << DTYPE(nb)).astype(DTYPE)
        out.encoder.nb_bit_padding -= nb
        out.variance = npe.estimate_integer_plaintext_multiplication_noise(
            Variance(self.variance), 1 << nb
        ).get_variance()
        out.encoder.update_precision_from_variance(out.variance)
        return out

    # -- keyswitch / bootstrap -----------------------------------------------------------

    def keyswitch(self, ksk: LWEKSK) -> "LWE":
        """Switch to the output key (lwe/mod.rs:1643)."""
        out_data = to_numpy(ksk.run_keyswitch(self.data))
        new_var = npe.estimate_keyswitch_noise_with_constant_terms(
            self.dimension,
            Variance(self.variance),
            Variance(ksk.variance),
            ksk.base_log,
            ksk.level,
            BITS,
        ).get_variance()
        out = LWE(out_data, self.encoder.copy(), new_var)
        out.encoder.update_precision_from_variance(new_var)
        return out

    def bootstrap(self, bsk: LWEBSK) -> "LWE":
        """Noise-refreshing bootstrap with the identity function
        (lwe/mod.rs:1727)."""
        return self.bootstrap_with_function(bsk, lambda x: x, self.encoder)

    def bootstrap_with_function(self, bsk: LWEBSK, f, encoder_output: Encoder) -> "LWE":
        """PBS with an arbitrary f64 -> f64 function (lwe/mod.rs:1781).

        The accumulator LUT samples f over the input interval
        (lwe_bsk.rs:50-108); one padding bit is consumed.
        """
        if self.dimension != bsk.get_lwe_dimension():
            raise errors.DimensionError(self.dimension, bsk.get_lwe_dimension())
        lut = generate_functional_lut(bsk, self.encoder, encoder_output, f)
        accumulator = _accumulator(bsk, lut)

        ct = self
        if self.encoder.nb_bit_padding > 1:
            ct = self.remove_padding(self.encoder.nb_bit_padding - 1)
        out_data = to_numpy(bsk.run_bootstrap(accumulator, ct.data))
        new_var = bsk.bootstrap_output_variance(self.dimension)
        new_encoder = encoder_output.copy()
        nb_overlap = new_encoder.update_precision_from_variance(new_var)
        if nb_overlap > 0:
            warnings.warn(
                f"Loss of precision during bootstrap: {nb_overlap} bit(s) lost "
                f"over {self.encoder.nb_bit_precision} bit(s) of message."
            )
        # modulus-switch rounding can also eat precision (lwe/mod.rs:1855+)
        nb_rounding = int(np.ceil(log2_rounding_noise(self.dimension))) + 1
        if nb_rounding + 1 + new_encoder.nb_bit_precision > bsk.get_polynomial_size_log() + 1:
            nb_loss = (
                1 + new_encoder.nb_bit_precision + nb_rounding
                - bsk.get_polynomial_size_log() - 1
            )
            new_encoder.nb_bit_precision = max(new_encoder.nb_bit_precision - nb_loss, 0)
            warnings.warn(
                f"Loss of precision during modulus switch: {nb_loss} bit(s)."
            )
        return LWE(out_data, new_encoder, new_var)

    def bootstrap_with_functions(self, bsk: LWEBSK, fns, encoder_output: Encoder):
        """Evaluate several functions of this ciphertext with ONE blind
        rotation (multi-LUT PBS, the LutCountLog machinery): returns one
        refreshed LWE per function. Costs ~a single bootstrap instead of
        len(fns); each output carries the standard PBS noise."""
        if self.dimension != bsk.get_lwe_dimension():
            raise errors.DimensionError(self.dimension, bsk.get_lwe_dimension())
        lut, lcl = generate_functional_lut_pack(bsk, self.encoder, encoder_output, fns)
        accumulator = _accumulator(bsk, lut)
        ct = self
        if self.encoder.nb_bit_padding > 1:
            ct = self.remove_padding(self.encoder.nb_bit_padding - 1)
        outs = to_numpy(bsk.run_bootstrap_many(
            accumulator, ct.data, lcl))                   # [2^lcl, ..., kN+1]
        new_var = bsk.bootstrap_output_variance(self.dimension)
        results = []
        for t in range(len(fns)):
            new_encoder = encoder_output.copy()
            new_encoder.update_precision_from_variance(new_var)
            results.append(LWE(outs[t], new_encoder, new_var))
        return results

    def mul_from_bootstrap(self, other: "LWE", bsk: LWEBSK) -> "LWE":
        """x*y = ((x+y)^2 - (x-y)^2) / 4 with two PBS (lwe/mod.rs:1946)."""
        if self.encoder.nb_bit_precision < 2:
            raise errors.NotEnoughPaddingError(self.encoder.nb_bit_precision, 2)
        ct1 = self.add_with_padding(other)
        ct2 = self.sub_with_padding(other)
        enc1 = ct1.encoder.new_square_divided_by_four(2)
        enc2 = ct2.encoder.new_square_divided_by_four(2)
        if enc1.delta < enc2.delta:
            enc1.delta = enc2.delta
        else:
            enc2.delta = enc1.delta
        sq1 = ct1.bootstrap_with_function(bsk, lambda x: x * x / 4.0, enc1)
        sq2 = ct2.bootstrap_with_function(bsk, lambda x: x * x / 4.0, enc2)
        # ((x+y)^2 - (x-y)^2) / 4 IS x*y: the /4 lives in the bootstrap
        # functions, so the subtraction already encodes the product.
        return sq1.sub_with_padding(sq2)

    # -- serialization ------------------------------------------------------------

    def save(self, path: str):
        np.savez_compressed(
            path,
            data=self.data,
            variance=self.variance,
            encoder=self.encoder.to_json(),
        )

    @classmethod
    def load(cls, path: str) -> "LWE":
        d = np.load(path, allow_pickle=False)
        return cls(
            data=d["data"],
            encoder=Encoder.from_json(str(d["encoder"])),
            variance=float(d["variance"]),
        )


def _accumulator(bsk: LWEBSK, lut: np.ndarray) -> np.ndarray:
    """Trivial GLWE [k+1, N] u64 with the LUT as its body polynomial."""
    acc = np.zeros((bsk.cfg.glwe_size, bsk.polynomial_size), dtype=DTYPE)
    acc[-1] = lut
    return acc


def generate_functional_lut_pack(bsk, encoder_input, encoder_output, fns):
    """Interleave 2^lcl functional LUT tracks into one test polynomial.

    Coefficient p = q*2^lcl + t holds f_t sampled at the plaintext whose
    modulus switch (rounded to multiples of 2^lcl by LutCountLog) rotates
    position q*2^lcl to 0 — i.e. the same sampling grid as the single-LUT
    builder, decimated per track. Returns (lut [N] u64, lut_count_log)."""
    import math

    n_fns = len(fns)
    lcl = max(1, math.ceil(math.log2(max(n_fns, 2))))
    if (1 << lcl) > bsk.polynomial_size:
        raise errors.DimensionError(bsk.polynomial_size, 1 << lcl)
    if encoder_input.nb_bit_padding < 1:
        raise errors.NotEnoughPaddingError(0, 1)
    n = bsk.polynomial_size
    enc_in = encoder_input.copy()
    enc_in.nb_bit_padding = 1
    shift = BITS - bsk.get_polynomial_size_log() - 1
    i = np.arange(n, dtype=np.uint64)
    track = (i % np.uint64(1 << lcl)).astype(np.int64)
    base = i - i % np.uint64(1 << lcl)          # q * 2^lcl
    decoded = enc_in.decode_core(base << np.uint64(shift))
    f_vals = np.empty(n, dtype=np.float64)
    for t in range(1 << lcl):
        fn = fns[t] if t < n_fns else fns[-1]
        sel = track == t
        f_vals[sel] = [fn(float(x)) for x in decoded[sel]]
    out_encoded = encoder_output.encode_outside_interval(f_vals)
    minus_start = n - (n >> (1 + encoder_input.nb_bit_precision))
    neg = np.zeros_like(out_encoded) - out_encoded
    return np.where(i < minus_start, out_encoded, neg).astype(DTYPE), lcl


def generate_functional_lut(bsk: LWEBSK, encoder_input: Encoder, encoder_output: Encoder, f):
    """Sample f over the input interval into an N-entry torus LUT
    (lwe_bsk.rs:50-108): entry i covers phase (i << (BITS - log2(N) - 1));
    the upper half (wrap-around region) is negated."""
    if encoder_input.nb_bit_precision == 0:
        raise errors.PrecisionError()
    if encoder_input.nb_bit_padding == 0:
        raise errors.NotEnoughPaddingError(0, 1)
    n = bsk.polynomial_size
    enc_in = encoder_input.copy()
    enc_in.nb_bit_padding = 1
    shift = BITS - bsk.get_polynomial_size_log() - 1
    i = np.arange(n, dtype=np.uint64)
    encoded = i << np.uint64(shift)
    decoded = enc_in.decode_core(encoded)
    f_vals = np.asarray([f(float(x)) for x in decoded], dtype=np.float64)
    out_encoded = encoder_output.encode_outside_interval(f_vals)
    minus_start = n - (n >> (1 + encoder_input.nb_bit_precision))
    neg = np.zeros_like(out_encoded) - out_encoded
    return np.where(i < minus_start, out_encoded, neg).astype(DTYPE)
