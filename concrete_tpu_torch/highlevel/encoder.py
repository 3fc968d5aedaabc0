"""Real-interval torus encoder with padding bits and dynamic precision.

Mirrors concrete/src/encoder/mod.rs: an Encoder maps the real interval
[o, o + delta) onto the torus, reserving `nb_bit_padding` MSBs for carries
and tracking `nb_bit_precision` usable message bits that shrink as noise
grows (update_precision_from_variance, :151).

A copy of concrete_tpu/highlevel/encoder.py on the port's torus, npe and
dispersion modules (host numpy, u64 torus), with the struct-of-arrays
helpers that VectorRLWE uses (EncoderFields, encode_bulk, ...).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .. import npe
from ..dispersion import Variance
from ..torus import from_torus_f64, into_torus_f64
from . import errors

BITS = 64  # high-level torus is u64 (concrete/src/lib.rs:22)
DTYPE = np.uint64


def _closest_representable_scalar(x: int, base_log: int, bits: int = BITS) -> int:
    """Round to the (base_log)-bit prefix lattice (1 level), scalar version."""
    non_rep = bits - base_log
    if non_rep == 0:
        return x & ((1 << bits) - 1)
    msb = (x >> (non_rep - 1)) & 1
    return (((x >> non_rep) + msb) << non_rep) & ((1 << bits) - 1)


def _closest_representable_array(x: np.ndarray, base_log: int) -> np.ndarray:
    """Vectorized _closest_representable_scalar on u64 arrays (wrapping)."""
    non_rep = BITS - base_log
    if non_rep == 0:
        return x
    x = np.asarray(x, dtype=DTYPE)
    msb = (x >> DTYPE(non_rep - 1)) & DTYPE(1)
    with np.errstate(over="ignore"):
        return ((x >> DTYPE(non_rep)) + msb) << DTYPE(non_rep)


@dataclasses.dataclass
class Encoder:
    """o = interval min (with margin), delta = interval width (with margin),
    nb_bit_precision, nb_bit_padding, round (encoder/mod.rs:27-32)."""

    o: float
    delta: float
    nb_bit_precision: int
    nb_bit_padding: int
    round: bool = False

    # -- constructors -------------------------------------------------------

    @classmethod
    def new(cls, min_: float, max_: float, nb_bit_precision: int, nb_bit_padding: int):
        """Interval [min, max] with a half-granularity margin (encoder/mod.rs:59).

        >>> from concrete_tpu_torch.highlevel import Encoder
        >>> e = Encoder.new(0.0, 10.0, nb_bit_precision=5, nb_bit_padding=2)
        >>> float(e.decode_core(e.encode_core(4.0))) - 4.0 < e.get_granularity()
        True
        """
        if min_ >= max_:
            raise errors.MinMaxError(min_, max_)
        if nb_bit_precision == 0:
            raise errors.PrecisionError()
        margin = (max_ - min_) / (2.0 ** nb_bit_precision - 1.0)
        return cls(
            o=min_,
            delta=max_ - min_ + margin,
            nb_bit_precision=nb_bit_precision,
            nb_bit_padding=nb_bit_padding,
            round=False,
        )

    @classmethod
    def new_rounding_context(
        cls, min_: float, max_: float, nb_bit_precision: int, nb_bit_padding: int
    ):
        """Same, but decodes snap to the message lattice (encoder/mod.rs:107)."""
        enc = cls.new(min_, max_, nb_bit_precision, nb_bit_padding)
        enc.round = True
        return enc

    @classmethod
    def new_centered(
        cls, center: float, radius: float, nb_bit_precision: int, nb_bit_padding: int
    ):
        """Interval [center - radius, center + radius] (encoder/mod.rs:201)."""
        return cls.new(center - radius, center + radius, nb_bit_precision, nb_bit_padding)

    @classmethod
    def zero(cls) -> "Encoder":
        """The invalid all-zero encoder marking an empty slot
        (encoder/mod.rs Encoder::zero; is_valid() is False).

        >>> from concrete_tpu_torch.highlevel import Encoder
        >>> Encoder.zero().is_valid()
        False
        """
        return cls(o=0.0, delta=0.0, nb_bit_precision=0, nb_bit_padding=0)

    # -- introspection -------------------------------------------------------

    def get_granularity(self) -> float:
        return self.delta / 2.0 ** self.nb_bit_precision

    def get_min(self) -> float:
        return self.o

    def get_max(self) -> float:
        return self.o + self.delta - self.get_granularity()

    def get_size(self) -> int:
        return self.nb_bit_precision + self.nb_bit_padding

    def is_valid(self) -> bool:
        return self.nb_bit_precision > 0 and self.delta > 0

    def copy(self) -> "Encoder":
        return dataclasses.replace(self)

    # -- encode / decode -----------------------------------------------------

    def encode_core(self, m) -> np.ndarray:
        """Real -> torus u64 (encoder/mod.rs:466): must lie in the interval."""
        m = np.asarray(m, dtype=np.float64)
        if np.any(m < self.o) or np.any(m >= self.o + self.delta):
            bad = m[(m < self.o) | (m >= self.o + self.delta)].ravel()[0]
            raise errors.MessageOutsideIntervalError(float(bad), self.o, self.delta)
        return self.encode_outside_interval(m)

    def encode_outside_interval(self, m) -> np.ndarray:
        """Encode without the interval check (used by LUT generation,
        encoder/mod.rs:480 encode_outside_interval_operators)."""
        if not self.is_valid():
            raise errors.InvalidEncoderError(self.nb_bit_precision, self.delta)
        m = np.asarray(m, dtype=np.float64)
        res = from_torus_f64((m - self.o) / self.delta, BITS)
        if self.round:
            res = _closest_representable_array(res, self.nb_bit_precision)
        if self.nb_bit_padding > 0:
            res = res >> DTYPE(self.nb_bit_padding)
        return res

    def decode_core(self, pt) -> np.ndarray:
        """Torus u64 -> real (encoder/mod.rs:546): optional rounding, padding
        removal, security-margin rounding, then affine decode."""
        if not self.is_valid():
            raise errors.InvalidEncoderError(self.nb_bit_precision, self.delta)
        pt = np.asarray(pt, dtype=DTYPE)
        tmp = pt
        if self.round:
            tmp = _closest_representable_array(
                tmp, self.nb_bit_precision + self.nb_bit_padding)
        if self.nb_bit_padding > 0:
            tmp = tmp << DTYPE(self.nb_bit_padding)
        # round to the message lattice when inside the security-margin band.
        # Reference (encoder/mod.rs:571) computes (2^{p+1}-1) << (B-p), which
        # wraps in u64 to 2^B - 2^{B-p}; we reproduce the wrapped value so
        # round=False decoding snaps in exactly the same band.
        margin_start = DTYPE(
            (((1 << (self.nb_bit_precision + 1)) - 1)
             << (BITS - self.nb_bit_precision)) & ((1 << BITS) - 1)
        )
        snapped = _closest_representable_array(tmp, self.nb_bit_precision)
        tmp = np.where(tmp > margin_start, snapped, tmp)
        return into_torus_f64(tmp, BITS) * self.delta + self.o

    # -- dynamic precision -----------------------------------------------------

    def update_precision_from_variance(self, variance: float) -> int:
        """Shrink precision when noise eats into the message bits
        (encoder/mod.rs:151). Returns the number of overlapped bits."""
        nb_noise_bit = npe.estimate_number_of_noise_bits(Variance(variance), BITS)
        if nb_noise_bit == 0:
            raise errors.NoNoiseInCiphertext(variance)
        if nb_noise_bit + self.nb_bit_precision + self.nb_bit_padding > BITS:
            overlap = nb_noise_bit + self.nb_bit_precision + self.nb_bit_padding - BITS
            self.nb_bit_precision = max(self.nb_bit_precision - overlap, 0)
            return overlap
        return 0

    # -- transforms -------------------------------------------------------------

    def opposite(self) -> "Encoder":
        """Encoder of -x (encoder/mod.rs:606 opposite_inplace)."""
        out = self.copy()
        old_max = self.o + self.delta - self.get_granularity()
        out.o = -old_max
        return out

    def new_square_divided_by_four(self, nb_bit_padding: int) -> "Encoder":
        """Output encoder for x -> x^2/4 (used by mul_from_bootstrap)."""
        mx = max(abs(self.get_max()), abs(self.get_min()))
        sq_max = mx * mx / 4.0
        return Encoder.new(0.0, sq_max, self.nb_bit_precision, nb_bit_padding)

    # -- serialization -----------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Encoder":
        return cls(**json.loads(s))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Encoder":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# vectorized bulk helpers: struct-of-arrays view over Encoder lists
# ---------------------------------------------------------------------------
#
# The VectorRLWE API carries one Encoder PER POLYNOMIAL COEFFICIENT (m*N of
# them); per-coefficient method calls would cost O(m*N) interpreter
# iterations of encode/NPE arithmetic (reference analog is a flat compiled
# loop, vector_rlwe/mod.rs:1223). These helpers gather the encoder fields
# once and do all arithmetic as numpy array ops.


@dataclasses.dataclass(frozen=True)
class EncoderFields:
    """Field arrays for a list of encoders (all shape [len(encoders)])."""

    o: np.ndarray          # f64
    delta: np.ndarray      # f64
    precision: np.ndarray  # i64
    padding: np.ndarray    # i64
    round: np.ndarray      # bool
    valid: np.ndarray      # bool

    @classmethod
    def gather(cls, encoders) -> "EncoderFields":
        m = len(encoders)
        o = np.fromiter((e.o for e in encoders), np.float64, m)
        delta = np.fromiter((e.delta for e in encoders), np.float64, m)
        prec = np.fromiter((e.nb_bit_precision for e in encoders), np.int64, m)
        pad = np.fromiter((e.nb_bit_padding for e in encoders), np.int64, m)
        rnd = np.fromiter((e.round for e in encoders), bool, m)
        return cls(o, delta, prec, pad, rnd, (prec > 0) & (delta > 0))

    def granularity(self) -> np.ndarray:
        return np.where(self.valid, self.delta, 0.0) / np.exp2(
            self.precision.astype(np.float64))


def _closest_representable_varbits(x: np.ndarray, base_log: np.ndarray):
    """_closest_representable_array with a per-element base_log."""
    non_rep = (DTYPE(BITS) - base_log.astype(DTYPE)) % DTYPE(BITS)
    safe = np.maximum(non_rep, DTYPE(1))
    msb = (x >> (safe - DTYPE(1))) & DTYPE(1)
    with np.errstate(over="ignore"):
        snapped = ((x >> safe) + msb) << safe
    return np.where(non_rep == 0, x, snapped)


def encode_bulk(f: EncoderFields, messages: np.ndarray) -> np.ndarray:
    """Vectorized Encoder.encode_outside_interval over an encoder list:
    u64 torus values, 0 at invalid slots."""
    msgs = np.asarray(messages, dtype=np.float64)
    ratio = np.where(f.valid, msgs - f.o, 0.0) / np.where(f.valid, f.delta, 1.0)
    res = from_torus_f64(ratio, BITS)
    if f.round.any():
        res = np.where(
            f.round & f.valid, _closest_representable_varbits(res, f.precision), res)
    res = res >> f.padding.astype(DTYPE)
    return np.where(f.valid, res, DTYPE(0))


def opposite_correction_bulk(f: EncoderFields) -> np.ndarray:
    """Vectorized lwe._opposite_correction: (1 << (B-pad)) - (1 << (B-pad-prec)),
    wrapping for pad == 0; zero at invalid slots."""
    with np.errstate(over="ignore"):
        hi_shift = np.clip(BITS - f.padding, 0, BITS - 1).astype(DTYPE)
        hi = np.where(f.padding > 0, DTYPE(1) << hi_shift, DTYPE(0))
        lo_shift = np.clip(BITS - (f.padding + f.precision), 0, BITS - 1
                           ).astype(DTYPE)
        lo = DTYPE(1) << lo_shift
        return np.where(f.valid, hi - lo, DTYPE(0))


def update_precision_bulk(encoders, variances: np.ndarray) -> None:
    """Vectorized Encoder.update_precision_from_variance over a list: shrink
    each VALID encoder's precision by the noise-bit overlap, in place."""
    f = EncoderFields.gather(encoders)
    std = np.sqrt(np.maximum(np.asarray(variances, np.float64), 0.0))
    modular = np.maximum(std * 2.0 ** BITS, 1e-300)
    tmp = np.log2(modular * 4.0)
    nb_noise = np.where(tmp < 0.0, 0, np.ceil(tmp).astype(np.int64))
    if np.any(f.valid & (nb_noise == 0)):
        bad = np.nonzero(f.valid & (nb_noise == 0))[0][0]
        raise errors.NoNoiseInCiphertext(float(variances[bad]))
    overlap = np.maximum(nb_noise + f.precision + f.padding - BITS, 0)
    new_prec = np.maximum(f.precision - overlap, 0)
    for i in np.nonzero(f.valid & (overlap > 0))[0]:
        encoders[i].nb_bit_precision = int(new_prec[i])
