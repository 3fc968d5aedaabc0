"""VectorLWE: a vector of LWE ciphertexts with per-slot encoders.

Mirrors concrete/src/vector_lwe/mod.rs (2,548 LoC): the same operation set as
LWE, batched over `nb_ciphertexts` slots each carrying its own Encoder and
variance, plus vector-only operations (sum_with_padding, sum_with_new_min,
per-slot bootstrap). The slot axis is just another batch axis:
ciphertext arithmetic is one vectorized array op; only the (cheap, float)
encoder bookkeeping iterates per slot.

Under a torch.profiler session the batched bootstrap and the keyswitch are
spans (ops/graphs.span): `highlevel.bootstrap` holds `highlevel.lut` (the
encoder check, the test polynomial, the padding shift), the device call and
`highlevel.to_host` (the result to numpy, the wait for the device
included), and `highlevel.slots` (the per-slot encoders and variances);
`highlevel.keyswitch` holds its device call, `highlevel.to_host` and
`highlevel.slots` (the copy and the per-slot noise estimates).

Example:
    >>> from concrete_tpu_torch.highlevel import VectorLWE, Encoder, LWESecretKey, LWEParams
    >>> sk = LWESecretKey.new(LWEParams(dimension=32, log2_std_dev=-40), secret_seed=1)
    >>> enc = Encoder.new(0.0, 10.0, nb_bit_precision=6, nb_bit_padding=1)
    >>> v = VectorLWE.encode_encrypt(sk, [2.0, 8.0], enc, mask_seed=2, noise_seed=3)
    >>> [round(x) for x in v.decrypt_decode(sk)]
    [2, 8]
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import npe
from ..csprng import EncryptionRandomGenerator
from ..dispersion import Variance
from ..ops import graphs
from ..torus import to_numpy
from . import errors
from .encoder import BITS, DTYPE, Encoder
from .keys import LWEBSK, LWEKSK, LWESecretKey
from .lwe import LWE, _accumulator, generate_functional_lut
from .plaintext import Plaintext


@dataclasses.dataclass
class VectorLWE:
    """data: [m, n+1] u64; encoders: list of m Encoder; variances: [m]."""

    data: np.ndarray
    encoders: list
    variances: np.ndarray

    # -- constructors ---------------------------------------------------------

    @classmethod
    def zero(cls, dimension: int, nb_ciphertexts: int) -> "VectorLWE":
        """Trivial zeros with invalid encoders (vector_lwe/mod.rs:71)."""
        return cls(
            data=np.zeros((nb_ciphertexts, dimension + 1), dtype=DTYPE),
            encoders=[Encoder.zero() for _ in range(nb_ciphertexts)],
            variances=np.zeros(nb_ciphertexts),
        )

    @classmethod
    def encode_encrypt(
        cls,
        sk: LWESecretKey,
        messages,
        encoder: Encoder,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> "VectorLWE":
        """Encrypt a vector of reals under one (copied) encoder
        (vector_lwe/mod.rs encode_encrypt)."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        pts = encoder.encode_core(msgs)
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        data = sk.inner.encrypt(pts, sk.std_dev, gen)
        encs = [encoder.copy() for _ in msgs]
        for e in encs:
            e.update_precision_from_variance(sk.variance)
        return cls(data=data, encoders=encs, variances=np.full(len(msgs), sk.variance))

    @classmethod
    def encode_encrypt_several_encoders(
        cls,
        sk: LWESecretKey,
        messages,
        encoders,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> "VectorLWE":
        """Encrypt with one encoder PER message (vector_lwe/mod.rs:332)."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        if len(encoders) != msgs.size:
            raise errors.DimensionError(len(encoders), msgs.size)
        pts = np.array(
            [encoders[i].encode_core(np.float64(m)) for i, m in enumerate(msgs)],
            dtype=DTYPE,
        )
        out = cls.zero(sk.dimension, msgs.size)
        out.encoders = [e.copy() for e in encoders]
        for e in out.encoders:
            e.update_precision_from_variance(sk.variance)
        out.encrypt_raw_inplace(sk, pts, mask_seed=mask_seed, noise_seed=noise_seed)
        return out

    @classmethod
    def encrypt(
        cls,
        sk: LWESecretKey,
        plaintexts: Plaintext,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> "VectorLWE":
        """Encrypt pre-encoded Plaintexts, copying their encoders
        (vector_lwe/mod.rs:229)."""
        out = cls.zero(sk.dimension, plaintexts.nb_plaintexts)
        out.encrypt_inplace(sk, plaintexts, mask_seed=mask_seed, noise_seed=noise_seed)
        return out

    def encrypt_inplace(
        self,
        sk: LWESecretKey,
        plaintexts: Plaintext,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> None:
        """(vector_lwe/mod.rs:403)."""
        self.encrypt_raw_inplace(
            sk, plaintexts.plaintexts, mask_seed=mask_seed, noise_seed=noise_seed
        )
        self.encoders = [e.copy() for e in plaintexts.encoders]
        for e in self.encoders:
            if e.is_valid():
                e.update_precision_from_variance(sk.variance)

    def encrypt_raw_inplace(
        self,
        sk: LWESecretKey,
        plaintexts,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
    ) -> None:
        """Encrypt raw torus values; encoders untouched (vector_lwe/mod.rs:454
        encrypt_raw). Raises NoNoiseInCiphertext for noiseless keys."""
        if sk.std_dev < 2.0 ** (-BITS + 2):
            raise errors.NoNoiseInCiphertext(sk.variance)
        pts = np.asarray(plaintexts, dtype=DTYPE).ravel()
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        self.data = sk.inner.encrypt(pts, sk.std_dev, gen)
        self.variances = np.full(pts.size, sk.variance)

    @classmethod
    def from_lwes(cls, lwes: list) -> "VectorLWE":
        return cls(
            data=np.stack([l.data for l in lwes]),
            encoders=[l.encoder.copy() for l in lwes],
            variances=np.array([l.variance for l in lwes]),
        )

    @property
    def nb_ciphertexts(self) -> int:
        return self.data.shape[0]

    @property
    def dimension(self) -> int:
        return self.data.shape[-1] - 1

    def get_ciphertext_size(self) -> int:
        """(vector_lwe/mod.rs:2275)."""
        return self.data.shape[-1]

    def copy(self) -> "VectorLWE":
        return VectorLWE(
            self.data.copy(), [e.copy() for e in self.encoders], self.variances.copy()
        )

    def extract_nth(self, n: int) -> LWE:
        """Copy out one slot as a standalone LWE (vector_lwe extract_nth)."""
        return LWE(self.data[n].copy(), self.encoders[n].copy(), float(self.variances[n]))

    def copy_in_nth_nth_inplace(
        self, self_index: int, ct: "VectorLWE", ct_index: int
    ) -> None:
        """Overwrite slot self_index with ct's slot ct_index
        (vector_lwe/mod.rs:115)."""
        if ct.dimension != self.dimension:
            raise errors.DimensionError(self.dimension, ct.dimension)
        if not 0 <= self_index < self.nb_ciphertexts:
            raise errors.IndexError_(f"slot {self_index} out of range")
        if not 0 <= ct_index < ct.nb_ciphertexts:
            raise errors.IndexError_(f"slot {ct_index} out of range")
        self.data[self_index] = ct.data[ct_index]
        self.variances[self_index] = ct.variances[ct_index]
        self.encoders[self_index] = ct.encoders[ct_index].copy()

    # -- decryption -------------------------------------------------------------

    def decrypt_decode(self, sk: LWESecretKey) -> np.ndarray:
        phase = sk.inner.decrypt(self.data)
        return np.array(
            [self.encoders[i].decode_core(phase[i]) for i in range(self.nb_ciphertexts)]
        )

    def decrypt_decode_round(self, sk: LWESecretKey) -> np.ndarray:
        """(vector_lwe/mod.rs:611)."""
        phase = sk.inner.decrypt(self.data)
        outs = []
        for i in range(self.nb_ciphertexts):
            e = self.encoders[i].copy()
            e.round = True
            outs.append(e.decode_core(phase[i]))
        return np.array(outs)

    def decrypt_raw(self, sk: LWESecretKey) -> np.ndarray:
        """Raw phases, no decode (vector_lwe/mod.rs:565)."""
        if sk.dimension != self.dimension:
            raise errors.DimensionError(self.dimension, sk.dimension)
        return np.asarray(sk.inner.decrypt(self.data), dtype=DTYPE)

    # -- pairwise checks ----------------------------------------------------------

    def _check_pair(self, other: "VectorLWE", *, padding: bool) -> None:
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        if self.nb_ciphertexts != other.nb_ciphertexts:
            raise errors.DimensionError(self.nb_ciphertexts, other.nb_ciphertexts)
        for e1, e2 in zip(self.encoders, other.encoders):
            if padding:
                if e1.nb_bit_padding != e2.nb_bit_padding:
                    raise errors.PaddingError(e1.nb_bit_padding, e2.nb_bit_padding)
                if e1.nb_bit_padding == 0:
                    raise errors.NotEnoughPaddingError(0, 1)
            if not _deltas_close(e1.delta, e2.delta):
                raise errors.DeltaError(e1.delta, e2.delta)

    # -- elementwise ops (one vectorized array op + per-slot encoder updates) ------

    def add_with_padding(self, other: "VectorLWE") -> "VectorLWE":
        """Per-slot add_with_padding (vector_lwe/mod.rs:1141), data path
        vectorized across slots."""
        self._check_pair(other, padding=True)
        out = self.copy()
        out.data = self.data + other.data
        out.variances = self.variances + other.variances
        for i, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            e1.o += e2.o
            e1.delta *= 2.0
            e1.nb_bit_padding -= 1
            e1.nb_bit_precision = min(e1.nb_bit_precision, e2.nb_bit_precision)
            e1.update_precision_from_variance(float(out.variances[i]))
        return out

    def sub_with_padding(self, other: "VectorLWE") -> "VectorLWE":
        """Per-slot sub_with_padding (vector_lwe/mod.rs:1269)."""
        self._check_pair(other, padding=True)
        out = self.copy()
        out.data = self.data - other.data
        corrections = np.empty(self.nb_ciphertexts, dtype=DTYPE)
        for i, e1 in enumerate(self.encoders):
            tmp = e1.copy()
            tmp.o = 0.0
            corrections[i] = tmp.encode_core(
                np.float64(e1.delta - e1.get_granularity())
            )
        out.data[:, -1] += corrections
        out.variances = self.variances + other.variances
        for i, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            e1.o -= e2.o + e2.delta - e2.get_granularity()
            e1.delta *= 2.0
            e1.nb_bit_padding -= 1
            e1.nb_bit_precision = min(e1.nb_bit_precision, e2.nb_bit_precision)
            e1.update_precision_from_variance(float(out.variances[i]))
        return out

    def add_centered(self, other: "VectorLWE") -> "VectorLWE":
        """Per-slot add_centered (vector_lwe/mod.rs:1005)."""
        self._check_pair(other, padding=False)
        out = self.copy()
        out.data = self.data + other.data
        corrections = np.empty(self.nb_ciphertexts, dtype=DTYPE)
        for i, e1 in enumerate(self.encoders):
            tmp = e1.copy()
            tmp.o = 0.0
            corrections[i] = tmp.encode_core(np.float64(e1.delta / 2.0))
        out.data[:, -1] -= corrections
        out.variances = self.variances + other.variances
        for i, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            e1.o += e2.o + e1.delta / 2.0
            e1.update_precision_from_variance(float(out.variances[i]))
        return out

    def add_with_new_min(self, other: "VectorLWE", new_min) -> "VectorLWE":
        """Per-slot add with explicitly chosen output minimums — new_min is
        one value per slot (vector_lwe/mod.rs:862)."""
        self._check_pair(other, padding=False)
        mins = np.broadcast_to(
            np.asarray(new_min, dtype=np.float64), (self.nb_ciphertexts,)
        )
        out = self.copy()
        out.data = self.data + other.data
        # + encode_{o=new_min}(o1 + o2) outside the interval check
        # (vector_lwe/mod.rs:943-947)
        corrections = np.empty(self.nb_ciphertexts, dtype=DTYPE)
        for i, (e1, e2) in enumerate(zip(self.encoders, other.encoders)):
            tmp = e1.copy()
            tmp.o = float(mins[i])
            corrections[i] = tmp.encode_outside_interval(np.float64(e1.o + e2.o))
        out.data[:, -1] += corrections
        out.variances = self.variances + other.variances
        for i, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            e1.o = float(mins[i])
            e1.nb_bit_precision = min(e1.nb_bit_precision, e2.nb_bit_precision)
            e1.update_precision_from_variance(float(out.variances[i]))
        return out

    def add_constant_static_encoder(self, constants) -> "VectorLWE":
        """(vector_lwe/mod.rs:671); data path vectorized."""
        from ..torus import from_torus_f64

        c = np.broadcast_to(
            np.asarray(constants, dtype=np.float64), (self.nb_ciphertexts,)
        )
        out = self.copy()
        corrections = np.empty(self.nb_ciphertexts, dtype=DTYPE)
        for i, e in enumerate(self.encoders):
            corr = from_torus_f64(np.float64(c[i] / e.delta), BITS)
            if e.nb_bit_padding > 0:
                corr = corr >> DTYPE(e.nb_bit_padding)
            corrections[i] = corr
        out.data[:, -1] += corrections
        return out

    def add_constant_dynamic_encoder(self, constants) -> "VectorLWE":
        c = np.broadcast_to(np.asarray(constants, dtype=np.float64), (self.nb_ciphertexts,))
        out = self.copy()
        for i in range(self.nb_ciphertexts):
            out.encoders[i].o += float(c[i])
        return out

    def mul_constant_static_encoder(self, constants) -> "VectorLWE":
        """(vector_lwe/mod.rs:1408); one vectorized multiply across slots."""
        c = np.broadcast_to(
            np.asarray(constants, dtype=np.int64), (self.nb_ciphertexts,)
        )
        out = self.copy()
        out.data = (self.data * c.astype(np.uint64)[:, None]).astype(DTYPE)
        zero_pts = np.array(
            [e.encode_outside_interval(np.float64(0.0)) for e in self.encoders],
            dtype=DTYPE,
        )
        out.data[:, -1] -= ((c - 1).astype(np.uint64) * zero_pts).astype(DTYPE)
        for i, e in enumerate(out.encoders):
            v = npe.estimate_integer_plaintext_multiplication_noise(
                Variance(float(self.variances[i])), int(abs(c[i]))
            ).get_variance()
            out.variances[i] = v
            e.update_precision_from_variance(v)
        return out

    def mul_constant_with_padding(
        self, constants, max_constant: float, nb_bit_padding: int
    ) -> "VectorLWE":
        """Per-slot real-constant multiply (vector_lwe/mod.rs:1524): the
        ciphertext multiply rides one [m]-shaped array; only the encoder
        bookkeeping iterates."""
        c = np.broadcast_to(
            np.asarray(constants, dtype=np.float64), (self.nb_ciphertexts,)
        )
        for i, e in enumerate(self.encoders):
            if abs(c[i]) > max_constant:
                raise errors.ConstantMaximumError(float(c[i]), max_constant)
            if e.o > 0.0 or e.o + e.delta < 0.0:
                raise errors.ZeroInIntervalError(e.o, e.delta)
            if e.nb_bit_padding < nb_bit_padding:
                raise errors.NotEnoughPaddingError(e.nb_bit_padding, nb_bit_padding)
        negative = c < 0.0
        scal = np.round(np.abs(c) / max_constant * 2.0 ** nb_bit_padding).astype(
            np.int64
        )
        out = self.copy()
        zero_encs = np.array(
            [e.encode_core(np.float64(0.0)) for e in self.encoders], dtype=DTYPE
        )
        out.data[:, -1] -= zero_encs
        out.data = (out.data * scal.astype(np.uint64)[:, None]).astype(DTYPE)
        new_body = np.empty(self.nb_ciphertexts, dtype=DTYPE)
        for i, e in enumerate(self.encoders):
            new_o = e.o * max_constant
            new_max = (e.o + e.delta - e.get_granularity()) * max_constant
            new_delta = new_max - new_o
            discret_c_abs = float(scal[i]) * 2.0 ** (-nb_bit_padding) * max_constant
            rounding_error = abs(discret_c_abs - abs(float(c[i])))
            granularity = e.get_granularity()
            mx = max(abs(e.o + e.delta - granularity), abs(e.o))
            new_granularity = 2.0 * abs(
                granularity * rounding_error / 2.0
                + granularity / 2.0 * discret_c_abs
                + rounding_error * mx
            )
            new_precision = min(
                int(np.floor(np.log2(new_delta / max(new_granularity, 1e-300)))),
                e.nb_bit_precision,
            )
            enc = Encoder(
                o=new_o,
                delta=new_delta,
                nb_bit_precision=max(new_precision, 1),
                nb_bit_padding=e.nb_bit_padding - nb_bit_padding,
                round=e.round,
            )
            new_body[i] = enc.encode_core(np.float64(0.0))
            v = npe.estimate_integer_plaintext_multiplication_noise(
                Variance(float(self.variances[i])), int(scal[i])
            ).get_variance()
            out.variances[i] = v
            enc.update_precision_from_variance(v)
            out.encoders[i] = enc
        out.data[:, -1] += new_body
        if negative.any():
            # negate the slots with negative constants (opposite per slot,
            # incl. the body correction — lwe/mod.rs:1550-1563)
            from .lwe import _opposite_correction

            neg_data = (np.zeros_like(out.data) - out.data).astype(DTYPE)
            for i in np.nonzero(negative)[0]:
                neg_data[i, -1] += _opposite_correction(out.encoders[i])
                out.encoders[i] = out.encoders[i].opposite()
            out.data = np.where(negative[:, None], neg_data, out.data)
        return out

    def opposite_nth(self, n: int) -> "VectorLWE":
        out = self.copy()
        neg = self.extract_nth(n).opposite()
        out.data[n] = neg.data
        out.encoders[n] = neg.encoder
        return out

    # -- reductions (vector_lwe/mod.rs:2370-2521) ----------------------------------

    def sum_with_padding(self) -> LWE:
        """Sum all slots, consuming ceil(log2(m)) padding bits."""
        m = self.nb_ciphertexts
        need = int(np.ceil(np.log2(m))) if m > 1 else 0
        for e in self.encoders:
            if e.nb_bit_padding < need:
                raise errors.NotEnoughPaddingError(e.nb_bit_padding, need)
            if not _deltas_close(e.delta, self.encoders[0].delta):
                raise errors.DeltaError(e.delta, self.encoders[0].delta)
        data = self.data.sum(axis=0, dtype=DTYPE)
        enc = self.encoders[0].copy()
        enc.o = float(sum(e.o for e in self.encoders))
        enc.delta *= 2.0 ** need
        enc.nb_bit_padding -= need
        enc.nb_bit_precision = min(e.nb_bit_precision for e in self.encoders)
        var = float(self.variances.sum())
        enc.update_precision_from_variance(var)
        return LWE(data, enc, var)

    def sum_with_new_min(self, new_min: float) -> LWE:
        """Sum all slots with a chosen output minimum (vector_lwe:2457)."""
        for e in self.encoders:
            if not _deltas_close(e.delta, self.encoders[0].delta):
                raise errors.DeltaError(e.delta, self.encoders[0].delta)
        data = self.data.sum(axis=0, dtype=DTYPE)
        enc = self.encoders[0].copy()
        tmp = enc.copy()
        tmp.o = new_min
        correction = tmp.encode_outside_interval(
            np.float64(sum(e.o for e in self.encoders))
        )
        data[..., -1] += correction
        enc.o = new_min
        enc.nb_bit_precision = min(e.nb_bit_precision for e in self.encoders)
        var = float(self.variances.sum())
        enc.update_precision_from_variance(var)
        return LWE(data, enc, var)

    # -- keyswitch / bootstrap -------------------------------------------------------

    def keyswitch(self, ksk: LWEKSK) -> "VectorLWE":
        with graphs.span("highlevel.keyswitch"):
            out_data = _to_host(ksk.run_keyswitch(self.data))
            with graphs.span("highlevel.slots"):
                out = self.copy()
                out.data = out_data
                for i in range(self.nb_ciphertexts):
                    v = npe.estimate_keyswitch_noise_with_constant_terms(
                        self.dimension,
                        Variance(float(self.variances[i])),
                        Variance(ksk.variance),
                        ksk.base_log,
                        ksk.level,
                        BITS,
                    ).get_variance()
                    out.variances[i] = v
                    out.encoders[i].update_precision_from_variance(v)
            return out

    def bootstrap_nth(self, bsk: LWEBSK, n: int) -> "VectorLWE":
        """Bootstrap slot n with the identity (vector_lwe:1969)."""
        return self.bootstrap_nth_with_function(bsk, lambda x: x, self.encoders[n], n)

    def bootstrap_nth_with_function(
        self, bsk: LWEBSK, f, encoder_output: Encoder, n: int
    ) -> "VectorLWE":
        """Bootstrap slot n through f (vector_lwe:2028)."""
        if not 0 <= n < self.nb_ciphertexts:
            raise errors.IndexError_(f"slot {n} out of range")
        out_lwe = self.extract_nth(n).bootstrap_with_function(bsk, f, encoder_output)
        return VectorLWE.from_lwes([out_lwe])

    def mul_from_bootstrap_nth(
        self, ct: "VectorLWE", bsk: LWEBSK, n_self: int, n_ct: int
    ) -> "VectorLWE":
        """slot[n_self] * ct.slot[n_ct] via two functional bootstraps:
        x*y = ((x+y)^2 - (x-y)^2)/4 (vector_lwe/mod.rs:2225)."""
        ct1 = self.extract_nth(n_self)
        if ct1.encoder.nb_bit_precision < 2:
            raise errors.NotEnoughPaddingError(ct1.encoder.nb_bit_precision, 2)
        out = ct1.mul_from_bootstrap(ct.extract_nth(n_ct), bsk)
        return VectorLWE.from_lwes([out])

    def bootstrap_all_with_function(self, bsk: LWEBSK, f, encoder_output: Encoder) -> "VectorLWE":
        """Batch extension: bootstrap ALL slots in one batched PBS.

        Requires identical input encoders across slots (the common case);
        the whole vector rides one CMux chain as a batch.
        """
        with graphs.span("highlevel.bootstrap"):
            with graphs.span("highlevel.lut"):
                enc0 = self.encoders[0]
                for e in self.encoders:
                    if (not _deltas_close(e.delta, enc0.delta)
                            or e.nb_bit_padding != enc0.nb_bit_padding
                            or e.o != enc0.o):
                        raise errors.DeltaError(e.delta, enc0.delta)
                lut = generate_functional_lut(bsk, enc0, encoder_output, f)
                accumulator = _accumulator(bsk, lut)
                data = self.data
                if enc0.nb_bit_padding > 1:
                    data = (data << DTYPE(enc0.nb_bit_padding - 1)).astype(
                        DTYPE)
            out_data = _to_host(bsk.run_bootstrap(accumulator, data))
            with graphs.span("highlevel.slots"):
                new_var = bsk.bootstrap_output_variance(self.dimension)
                encs = []
                for _ in range(self.nb_ciphertexts):
                    e = encoder_output.copy()
                    e.update_precision_from_variance(new_var)
                    encs.append(e)
                return VectorLWE(out_data, encs,
                                 np.full(self.nb_ciphertexts, new_var))

    # -- serialization ------------------------------------------------------------

    def save(self, path: str):
        import json

        np.savez_compressed(
            path,
            data=self.data,
            variances=self.variances,
            encoders=json.dumps([e.to_json() for e in self.encoders]),
        )

    @classmethod
    def load(cls, path: str) -> "VectorLWE":
        import json

        d = np.load(path, allow_pickle=False)
        encs = [Encoder.from_json(s) for s in json.loads(str(d["encoders"]))]
        return cls(data=d["data"], encoders=encs, variances=d["variances"])


def _to_host(t) -> np.ndarray:
    """A device result as numpy, in the span `highlevel.to_host`: the copy
    and the wait for the device work that makes `t`."""
    with graphs.span("highlevel.to_host"):
        return to_numpy(t)


def _deltas_close(d1: float, d2: float) -> bool:
    return abs(d1 - d2) <= max(abs(d1), abs(d2)) * 2.0 ** -45
