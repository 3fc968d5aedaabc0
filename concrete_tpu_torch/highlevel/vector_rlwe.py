"""VectorRLWE: packed RLWE ciphertexts (many messages per polynomial).

Mirrors concrete/src/vector_rlwe/mod.rs (1,573 LoC): encrypt whole message
polynomials (N messages per RLWE) or one message per ciphertext (constant
coefficient only), extract individual coefficients as LWE ciphertexts of
dimension k*N, and the add/mul constant families.

Like the reference, encoders and variances are tracked PER COEFFICIENT
(`nb_ciphertexts * polynomial_size` of each); empty slots carry the invalid
zero encoder and are skipped by decryption (`nb_valid`,
vector_rlwe/mod.rs:1488).

The port of concrete_tpu/highlevel/vector_rlwe.py: ciphertexts are host
np.uint64 arrays as there; encryption draws from the AES-CTR streams, so
equal seeds give concrete_tpu's ciphertexts byte for byte, and the GLWE
mask-times-key products run on `device` (GlweSecretKey.encrypt: the CPU
unless a device is named). `save` / `load` keep the JAX npz format.

Example:
    >>> from concrete_tpu_torch.highlevel import VectorRLWE, Encoder, RLWESecretKey, RLWEParams
    >>> sk = RLWESecretKey.new(RLWEParams(polynomial_size=32, dimension=1,
    ...     log2_std_dev=-45), secret_seed=1)
    >>> enc = Encoder.new(0.0, 16.0, nb_bit_precision=5, nb_bit_padding=1)
    >>> v = VectorRLWE.encode_encrypt_packed(sk, [1.0, 2.0, 3.0], enc,
    ...     mask_seed=2, noise_seed=3)
    >>> v.nb_valid(), [round(x) for x in v.decrypt_decode(sk)]
    (3, [1, 2, 3])
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..csprng import EncryptionRandomGenerator
from ..torus import from_torus_f64
from . import errors
from .encoder import (
    BITS,
    DTYPE,
    Encoder,
    EncoderFields,
    encode_bulk,
    opposite_correction_bulk,
    update_precision_bulk,
)
from .keys import RLWESecretKey
from .plaintext import Plaintext
from .vector_lwe import VectorLWE, _deltas_close


@dataclasses.dataclass
class VectorRLWE:
    """data: [m, k+1, N] u64; encoders: list of m*N Encoder (coefficient
    (i, c) at index i*N + c); variances: [m*N]."""

    data: np.ndarray
    encoders: list
    variances: np.ndarray

    @property
    def nb_ciphertexts(self) -> int:
        return self.data.shape[0]

    @property
    def dimension(self) -> int:
        return self.data.shape[1] - 1

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]

    def get_ciphertext_size(self) -> int:
        """(vector_rlwe/mod.rs:1498)."""
        return (self.dimension + 1) * self.polynomial_size

    def nb_valid(self) -> int:
        """Number of coefficients holding a message (vector_rlwe:1488)."""
        return sum(1 for e in self.encoders if e.is_valid())

    def copy(self) -> "VectorRLWE":
        return VectorRLWE(
            self.data.copy(), [e.copy() for e in self.encoders], self.variances.copy()
        )

    def _enc(self, i: int, c: int) -> Encoder:
        return self.encoders[i * self.polynomial_size + c]

    # -- construction (vector_rlwe/mod.rs:60-480) -------------------------------

    @classmethod
    def zero(cls, polynomial_size: int, dimension: int, nb_ciphertexts: int) -> "VectorRLWE":
        """All-zero ciphertexts with invalid encoders (vector_rlwe:68)."""
        if nb_ciphertexts == 0:
            raise errors.DimensionError(nb_ciphertexts, 1)
        if polynomial_size & (polynomial_size - 1):
            raise errors.DimensionError(polynomial_size, 1 << polynomial_size.bit_length())
        return cls(
            data=np.zeros((nb_ciphertexts, dimension + 1, polynomial_size), dtype=DTYPE),
            encoders=[Encoder.zero() for _ in range(nb_ciphertexts * polynomial_size)],
            variances=np.zeros(nb_ciphertexts * polynomial_size),
        )

    @classmethod
    def encrypt_packed(
        cls,
        sk: RLWESecretKey,
        plaintexts: Plaintext,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        device=None,
    ) -> "VectorRLWE":
        """Encrypt pre-encoded Plaintexts N-per-ciphertext, copying their
        per-value encoders (vector_rlwe:130)."""
        n = sk.polynomial_size
        m = int(np.ceil(plaintexts.nb_plaintexts / n))
        out = cls.zero(n, sk.dimension, m)
        padded = np.zeros(m * n, dtype=DTYPE)
        padded[: plaintexts.nb_plaintexts] = plaintexts.plaintexts
        for i, e in enumerate(plaintexts.encoders):
            enc = e.copy()
            if enc.is_valid():
                enc.update_precision_from_variance(sk.variance)
            out.encoders[i] = enc
        out.encrypt_packed_raw(sk, padded, mask_seed=mask_seed,
                               noise_seed=noise_seed, device=device)
        return out

    @classmethod
    def encode_encrypt_packed(
        cls,
        sk: RLWESecretKey,
        messages,
        encoder: Encoder,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        device=None,
    ) -> "VectorRLWE":
        """Pack reals N-per-ciphertext and encrypt (:208)."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        pts = np.asarray(encoder.encode_core(msgs), dtype=DTYPE)
        n = sk.polynomial_size
        m = int(np.ceil(msgs.size / n))
        out = cls.zero(n, sk.dimension, m)
        padded = np.zeros(m * n, dtype=DTYPE)
        padded[: msgs.size] = pts.ravel()
        for i in range(msgs.size):
            enc = encoder.copy()
            enc.update_precision_from_variance(sk.variance)
            out.encoders[i] = enc
        out.encrypt_packed_raw(sk, padded, mask_seed=mask_seed,
                               noise_seed=noise_seed, device=device)
        return out

    @classmethod
    def encrypt(
        cls,
        sk: RLWESecretKey,
        plaintexts: Plaintext,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        device=None,
    ) -> "VectorRLWE":
        """One RLWE per plaintext, message in the constant coefficient only
        (vector_rlwe:287)."""
        m = plaintexts.nb_plaintexts
        n = sk.polynomial_size
        out = cls.zero(n, sk.dimension, m)
        padded = np.zeros(m * n, dtype=DTYPE)
        padded[::n] = plaintexts.plaintexts
        for i, e in enumerate(plaintexts.encoders):
            enc = e.copy()
            if enc.is_valid():
                enc.update_precision_from_variance(sk.variance)
            out.encoders[i * n] = enc
        out.encrypt_packed_raw(sk, padded, mask_seed=mask_seed,
                               noise_seed=noise_seed, device=device)
        return out

    @classmethod
    def encode_encrypt(
        cls,
        sk: RLWESecretKey,
        messages,
        encoder: Encoder,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        device=None,
    ) -> "VectorRLWE":
        """One RLWE per message, encoded into the constant coefficient
        (vector_rlwe:365)."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        pts = np.asarray(encoder.encode_core(msgs), dtype=DTYPE).ravel()
        pt = Plaintext(plaintexts=pts, encoders=[encoder.copy() for _ in msgs])
        return cls.encrypt(sk, pt, mask_seed=mask_seed, noise_seed=noise_seed,
                           device=device)

    def encrypt_packed_raw(
        self,
        sk: RLWESecretKey,
        plaintexts,
        *,
        mask_seed: int | None = None,
        noise_seed: int | None = None,
        device=None,
    ) -> None:
        """Encrypt raw torus coefficients; encoders untouched
        (vector_rlwe:423), the products on `device`. Raises
        NoNoiseInCiphertext for noiseless keys."""
        pts = np.asarray(plaintexts, dtype=DTYPE).ravel()
        if pts.size % self.polynomial_size:
            raise errors.DimensionError(pts.size, self.polynomial_size)
        if sk.std_dev < 2.0 ** (-BITS + 2):
            raise errors.NoNoiseInCiphertext(sk.variance)
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        self.data = np.asarray(
            sk.inner.encrypt(
                pts.reshape(-1, self.polynomial_size), sk.std_dev, gen, device
            ),
            dtype=DTYPE,
        )
        self.variances = np.full(self.nb_ciphertexts * self.polynomial_size, sk.variance)

    # -- decryption ---------------------------------------------------------------

    def _phases(self, sk: RLWESecretKey) -> np.ndarray:
        if sk.polynomial_size != self.polynomial_size:
            raise errors.DimensionError(sk.polynomial_size, self.polynomial_size)
        if sk.dimension != self.dimension:
            raise errors.DimensionError(sk.dimension, self.dimension)
        return np.asarray(sk.inner.decrypt(self.data), dtype=DTYPE).reshape(-1)

    def decrypt_decode(self, sk: RLWESecretKey) -> np.ndarray:
        """Decode every VALID coefficient, in order (vector_rlwe:482)."""
        phase = self._phases(sk)
        return np.array(
            [e.decode_core(phase[i]) for i, e in enumerate(self.encoders) if e.is_valid()],
            dtype=np.float64,
        )

    def decrypt_decode_round(self, sk: RLWESecretKey) -> np.ndarray:
        """(vector_rlwe:546)."""
        phase = self._phases(sk)
        outs = []
        for i, e in enumerate(self.encoders):
            if e.is_valid():
                enc = e.copy()
                enc.round = True
                outs.append(enc.decode_core(phase[i]))
        return np.array(outs, dtype=np.float64)

    def decrypt_with_encoders(self, sk: RLWESecretKey):
        """(messages, encoders) for the valid coefficients (vector_rlwe:618)."""
        msgs = self.decrypt_decode(sk)
        encs = [e.copy() for e in self.encoders if e.is_valid()]
        return msgs, encs

    # -- coefficient extraction (vector_rlwe:671) -----------------------------------

    def extract_1_lwe(self, n_coeff: int, n_ciphertext: int) -> VectorLWE:
        """LWE(dim k*N) of coefficient `n_coeff` of ciphertext `n_ciphertext`."""
        return self.extract_bunch_of_lwes([n_coeff], n_ciphertext)

    def extract_bunch_of_lwes(self, coeffs, n_ciphertext: int) -> VectorLWE:
        """LWEs (dim k*N) of the coefficients `coeffs` of one ciphertext, in
        order, all in one gather: the mask of coefficient c is the mask
        polynomials' coefficients c, c-1, ..., 0, then -(N-1), ..., -(c+1)
        (each polynomial reversed, the wrapped part negated), the body its
        coefficient c."""
        if n_ciphertext >= self.nb_ciphertexts:
            raise errors.IndexError_(f"ciphertext {n_ciphertext} out of range")
        coeffs = np.asarray(coeffs, dtype=np.int64).ravel()
        for c in coeffs:
            if c >= self.polynomial_size:
                raise errors.IndexError_(f"coefficient {c} out of range")
        k, n = self.dimension, self.polynomial_size
        ct = self.data[n_ciphertext]
        j = np.arange(n)
        src = (coeffs[:, None] - j[None, :]) % n              # [C, N]
        mask = ct[:k][:, src]                                  # [k, C, N]
        with np.errstate(over="ignore"):
            mask = np.where(j[None, None, :] > coeffs[None, :, None],
                            DTYPE(0) - mask, mask)
        mask = np.moveaxis(mask, 0, 1).reshape(coeffs.size, k * n)
        out = np.concatenate([mask, ct[k, coeffs][:, None]], axis=1)
        idx = n_ciphertext * n + coeffs
        return VectorLWE(
            data=out,
            encoders=[self.encoders[i].copy() for i in idx],
            variances=np.asarray(self.variances)[idx].copy(),
        )

    # -- pairwise ops (vector_rlwe:895-1220) -----------------------------------------

    def _check_pair(self, other: "VectorRLWE", *, padding: bool) -> None:
        if self.dimension != other.dimension:
            raise errors.DimensionError(self.dimension, other.dimension)
        if self.polynomial_size != other.polynomial_size:
            raise errors.DimensionError(self.polynomial_size, other.polynomial_size)
        for e1, e2 in zip(self.encoders, other.encoders):
            if e1.is_valid() and e2.is_valid():
                if padding:
                    if e1.nb_bit_padding != e2.nb_bit_padding:
                        raise errors.PaddingError(e1.nb_bit_padding, e2.nb_bit_padding)
                    if e1.nb_bit_padding == 0:
                        raise errors.NotEnoughPaddingError(0, 1)
                if not _deltas_close(e1.delta, e2.delta):
                    raise errors.DeltaError(e1.delta, e2.delta)

    def add_centered(self, other: "VectorRLWE") -> "VectorRLWE":
        """Per-coefficient centered addition (vector_rlwe:895)."""
        self._check_pair(other, padding=False)
        out = self.copy()
        out.data = self.data + other.data
        n = self.polynomial_size
        out.variances = self.variances + other.variances
        for idx, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            i, c = divmod(idx, n)
            if e1.is_valid() and e2.is_valid():
                tmp = e1.copy()
                tmp.o = 0.0
                correction = tmp.encode_core(np.float64(e1.delta / 2.0))
                out.data[i, -1, c] -= correction
                e1.o += e2.o + e1.delta / 2.0
                e1.update_precision_from_variance(float(out.variances[idx]))
            elif not e1.is_valid() and e2.is_valid():
                out.encoders[idx] = e2.copy()
                out.encoders[idx].update_precision_from_variance(
                    float(out.variances[idx])
                )
        return out

    def add_with_padding(self, other: "VectorRLWE") -> "VectorRLWE":
        """Per-coefficient add consuming one padding bit (vector_rlwe:1000)."""
        self._check_pair(other, padding=True)
        out = self.copy()
        out.data = self.data + other.data
        out.variances = self.variances + other.variances
        for idx, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            if e1.is_valid() and e2.is_valid():
                e1.o += e2.o
                e1.delta *= 2.0
                e1.nb_bit_padding -= 1
            elif not e1.is_valid() and e2.is_valid():
                out.encoders[idx] = e2.copy()
            if out.encoders[idx].is_valid():
                out.encoders[idx].update_precision_from_variance(
                    float(out.variances[idx])
                )
        return out

    def sub_with_padding(self, other: "VectorRLWE") -> "VectorRLWE":
        """Per-coefficient subtract consuming one padding bit
        (vector_rlwe:1104)."""
        self._check_pair(other, padding=True)
        out = self.copy()
        out.data = self.data - other.data
        n = self.polynomial_size
        for idx, (e1, e2) in enumerate(zip(self.encoders, other.encoders)):
            if e1.is_valid() and e2.is_valid():
                i, c = divmod(idx, n)
                correction = DTYPE(1) << DTYPE(BITS - e1.nb_bit_padding)
                out.data[i, -1, c] += correction
        out.variances = self.variances + other.variances
        for idx, (e1, e2) in enumerate(zip(out.encoders, other.encoders)):
            if e1.is_valid() and e2.is_valid():
                e1.o -= e2.o + e2.delta
                e1.delta *= 2.0
                e1.nb_bit_padding -= 1
            elif not e1.is_valid() and e2.is_valid():
                out.encoders[idx] = e2.copy()
            if out.encoders[idx].is_valid():
                out.encoders[idx].update_precision_from_variance(
                    float(out.variances[idx])
                )
        return out

    # -- constant families (vector_rlwe:763-1480) --------------------------------------

    def add_constant_static_encoder(self, messages) -> "VectorRLWE":
        """Add constants to the VALID coefficients, same encoders
        (vector_rlwe:763): `messages` has nb_valid entries."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        if msgs.size != self.nb_valid():
            raise errors.DimensionError(msgs.size, self.nb_valid())
        out = self.copy()
        n = self.polynomial_size
        # vectorized over all m*N coefficient slots (struct-of-arrays gather)
        f = EncoderFields.gather(self.encoders)
        m_full = np.zeros(len(self.encoders), np.float64)
        m_full[f.valid] = msgs
        ratio = m_full / np.where(f.valid, f.delta, 1.0)
        corr = from_torus_f64(ratio, BITS) >> f.padding.astype(DTYPE)
        with np.errstate(over="ignore"):
            out.data[:, -1, :] += np.where(f.valid, corr, DTYPE(0)).reshape(-1, n)
        return out

    def add_constant_dynamic_encoder(self, messages) -> "VectorRLWE":
        """Shift the valid encoders' intervals (vector_rlwe:845)."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        if msgs.size != self.nb_valid():
            raise errors.DimensionError(msgs.size, self.nb_valid())
        out = self.copy()
        j = 0
        for enc in out.encoders:
            if enc.is_valid():
                enc.o += float(msgs[j])
                j += 1
        return out

    def mul_constant_static_encoder(self, messages) -> "VectorRLWE":
        """Multiply each ciphertext by a small integer (vector_rlwe:1223):
        one constant per CIPHERTEXT. All coefficient arithmetic (encoded-zero
        corrections, NPE variance updates, precision shrink) rides [m, N]
        arrays — no per-coefficient Python loop."""
        c = np.broadcast_to(
            np.asarray(messages, dtype=np.int64), (self.nb_ciphertexts,)
        )
        out = self.copy()
        n = self.polynomial_size
        f = EncoderFields.gather(out.encoders)
        zero = encode_bulk(f, 0.0).reshape(-1, n)      # 0 at invalid slots
        cmod = c.astype(DTYPE)  # two's-complement wrap == mod 2^64
        with np.errstate(over="ignore"):
            out.data[:, -1, :] -= zero
            out.data *= cmod[:, None, None]
            out.data[:, -1, :] += zero
        # Var(n * ct) = n^2 * Var (operators.rs:75), broadcast per ciphertext
        out.variances = (
            self.variances.reshape(-1, n)
            * np.abs(c.astype(np.float64))[:, None] ** 2
        ).ravel()
        update_precision_bulk(out.encoders, out.variances)
        return out

    def mul_constant_with_padding(
        self, constants, max_constant: float, nb_bit_padding: int
    ) -> "VectorRLWE":
        """Real-constant multiply consuming padding, one constant per
        CIPHERTEXT (vector_rlwe:1284)."""
        c = np.asarray(constants, dtype=np.float64).ravel()
        if c.size != self.nb_ciphertexts:
            raise errors.DimensionError(c.size, self.nb_ciphertexts)
        for x in c:
            if abs(x) > max_constant:
                raise errors.ConstantMaximumError(float(x), max_constant)
        for enc in self.encoders:
            if enc.is_valid():
                if enc.o > 0.0 or enc.o + enc.delta < 0.0:
                    raise errors.ZeroInIntervalError(enc.o, enc.delta)
                if enc.nb_bit_padding < nb_bit_padding:
                    raise errors.NotEnoughPaddingError(enc.nb_bit_padding, nb_bit_padding)
        out = self.copy()
        n = self.polynomial_size
        # ---- vectorized over all m*N coefficient slots ----
        negative = c < 0.0
        c_abs = np.abs(c)
        scal = np.round(c_abs / max_constant * 2.0 ** nb_bit_padding
                        ).astype(np.int64)
        discret_c_abs = scal.astype(np.float64) * 2.0 ** (-nb_bit_padding) * max_constant
        rounding_error = np.abs(discret_c_abs - c_abs)

        f = EncoderFields.gather(out.encoders)
        # pre-mul: subtract encoded zero (encode_core(0.0); the
        # zero-in-interval pre-check above guarantees 0 >= o, and 0 == o+delta
        # only at the degenerate upper edge the scalar path also rejects)
        if np.any(f.valid & (f.o + f.delta == 0.0)):
            bad = np.nonzero(f.valid & (f.o + f.delta == 0.0))[0][0]
            raise errors.MessageOutsideIntervalError(
                0.0, float(f.o[bad]), float(f.delta[bad]))
        zero = encode_bulk(f, 0.0).reshape(-1, n)
        with np.errstate(over="ignore"):
            out.data[:, -1, :] -= zero
            out.data *= scal.astype(DTYPE)[:, None, None]

        # per-slot broadcast of the per-ciphertext constants
        re_s = np.repeat(rounding_error, n)
        dc_s = np.repeat(discret_c_abs, n)
        gran = f.granularity()
        new_o = f.o * max_constant
        new_max = (f.o + f.delta - gran) * max_constant
        new_delta = new_max - new_o
        mx = np.maximum(np.abs(f.o + f.delta - gran), np.abs(f.o))
        new_gran = 2.0 * np.abs(
            gran * re_s / 2.0 + gran / 2.0 * dc_s + re_s * mx)
        with np.errstate(divide="ignore", invalid="ignore"):
            new_prec = np.minimum(
                np.floor(np.log2(np.where(
                    f.valid, new_delta, 1.0) / np.maximum(new_gran, 1e-300))),
                f.precision.astype(np.float64))
        new_prec = np.maximum(np.nan_to_num(new_prec, nan=1.0,
                                            posinf=1.0, neginf=1.0), 1.0
                              ).astype(np.int64)
        new_pad = f.padding - nb_bit_padding
        out.encoders = [
            Encoder(o=float(new_o[j]), delta=float(new_delta[j]),
                    nb_bit_precision=int(new_prec[j]),
                    nb_bit_padding=int(new_pad[j]), round=bool(f.round[j]))
            if f.valid[j] else out.encoders[j]
            for j in range(len(out.encoders))
        ]
        nf = EncoderFields.gather(out.encoders)
        nf = dataclasses.replace(nf, valid=nf.valid & f.valid)
        # post-mul: add the NEW encoders' encoded zero (encode_core semantics:
        # 0 must lie inside the new interval)
        if np.any(nf.valid & ((new_o > 0.0) | (new_o + new_delta <= 0.0))):
            bad = np.nonzero(nf.valid & ((new_o > 0.0)
                                         | (new_o + new_delta <= 0.0)))[0][0]
            raise errors.MessageOutsideIntervalError(
                0.0, float(new_o[bad]), float(new_delta[bad]))
        with np.errstate(over="ignore"):
            out.data[:, -1, :] += encode_bulk(nf, 0.0).reshape(-1, n)
        # Var(scal * ct), broadcast per ciphertext (operators.rs:75)
        out.variances = (
            self.variances.reshape(-1, n)
            * (scal.astype(np.float64) ** 2)[:, None]
        ).ravel()
        update_precision_bulk(out.encoders, out.variances)

        if negative.any():
            # negate whole ciphertexts with negative constants (opposite per
            # slot incl. the body correction — lwe/mod.rs:1550-1563)
            nf2 = EncoderFields.gather(out.encoders)
            nf2 = dataclasses.replace(
                nf2, valid=nf2.valid & np.repeat(negative, n))
            with np.errstate(over="ignore"):
                neg_data = (np.zeros_like(out.data) - out.data).astype(DTYPE)
                neg_data[:, -1, :] += opposite_correction_bulk(nf2
                                                               ).reshape(-1, n)
            out.data = np.where(negative[:, None, None], neg_data, out.data)
            for j in np.nonzero(nf2.valid)[0]:
                out.encoders[j] = out.encoders[j].opposite()
        return out

    # -- serialization -------------------------------------------------------------

    def save(self, path: str):
        import json

        np.savez_compressed(
            path,
            data=self.data,
            variances=self.variances,
            encoders=json.dumps([e.to_json() for e in self.encoders]),
        )

    @classmethod
    def load(cls, path: str) -> "VectorRLWE":
        import json

        d = np.load(path, allow_pickle=False)
        encs = [Encoder.from_json(s) for s in json.loads(str(d["encoders"]))]
        return cls(data=d["data"], encoders=encs, variances=d["variances"])
