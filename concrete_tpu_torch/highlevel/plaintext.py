"""Plaintext: a list of raw torus values with per-value encoders.

Mirrors concrete/src/plaintext/mod.rs (the published API's plaintext
container): holds `plaintexts` (u64 torus values) alongside one Encoder per
value, with encode/decode helpers. Used by `VectorLWE.encrypt` to carry
pre-encoded messages. A copy of concrete_tpu/highlevel/plaintext.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import errors
from .encoder import DTYPE, Encoder


@dataclasses.dataclass
class Plaintext:
    """plaintexts: [m] u64 torus values; encoders: list of m Encoder
    (plaintext/mod.rs:18)."""

    plaintexts: np.ndarray
    encoders: list

    @property
    def nb_plaintexts(self) -> int:
        return int(self.plaintexts.shape[0])

    @classmethod
    def zero(cls, nb_plaintexts: int) -> "Plaintext":
        """All-zero plaintexts with invalid (zero) encoders
        (plaintext/mod.rs:36).

        >>> from concrete_tpu_torch.highlevel import Plaintext
        >>> Plaintext.zero(3).nb_plaintexts
        3
        """
        return cls(
            plaintexts=np.zeros(nb_plaintexts, dtype=DTYPE),
            encoders=[Encoder.zero() for _ in range(nb_plaintexts)],
        )

    @classmethod
    def encode(cls, messages, encoder: Encoder) -> "Plaintext":
        """Encode reals under one (copied) encoder (plaintext/mod.rs:66).

        >>> from concrete_tpu_torch.highlevel import Encoder, Plaintext
        >>> e = Encoder.new(0.0, 10.0, nb_bit_precision=6, nb_bit_padding=1)
        >>> p = Plaintext.encode([1.0, 4.0], e)
        >>> [float(round(x, 1)) for x in p.decode()]
        [1.0, 4.0]
        """
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        pts = encoder.encode_core(msgs)
        return cls(
            plaintexts=np.asarray(pts, dtype=DTYPE).reshape(msgs.shape),
            encoders=[encoder.copy() for _ in msgs],
        )

    def encode_inplace(self, messages) -> None:
        """Re-encode messages with the stored encoders (plaintext/mod.rs:126)."""
        msgs = np.asarray(messages, dtype=np.float64).ravel()
        if msgs.size != self.nb_plaintexts:
            raise errors.DimensionError(msgs.size, self.nb_plaintexts)
        for i, m in enumerate(msgs):
            self.plaintexts[i] = self.encoders[i].encode_core(np.float64(m))

    def decode_nth(self, nth: int) -> float:
        """Decode one value (plaintext/mod.rs:97)."""
        if not 0 <= nth < self.nb_plaintexts:
            raise errors.IndexError_(f"plaintext {nth} out of range")
        return float(self.encoders[nth].decode_core(self.plaintexts[nth]))

    def decode(self) -> np.ndarray:
        """Decode every value (plaintext/mod.rs:161)."""
        return np.array(
            [self.encoders[i].decode_core(self.plaintexts[i])
             for i in range(self.nb_plaintexts)],
            dtype=np.float64,
        )

    def set_encoders(self, encoders) -> None:
        """Replace all encoders (plaintext/mod.rs:186)."""
        if len(encoders) != self.nb_plaintexts:
            raise errors.DimensionError(len(encoders), self.nb_plaintexts)
        self.encoders = [e.copy() for e in encoders]

    def set_encoders_from_one(self, encoder: Encoder) -> None:
        """Broadcast one encoder to every slot (plaintext/mod.rs:209)."""
        self.encoders = [encoder.copy() for _ in range(self.nb_plaintexts)]

    def set_nth_encoder(self, nth: int, encoder: Encoder) -> None:
        """Replace one encoder (plaintext/mod.rs:231)."""
        if not 0 <= nth < self.nb_plaintexts:
            raise errors.IndexError_(f"plaintext {nth} out of range")
        self.encoders[nth] = encoder.copy()

    # -- serialization ------------------------------------------------------

    def save(self, path: str) -> None:
        import json

        np.savez_compressed(
            path,
            plaintexts=self.plaintexts,
            encoders=json.dumps([e.to_json() for e in self.encoders]),
        )

    @classmethod
    def load(cls, path: str) -> "Plaintext":
        import json

        d = np.load(path, allow_pickle=False)
        encs = [Encoder.from_json(s) for s in json.loads(str(d["encoders"]))]
        return cls(plaintexts=d["plaintexts"], encoders=encs)
