"""AES-128-CTR generator with deterministic fork-tree semantics.

Re-implements the reference state machine (concrete-csprng/src/counter/mod.rs):

- ``State`` = (aes_ctr: u128, byte_ctr in [0, 128)); the stream byte at a state
  is byte ``byte_ctr % 16`` of ``AES(aes_ctr + byte_ctr // 16)`` — batches of
  128 bytes are 8 consecutive AES blocks of the little-endian counter
  (counter/mod.rs:106-170, software.rs:76-89).
- ``try_fork(n_child, bytes_per_child)`` carves disjoint counter ranges for the
  children and advances the parent past them (counter/mod.rs:303-383); bounded
  generators refuse to generate past their bound.

Unlike the reference's byte-at-a-time API, the workhorse here is
``generate_bytes(n)`` which produces n stream bytes in one AES sweep of the
native library, bit-identical to n successive ``generate_next`` calls. The
arithmetic is on Python ints: the same state machine as concrete_tpu's
csprng/generator.py, byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

from . import aes

_U128_MASK = (1 << 128) - 1
# Global stream positions live on a 16-bytes-per-counter grid; the position
# wraps together with the u128 AES counter.
_GPOS_MOD = 1 << 132


class State:
    """A position in the AES-CTR stream.

    Stored as the *global byte position* gpos = 16 * aes_ctr + byte_ctr, which
    is invariant under the reference's normalization (counter/mod.rs:92-103)
    and makes shift/compare plain integer arithmetic.
    """

    __slots__ = ("gpos",)

    def __init__(self, aes_ctr: int = 0, byte_ctr: int = 0, *, gpos: int | None = None):
        if gpos is not None:
            self.gpos = gpos % _GPOS_MOD
        else:
            if not 0 <= byte_ctr < 128:
                raise ValueError("byte_ctr must be in [0, 128)")
            self.gpos = (16 * aes_ctr + byte_ctr) % _GPOS_MOD

    @property
    def aes_ctr(self) -> int:
        """Normalized AES counter (counter maximized, byte counter < 16)."""
        return (self.gpos // 16) & _U128_MASK

    @property
    def byte_ctr(self) -> int:
        return self.gpos % 16

    def shifted(self, n_bytes: int) -> "State":
        return State(gpos=self.gpos + n_bytes)

    def __eq__(self, other) -> bool:
        return isinstance(other, State) and self.gpos == other.gpos

    def __le__(self, other: "State") -> bool:
        return self.gpos <= other.gpos

    def __lt__(self, other: "State") -> bool:
        return self.gpos < other.gpos

    def __repr__(self) -> str:
        return f"State(aes_ctr={self.aes_ctr}, byte_ctr={self.byte_ctr})"


def _key_to_bytes(key: int | bytes | None) -> bytes:
    if key is None:
        return os.urandom(16)
    if isinstance(key, int):
        return (key & _U128_MASK).to_bytes(16, "little")
    key = bytes(key)
    if len(key) != 16:
        raise ValueError("AES key must be 16 bytes")
    return key


class AesCtrGenerator:
    """A CSPRNG operating in batch counter mode (counter/mod.rs:224).

    >>> g = AesCtrGenerator(key=1)
    >>> first = g.generate_bytes(8)
    >>> g2 = AesCtrGenerator(key=1)
    >>> (g2.generate_bytes(8) == first).all()          # deterministic
    np.True_
    >>> kids = g.try_fork(2, 16)
    >>> kids[0].remaining_bytes(), kids[1].remaining_bytes()
    (16, 16)
    >>> a = kids[0].generate_bytes(16); b = kids[1].generate_bytes(16)
    >>> (a == b).all()                                  # disjoint streams
    np.False_
    """

    def __init__(
        self,
        key: int | bytes | None = None,
        state: State | None = None,
        bound: State | None = None,
        *,
        _round_keys: np.ndarray | None = None,
    ):
        if _round_keys is not None:
            self.round_keys = _round_keys
        else:
            self.round_keys = aes.key_schedule(_key_to_bytes(key))
        self.state = state if state is not None else State()
        self.bound = bound
        if bound is not None and not self.state <= bound:
            raise ValueError("generator state exceeds its bound")

    # -- introspection ---------------------------------------------------

    def is_bounded(self) -> bool:
        return self.bound is not None

    def remaining_bytes(self) -> int | None:
        """Number of bytes still available, if bounded (counter/mod.rs:270)."""
        if self.bound is None:
            return None
        return self.bound.gpos - self.state.gpos

    # -- generation ------------------------------------------------------

    def generate_bytes(self, n: int) -> np.ndarray:
        """Yield the next ``n`` stream bytes as a u8 array.

        Bit-identical to n successive `generate_next` calls of the reference
        (counter/mod.rs:279-296), but produced by one batched AES sweep.
        """
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        if self.bound is not None and self.state.gpos + n > self.bound.gpos:
            raise RuntimeError("Tried to generate bytes outside the generator bound.")
        start = self.state.gpos
        first_block = start // 16
        n_blocks = (start + n + 15) // 16 - first_block
        # consecutive u128 counters, little-endian (software.rs:76-89 uses
        # to_ne_bytes on x86), through the native library
        out = aes.ctr_fill(self.round_keys, first_block, n_blocks)
        offset = start % 16
        self.state = self.state.shifted(n)
        return out[offset : offset + n]

    def generate_next(self) -> int:
        return int(self.generate_bytes(1)[0])

    # -- forking ---------------------------------------------------------

    def try_fork(self, n_child: int, bytes_per_child: int) -> list["AesCtrGenerator"]:
        """Fork into ``n_child`` bounded children of ``bytes_per_child`` bytes.

        Children get consecutive disjoint stream ranges starting at the parent
        state; the parent advances past them (counter/mod.rs:303-349). Raises
        if the fork would exceed the parent's bound.
        """
        total = n_child * bytes_per_child
        if self.bound is not None and self.state.gpos + total > self.bound.gpos:
            raise RuntimeError("fork exceeds generator bound")
        children = []
        for i in range(n_child):
            child_state = self.state.shifted(i * bytes_per_child)
            child_bound = child_state.shifted(bytes_per_child)
            children.append(
                AesCtrGenerator(
                    state=child_state, bound=child_bound, _round_keys=self.round_keys
                )
            )
        self.state = self.state.shifted(total)
        return children
