"""Distribution sampling over the AES-CTR stream.

Re-implements the reference's `math/random` layer
(concrete-core/src/backends/core/private/math/random/) with byte-for-byte
identical stream consumption, vectorized:

- uniform integers: little-endian bytes (uniform.rs:8-30);
- binary: one byte per value, LSB (uniform_binary.rs:12);
- ternary: rejection sampling on `byte & 3` (uniform_ternary.rs:12);
- gaussian pairs: Marsaglia polar Box-Muller on two i64 draws scaled by
  2^-63, rejecting unless 0 < s < 1 (gaussian.rs:19-56); torus outputs map
  through `from_torus` (gaussian.rs:58-79).

Rejection loops are vectorized speculatively: we read ahead in the stream,
keep exactly the attempts the sequential algorithm would have consumed, and
rewind the generator state to just past the last consumed byte — giving
bit-identical streams to the reference's sequential sampling.

Example (deterministic under a fixed seed):
    >>> import numpy as np
    >>> from concrete_tpu_torch.csprng.random import RandomGenerator
    >>> a = RandomGenerator(seed=7).random_uniform_array(4, 32)
    >>> b = RandomGenerator(seed=7).random_uniform_array(4, 32)
    >>> bool((a == b).all()) and a.dtype == np.uint32
    True
"""

from __future__ import annotations

import numpy as np

from ..torus import from_torus_f64
from . import aes
from .generator import AesCtrGenerator, State

_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


def _gaussian_attempt_eval(raw: np.ndarray):
    """One Marsaglia-polar attempt per 16 bytes: two little-endian i64 scaled
    by 2^-63 (gaussian.rs:27), accepted iff 0 < u^2+v^2 < 1."""
    ints = raw.reshape(-1, 16).view("<i8")  # [m, 2] little-endian i64
    uv = ints.astype(np.float64) * 2.0 ** -63
    s = uv[:, 0] ** 2 + uv[:, 1] ** 2
    accept = (s > 0.0) & (s < 1.0)
    return accept, uv


def _pairs_to_torus(uv: np.ndarray, std: float, size: int, bits: int):
    """Accepted uv pairs [..., n_pairs, 2] -> interleaved torus noise
    [..., size] (fill_tensor_with_random_gaussian order, generator.rs:558)."""
    s = uv[..., 0] ** 2 + uv[..., 1] ** 2
    cst = std * np.sqrt(-2.0 * np.log(s) / s)
    t1 = from_torus_f64(uv[..., 0] * cst, bits)
    t2 = from_torus_f64(uv[..., 1] * cst, bits)
    out = np.empty(uv.shape[:-2] + (2 * uv.shape[-2],), dtype=_DTYPES[bits])
    out[..., 0::2] = t1
    out[..., 1::2] = t2
    return out[..., :size]


def batch_fill_gaussian_torus(
    gens: list["RandomGenerator"], size: int, std: float, bits: int
) -> np.ndarray:
    """Bit-identical to ``[g.fill_gaussian_torus(size, std, bits) for g in
    gens]`` — including each generator's final stream position — but with
    every generator's speculative attempt window produced by ONE batched AES
    sweep (aes.ctr_fill_batch).

    This is the key-generation hot path: a bootstrap key draws
    n*l*(k+1) independent noise polynomials from budget-spaced forked
    children (csprng/encryption.py); sweeping them together replaces 3,780
    small AES calls with one large one. Rows whose first window doesn't
    yield enough accepted attempts (the sequential sampler's first chunk,
    max(int(n_pairs*1.35)+8, 16) attempts) fall back to the per-generator
    rejection loop for the remainder — chunk sizes depend only on the
    remaining want, so consumption stays byte-identical to the sequential
    sampler's.
    """
    if not gens:
        return np.zeros((0, size), dtype=_DTYPES[bits])
    rks = gens[0].inner.round_keys
    if not all(g.inner.round_keys is rks for g in gens):
        # mixed keys: no shared AES sweep possible
        return np.stack([g.fill_gaussian_torus(size, std, bits) for g in gens])
    n_pairs = (size + 1) // 2
    r = len(gens)
    m = max(int(n_pairs * 1.35) + 8, 16)  # the sequential first-chunk size
    # per-row attempt cap from the generator bound (sequential: m=min(m,avail))
    m_rows = np.full(r, m, dtype=np.int64)
    starts = np.empty(r, dtype=object)
    for i, g in enumerate(gens):
        starts[i] = g.inner.state.gpos
        if g.inner.bound is not None:
            avail = (g.inner.bound.gpos - g.inner.state.gpos) // 16
            if avail < 1:
                raise RuntimeError(
                    "Tried to generate a byte outside the generator bound.")
            m_rows[i] = min(m, avail)
    m_max = int(m_rows.max())
    # one AES sweep over every row's window (rows may start mid-block)
    first_lo = np.array([(s // 16) & 0xFFFFFFFFFFFFFFFF for s in starts],
                        dtype=np.uint64)
    first_hi = np.array([(s // 16) >> 64 for s in starts], dtype=np.uint64)
    offs = np.array([s % 16 for s in starts], dtype=np.int64)
    n_blocks = m_max + (1 if (offs != 0).any() else 0)
    raw = aes.ctr_fill_batch(rks, first_lo, first_hi, n_blocks)
    if (offs != 0).any():
        idx = offs[:, None] + np.arange(m_max * 16, dtype=np.int64)[None, :]
        raw = np.take_along_axis(raw, idx, axis=1)
    else:
        raw = raw[:, : m_max * 16]
    accept, uv = _gaussian_attempt_eval(raw.reshape(-1))
    accept = accept.reshape(r, m_max)
    uv = uv.reshape(r, m_max, 2)
    if (m_rows != m_max).any():
        # mask attempts beyond each row's own window
        accept &= np.arange(m_max)[None, :] < m_rows[:, None]
    cum = accept.cumsum(axis=1, dtype=np.int32)
    got = cum[:, -1]
    out_uv = np.empty((r, n_pairs, 2), dtype=np.float64)
    done = got >= n_pairs
    if done.any():
        # first n_pairs accepted attempts per satisfied row; boolean indexing
        # is row-major, so one flat gather groups selections by row
        sel = accept & (cum <= n_pairs)
        if not done.all():
            sel &= done[:, None]
        out_uv[done] = uv[sel].reshape(-1, n_pairs, 2)
        # consumption ends at the n_pairs-th acceptance (inclusive)
        last = np.argmax(cum >= n_pairs, axis=1)
        for i in np.nonzero(done)[0]:
            gens[i].inner.state = State(
                gpos=int(starts[i]) + (int(last[i]) + 1) * 16)
    for i in np.nonzero(~done)[0]:
        # straggler: whole first chunk consumed (sequential semantics), then
        # continue with the per-generator rejection loop for the remainder
        gens[i].inner.state = State(gpos=int(starts[i]) + int(m_rows[i]) * 16)
        part = uv[i, accept[i]]
        rest = gens[i]._rejection_stream(
            n_pairs - int(got[i]), 16, _gaussian_attempt_eval)
        out_uv[i] = np.concatenate([part, rest], axis=0)
    return _pairs_to_torus(out_uv, std, size, bits)


class RandomGenerator:
    """A CSPRNG with distribution samplers (math/random/generator.rs:52)."""

    def __init__(self, seed: int | None = None, *, _inner: AesCtrGenerator | None = None):
        self.inner = _inner if _inner is not None else AesCtrGenerator(key=seed)

    # -- plumbing ---------------------------------------------------------

    def generate_bytes(self, n: int) -> np.ndarray:
        return self.inner.generate_bytes(n)

    def generate_next(self) -> int:
        return self.inner.generate_next()

    def remaining_bytes(self) -> int | None:
        return self.inner.remaining_bytes()

    def is_bounded(self) -> bool:
        return self.inner.is_bounded()

    def try_fork(self, n_child: int, bytes_per_child: int) -> list["RandomGenerator"]:
        return [
            RandomGenerator(_inner=g) for g in self.inner.try_fork(n_child, bytes_per_child)
        ]

    # -- uniform ----------------------------------------------------------

    def random_uniform_array(self, size: int, bits: int = 32) -> np.ndarray:
        """Uniform unsigned integers, little-endian bytes (uniform.rs)."""
        raw = self.generate_bytes(size * (bits // 8))
        return raw.view(np.dtype(_DTYPES[bits]).newbyteorder("<")).astype(_DTYPES[bits])

    def random_uniform_binary_array(self, size: int, bits: int = 32) -> np.ndarray:
        """One byte per value, keep the LSB (uniform_binary.rs:12)."""
        return (self.generate_bytes(size) & 1).astype(_DTYPES[bits])

    def random_uniform_ternary_array(self, size: int, bits: int = 32) -> np.ndarray:
        """Rejection sampling: byte & 3 in {0,1,2} -> {0,1,-1} (uniform_ternary.rs)."""
        dtype = _DTYPES[bits]

        def attempt_eval(raw: np.ndarray):
            two_bits = raw & 3
            accept = two_bits != 3
            return accept, two_bits

        vals = self._rejection_stream(size, 1, attempt_eval)
        out = vals.astype(dtype)
        out[vals == 2] = dtype((1 << bits) - 1)  # wrapping -1
        return out

    def random_uniform_n_lsb_array(self, size: int, n: int, bits: int = 32) -> np.ndarray:
        full = self.random_uniform_array(size, bits)
        if n >= bits:
            return full
        return full & _DTYPES[bits]((1 << n) - 1) if n > 0 else np.zeros(size, _DTYPES[bits])

    def random_uniform_n_msb_array(self, size: int, n: int, bits: int = 32) -> np.ndarray:
        full = self.random_uniform_array(size, bits)
        if n == 0:
            return np.zeros(size, _DTYPES[bits])
        return full & _DTYPES[bits](~((1 << (bits - n)) - 1) & ((1 << bits) - 1))

    def random_uniform_with_zeros_array(
        self, size: int, prob_zero: float, bits: int = 32
    ) -> np.ndarray:
        """Uniform with probability 1-prob_zero, else zero (uniform_with_zeros.rs).

        Byte consumption is data-dependent (4 coin bytes always, then the
        value bytes only when the coin selects nonzero), so the element
        positions form a sequential chain. Vectorized by reading the
        worst-case byte window speculatively, evaluating the coin at *every*
        candidate offset, and resolving the chain with pointer jumping —
        byte-for-byte identical consumption to the sequential reference.
        """
        if size == 0:
            return np.zeros(0, dtype=_DTYPES[bits])
        vb = bits // 8
        rec = 4 + vb
        start = self.inner.state
        want = size * rec
        if self.inner.bound is not None:
            avail = self.inner.bound.gpos - self.inner.state.gpos
            if avail < want:
                want = int(avail)
        raw = self.inner.generate_bytes(want)
        w = len(raw)
        # coin at every byte offset p (u32 LE), zero-flag per offset
        pad = np.concatenate([raw, np.zeros(rec + 4, np.uint8)])
        coins = (
            pad[0:w].astype(np.uint32)
            | (pad[1:w + 1].astype(np.uint32) << 8)
            | (pad[2:w + 2].astype(np.uint32) << 16)
            | (pad[3:w + 3].astype(np.uint32) << 24)
        )
        is_zero = coins.astype(np.float32) / np.float32(0xFFFFFFFF) < np.float32(
            prob_zero)
        # next-record offset from each candidate offset; clamp into a sink
        sink = w + rec  # any end position > w means "ran past the window"
        nxt = np.minimum(
            np.arange(w, dtype=np.int64) + np.where(is_zero, 4, rec), sink)
        # pointer jumping: positions of records 0..size-1 along the chain.
        # jump holds the 2^k-records-ahead map; after k doublings pos[:2^k]
        # is resolved, so pos[2^k:2^{k+1}] = jump[pos[:2^k]].
        jump = np.full(sink + 1, sink, dtype=np.int64)
        jump[:w] = nxt
        pos = np.zeros(size, dtype=np.int64)
        filled = 1
        while filled < size:
            take = min(filled, size - filled)
            pos[filled:filled + take] = jump[pos[:take]]
            filled += take
            if filled < size:
                jump = jump[jump]
        end = int(nxt[pos[-1]]) if pos[-1] < w else sink
        if end > w:
            # the sequential loop would have stepped past the generator bound
            if self.inner.bound is not None:
                raise RuntimeError(
                    "Tried to generate a byte outside the generator bound.")
            # unbounded: window undersized only if every record was nonzero
            # (want == size*rec covers that), so this cannot happen
            raise AssertionError("speculative window undersized")  # pragma: no cover
        nonzero = ~is_zero[pos]
        out = np.zeros(size, dtype=_DTYPES[bits])
        if nonzero.any():
            vstart = pos[nonzero] + 4
            idx = vstart[:, None] + np.arange(vb)[None, :]
            vals = pad[idx].copy().view(
                np.dtype(_DTYPES[bits]).newbyteorder("<"))[:, 0]
            out[nonzero] = vals.astype(_DTYPES[bits])
        self.inner.state = State(gpos=start.gpos + end)
        return out

    def _random_uniform_with_zeros_sequential(
        self, size: int, prob_zero: float, bits: int = 32
    ) -> np.ndarray:
        """Reference sequential loop (test oracle for the vectorized path)."""
        out = np.zeros(size, dtype=_DTYPES[bits])
        for i in range(size):
            coin = int.from_bytes(bytes(self.generate_bytes(4)), "little")
            if np.float32(coin) / np.float32(0xFFFFFFFF) >= np.float32(prob_zero):
                raw = self.generate_bytes(bits // 8)
                out[i] = int.from_bytes(bytes(raw), "little")
        return out

    # -- gaussian ---------------------------------------------------------

    def random_gaussian_pairs(self, n_pairs: int, mean: float, std: float):
        """Marsaglia-polar gaussian pairs (u*cst+mean, v*cst+mean) as f64.

        Each attempt consumes exactly 16 bytes (two i64, gaussian.rs:27);
        attempts are rejected unless 0 < s < 1.
        """
        uv = self._rejection_stream(n_pairs, 16, _gaussian_attempt_eval)
        s = uv[:, 0] ** 2 + uv[:, 1] ** 2
        cst = std * np.sqrt(-2.0 * np.log(s) / s)
        return uv[:, 0] * cst + mean, uv[:, 1] * cst + mean

    def fill_gaussian_torus(self, size: int, std: float, bits: int) -> np.ndarray:
        """Fill ``size`` torus values with gaussian noise, pairwise.

        Matches fill_tensor_with_random_gaussian (generator.rs:558-581): values
        are produced in chunks of two; for odd sizes the second element of the
        last pair is discarded. Conversion via from_torus (gaussian.rs:58-79).
        """
        n_pairs = (size + 1) // 2
        g1, g2 = self.random_gaussian_pairs(n_pairs, 0.0, std)
        t1 = from_torus_f64(g1, bits)
        t2 = from_torus_f64(g2, bits)
        out = np.empty(2 * n_pairs, dtype=_DTYPES[bits])
        out[0::2] = t1
        out[1::2] = t2
        return out[:size]

    def fill_gaussian_float(self, size: int, mean: float, std: float) -> np.ndarray:
        n_pairs = (size + 1) // 2
        g1, g2 = self.random_gaussian_pairs(n_pairs, mean, std)
        out = np.empty(2 * n_pairs, dtype=np.float64)
        out[0::2] = g1
        out[1::2] = g2
        return out[:size]

    # -- speculative rejection sampling ------------------------------------

    def _rejection_stream(self, n_needed: int, attempt_bytes: int, attempt_eval):
        """Run a sequential rejection sampler, vectorized.

        ``attempt_eval(raw)`` maps a flat u8 array of m*attempt_bytes to
        (accept_mask[m], values[m, ...]). Consumes from the stream exactly the
        attempts the sequential algorithm would have used (state is rewound
        past the last accepted attempt).
        """
        start = self.inner.state
        collected = []
        n_accepted = 0
        attempts_used = 0
        while n_accepted < n_needed:
            want = n_needed - n_accepted
            m = max(int(want * 1.35) + 8, 16)
            if self.inner.bound is not None:
                avail = (self.inner.bound.gpos - self.inner.state.gpos) // attempt_bytes
                if avail < 1:
                    raise RuntimeError("Tried to generate a byte outside the generator bound.")
                m = min(m, avail)
            raw = self.inner.generate_bytes(m * attempt_bytes)
            accept, values = attempt_eval(raw)
            acc_idx = np.nonzero(accept)[0]
            if len(acc_idx) >= want:
                last = acc_idx[want - 1]
                collected.append(values[acc_idx[:want]])
                n_accepted += want
                attempts_used += int(last) + 1
            else:
                collected.append(values[acc_idx])
                n_accepted += len(acc_idx)
                attempts_used += m
        self.inner.state = State(gpos=start.gpos + attempts_used * attempt_bytes)
        return np.concatenate(collected, axis=0)
