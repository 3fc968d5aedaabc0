"""AES-128 (encrypt only) for the CSPRNG: the native library by default,
a vectorised numpy version on request.

The stream functions (:func:`encrypt_blocks`, :func:`ctr_fill`,
:func:`ctr_fill_batch`) run the C++ library of
:mod:`concrete_tpu_torch.native` (AES-NI where the CPU has it) and raise
when it cannot be built or loaded. ``native=False`` runs the numpy AES
instead (every block of a batch at once, with table lookups and xors), bit
for bit the same; it is the plain version the tests hold the library to,
and :data:`NUMPY_CALLS` counts its calls so that a caller can show a run
never took it. Counters are little-endian u128 values (the reference's
software.rs:76-89 on x86).

Example (FIPS-197 Appendix B):
    >>> import numpy as np
    >>> rks = key_schedule(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"))
    >>> pt = np.frombuffer(bytes.fromhex("3243f6a8885a308d313198a2e0370734"), np.uint8)
    >>> bytes(encrypt_blocks(pt[None, :], rks)[0]).hex()
    '3925841d02dc09fbdc118597196a0b32'
    >>> bool((ctr_fill(rks, 5, 3) == ctr_fill(rks, 5, 3, native=False)).all())
    True
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native

# calls of the numpy AES since import (native=False)
NUMPY_CALLS = 0
_U64_MASK = (1 << 64) - 1

# The AES S-box (FIPS-197 figure 7). Public constant.
SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
], dtype=np.uint8)

# Precomputed xtime table: multiplication by 2 in GF(2^8) mod x^8+x^4+x^3+x+1.
_XTIME = np.arange(256, dtype=np.uint16)
_XTIME = ((_XTIME << 1) ^ np.where(_XTIME & 0x80, 0x1B, 0)).astype(np.uint8)

# ShiftRows as a flat permutation of the 16-byte state.
# State layout: s[r][c] = block[r + 4c]; ShiftRows: s'[r][c] = s[r][(c+r) % 4].
_SHIFT_ROWS = np.array(
    [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)], dtype=np.intp
)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36], dtype=np.uint8)


def key_schedule(key: bytes | np.ndarray) -> np.ndarray:
    """Expand a 16-byte AES-128 key into 11 round keys, shape [11, 16] u8."""
    key = np.frombuffer(bytes(key), dtype=np.uint8).copy() if not isinstance(key, np.ndarray) else key
    assert key.shape == (16,)
    w = np.zeros((44, 4), dtype=np.uint8)
    w[:4] = key.reshape(4, 4)
    for i in range(4, 44):
        temp = w[i - 1].copy()
        if i % 4 == 0:
            temp = SBOX[np.roll(temp, -1)]
            temp[0] ^= _RCON[i // 4 - 1]
        w[i] = w[i - 4] ^ temp
    return w.reshape(11, 16)


def key_schedule(key: bytes | np.ndarray) -> np.ndarray:
    """Expand a 16-byte AES-128 key into 11 round keys, shape [11, 16] u8."""
    if not isinstance(key, np.ndarray):
        key = np.frombuffer(bytes(key), dtype=np.uint8).copy()
    if key.shape != (16,):
        raise ValueError("an AES-128 key is 16 bytes")
    w = np.zeros((44, 4), dtype=np.uint8)
    w[:4] = key.reshape(4, 4)
    for i in range(4, 44):
        temp = w[i - 1].copy()
        if i % 4 == 0:
            temp = SBOX[np.roll(temp, -1)]
            temp[0] ^= _RCON[i // 4 - 1]
        w[i] = w[i - 4] ^ temp
    return w.reshape(11, 16)


def _mix_columns(state: np.ndarray) -> np.ndarray:
    """MixColumns on state shaped [n, 4 (columns), 4 (rows)]:
    out[r] = 2 a[r] ^ 3 a[r+1] ^ a[r+2] ^ a[r+3], indices mod 4."""
    a1 = np.roll(state, -1, axis=-1)
    return (_XTIME[state] ^ _XTIME[a1] ^ a1
            ^ np.roll(state, -2, axis=-1) ^ np.roll(state, -3, axis=-1))


def encrypt_blocks_numpy(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """The numpy AES-128: [n, 16] u8 blocks -> [n, 16] u8."""
    global NUMPY_CALLS
    NUMPY_CALLS += 1
    state = blocks ^ round_keys[0]
    for rnd in range(1, 10):
        state = SBOX[state][:, _SHIFT_ROWS]
        state = _mix_columns(state.reshape(-1, 4, 4)).reshape(-1, 16)
        state = state ^ round_keys[rnd]
    return SBOX[state][:, _SHIFT_ROWS] ^ round_keys[10]


_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def encrypt_blocks(blocks: np.ndarray, round_keys: np.ndarray, *,
                   native: bool = True) -> np.ndarray:
    """Encrypt a batch of 16-byte blocks, [n, 16] u8 -> [n, 16] u8."""
    if not native:
        return encrypt_blocks_numpy(blocks, round_keys)
    blk = np.ascontiguousarray(blocks, dtype=np.uint8)
    rk = np.ascontiguousarray(round_keys, dtype=np.uint8)
    out = np.empty_like(blk)
    if blk.size:
        _lib().ctt_aes128_encrypt_blocks(
            rk.ctypes.data_as(_U8P), blk.ctypes.data_as(_U8P),
            out.ctypes.data_as(_U8P), blk.shape[0])
    return out


def _counters(first_lo: np.ndarray, first_hi: np.ndarray,
              n_blocks: int) -> np.ndarray:
    """[R] u128 start counters (split little-endian) -> [R, n_blocks, 16]
    blocks of the consecutive counters."""
    k = np.arange(n_blocks, dtype=np.uint64)
    with np.errstate(over="ignore"):
        lo = first_lo[:, None] + k[None, :]
        hi = first_hi[:, None] + (lo < first_lo[:, None]).astype(np.uint64)
    r = first_lo.shape[0]
    blocks = np.empty((r, n_blocks, 16), dtype=np.uint8)
    blocks[..., :8] = lo.astype("<u8").view(np.uint8).reshape(r, n_blocks, 8)
    blocks[..., 8:] = hi.astype("<u8").view(np.uint8).reshape(r, n_blocks, 8)
    return blocks


def ctr_fill(round_keys: np.ndarray, first_block: int, n_blocks: int, *,
             native: bool = True) -> np.ndarray:
    """Encrypt `n_blocks` consecutive little-endian u128 counters from
    `first_block` -> [n_blocks * 16] u8 stream bytes."""
    lo, hi = first_block & _U64_MASK, (first_block >> 64) & _U64_MASK
    if not native:
        blocks = _counters(np.array([lo], np.uint64), np.array([hi], np.uint64),
                           n_blocks)
        return encrypt_blocks_numpy(blocks.reshape(-1, 16),
                                    round_keys).reshape(-1)
    rk = np.ascontiguousarray(round_keys, dtype=np.uint8)
    out = np.empty(n_blocks * 16, dtype=np.uint8)
    if n_blocks:
        _lib().ctt_aes128_ctr_fill(rk.ctypes.data_as(_U8P), ctypes.c_uint64(lo),
                                   ctypes.c_uint64(hi),
                                   out.ctypes.data_as(_U8P), n_blocks)
    return out


def ctr_fill_batch(round_keys: np.ndarray, first_lo: np.ndarray,
                   first_hi: np.ndarray, n_blocks: int, *,
                   native: bool = True) -> np.ndarray:
    """`n_blocks` consecutive counters from each of R start positions in one
    sweep: first_lo / first_hi [R] u64 (the u128 counter split
    little-endian) -> [R, n_blocks * 16] u8. The library spreads the rows
    over the CPU's threads (the reference's rayon par_fill,
    bootstrap/standard/mod.rs:254)."""
    r = first_lo.shape[0]
    if r == 0 or n_blocks == 0:
        return np.zeros((r, n_blocks * 16), dtype=np.uint8)
    if not native:
        blocks = _counters(first_lo.astype(np.uint64), first_hi.astype(np.uint64),
                           n_blocks)
        return encrypt_blocks_numpy(blocks.reshape(-1, 16),
                                    round_keys).reshape(r, n_blocks * 16)
    rk = np.ascontiguousarray(round_keys, dtype=np.uint8)
    lo = np.ascontiguousarray(first_lo, dtype=np.uint64)
    hi = np.ascontiguousarray(first_hi, dtype=np.uint64)
    out = np.empty((r, n_blocks * 16), dtype=np.uint8)
    _lib().ctt_aes128_ctr_fill_batch(
        rk.ctypes.data_as(_U8P), lo.ctypes.data_as(_U64P),
        hi.ctypes.data_as(_U64P), out.ctypes.data_as(_U8P), r, n_blocks)
    return out


def _lib():
    return native.load_aes()
