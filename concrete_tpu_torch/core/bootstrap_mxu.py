"""Programmable bootstrapping with the external product as an exact
negacyclic toeplitz matmul mod 2^bits on int8 operands (the "mxu" backend of
concrete_tpu/core/bootstrap_mxu.py), on the u32 torus (int32 carriers) and
the u64 torus (int64 carriers).

Exactness, as in the JAX package:
- gadget digits satisfy |d| <= B/2; digits wider than int8 are split into
  balanced 7-bit chunks d = sum_j 2^(7j) e_j with |e_j| <= 64;
- each key coefficient is packed as bits/8 balanced signed-byte limbs c_m in
  [-128, 127] with sum_m c_m 2^(8m) == v (mod 2^bits);
- the int8 x int8 -> int32 product over K <= 2^31 / 8192 rows is exact, and
  the wrapping recombination sum_m S_m << 8m in the carrier's type IS the
  result mod 2^bits.

One CMux step of the blind rotation, batch B, L = bits/8 - limb_drop limbs:
    rotdig / rotdig64 (K2 / K4)  digits of X^a_hat * acc - acc -> d8 [B, R*N] int8
    build_tables (K1)   toeplitz RHS of the step's GGSW -> rhs [R*N, (k+1)*L*N] int8,
                        column-major
    int_mm              S = d8 @ rhs                    -> [B, (k+1)*L*N] int32
    recombine           acc += sum_m S_m << 8(limb_drop + m)
At large batch on the u32 torus the dot-first form folds the recombine of
step j into the digit kernel of step j+1 (rotdig_recombine, K3). On request
(`fused=True`, u32 torus) the table build, dot and recombine of a step run
as one kernel instead (K8, fused_external_product_acc) after K2's digits.

Each kernel wrapper below takes its plain PyTorch version when its tensors
lie on the CPU, and launches the hand-written CUDA kernel
(csrc/mxu_kernels.cu; K8's in csrc/fused_kernels.cu) when they lie on a
CUDA device; `launches` counts the kernel launches.

Example:
    >>> from concrete_tpu_torch.core.bootstrap import ServerConfig
    >>> cfg = ServerConfig(lwe_dimension=4, glwe_dimension=1, polynomial_size=64,
    ...     pbs_base_log=7, pbs_level=2, ks_base_log=4, ks_level=3)
    >>> plan = MxuPlan.from_config(cfg)
    >>> (plan.row_blocks, plan.n_sub, plan.limbs_used)
    (4, 1, 4)
    >>> import dataclasses
    >>> fast64 = dataclasses.replace(cfg, bits=64, mxu_limb_drop=2)
    >>> p64 = MxuPlan.from_config(fast64)
    >>> (p64.n_words, p64.n_limbs, p64.limbs_used)
    (2, 8, 6)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import decomposition, polynomial
from ..ops import _cuda
from ..torus import as_torus, carrier
from . import checks
from . import lwe as lwe_ops
from .bootstrap import (
    ServerConfig,
    rotation_start,
    sample_extract,
    sample_extract_nth,
)

# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MxuPlan:
    """Static layout of the toeplitz-matmul external product."""

    lwe_dimension: int
    glwe_size: int          # k+1
    polynomial_size: int
    base_log: int
    level: int
    n_sub: int              # int8 sub-digits per gadget digit
    ks_base_log: int
    ks_level: int
    limb_drop: int = 0      # low key byte limbs dropped (reduced precision)
    bits: int = 32          # torus width: 32 (boolean) or 64 (high level)

    SUB_CHUNK_BITS = 7

    @classmethod
    def from_config(cls, cfg: ServerConfig) -> "MxuPlan":
        if cfg.bits not in (32, 64):
            raise NotImplementedError("mxu bootstrap: u32 / u64 torus only")
        if cfg.polynomial_size > 4096:
            raise NotImplementedError(
                "toeplitz RHS is O(N^2) per CMux; for N > 4096 use "
                "backend=\"nuss\" (or \"ntt\")")
        bl = cfg.pbs_base_log
        if not (1 <= bl < 32 and bl * cfg.pbs_level <= cfg.bits):
            raise NotImplementedError(
                f"pbs_base_log={bl}, pbs_level={cfg.pbs_level}: need "
                f"base_log < 32 and base_log*level <= {cfg.bits}")
        n_sub = 1 if bl <= 7 else (bl - 8) // 7 + 2
        k_rows = cfg.pbs_level * cfg.glwe_size * n_sub * cfg.polynomial_size
        if k_rows * 64 * 128 >= 2 ** 31:
            raise NotImplementedError(
                f"int32 accumulation bound exceeded (K={k_rows})")
        return cls(
            lwe_dimension=cfg.lwe_dimension,
            glwe_size=cfg.glwe_size,
            polynomial_size=cfg.polynomial_size,
            base_log=bl,
            level=cfg.pbs_level,
            n_sub=n_sub,
            ks_base_log=cfg.ks_base_log,
            ks_level=cfg.ks_level,
            limb_drop=cfg.mxu_limb_drop,
            bits=cfg.bits,
        )

    def sub_multiplier(self, sub: int) -> int:
        """2^(7j) weight of sub-digit `sub` (sub=0 = most significant)."""
        return 1 << (self.SUB_CHUNK_BITS * (self.n_sub - 1 - sub))

    @property
    def n_words(self) -> int:
        """u32 word planes per torus coefficient in the rings (1 or 2)."""
        return self.bits // 32

    @property
    def n_limbs(self) -> int:
        """Signed-byte limbs of a torus coefficient (4 or 8)."""
        return self.bits // 8

    @property
    def limbs_used(self) -> int:
        """Key byte limbs carried by the RHS and the recombine."""
        return self.n_limbs - self.limb_drop

    @property
    def row_blocks(self) -> int:
        """R = number of N-row blocks of the digit matrix."""
        return self.level * self.glwe_size * self.n_sub


# ---------------------------------------------------------------------------
# key conversion (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _limb_pack(v: np.ndarray) -> np.ndarray:
    """Pack the balanced signed-byte limbs of u32 / u64 `v` into words of the
    same width: byte m is limb c_m mod 256; carries propagate upward and the
    top carry wraps, so the bytes recompose to v exactly."""
    dt = v.dtype.type
    one = dt(1)
    w = v
    with np.errstate(over="ignore"):
        for b in range(7, v.dtype.itemsize * 8 - 8, 8):
            w = w + (((w >> dt(b)) & one) << dt(b + 1))
    return w


def bsk_to_mxu(bsk_data, cfg: ServerConfig) -> np.ndarray:
    """[n, l, k+1, k+1, N] u32 / u64 BSK -> toeplitz rotation rings
    [n, R, (k+1)*n_words, 2N] u32: ring = [limbs(+g), limbs(-g)], row blocks
    in (lev, sub, ki) order, sub=0 the 2^7-scaled high chunk; a u64 ring is
    split into n_words=2 u32 word planes, plane kj*2 + w holding word w. The
    negated half is precomputed because the balanced limbs of -g are not
    -limbs(g)."""
    plan = MxuPlan.from_config(cfg)
    dt = np.uint32 if plan.bits == 32 else np.uint64
    bsk = np.asarray(bsk_data, dtype=dt)
    n, l, ks1, _, N = bsk.shape
    rings = np.empty((n, plan.row_blocks, ks1, plan.n_words, 2 * N),
                     dtype=np.uint32)
    blk = 0
    with np.errstate(over="ignore"):
        for lev in range(l):
            for sub in range(plan.n_sub):
                mult = dt(plan.sub_multiplier(sub))
                for ki in range(ks1):
                    g = bsk[:, lev, ki, :, :] * mult     # [n, k+1, N] wrapping
                    pos, neg = _limb_pack(g), _limb_pack(dt(0) - g)
                    for w in range(plan.n_words):
                        sh = dt(32 * w)
                        rings[:, blk, :, w, :N] = (pos >> sh).astype(np.uint32)
                        rings[:, blk, :, w, N:] = (neg >> sh).astype(np.uint32)
                    blk += 1
    return rings.reshape(n, plan.row_blocks, ks1 * plan.n_words, 2 * N)


def _kept_limbs(n_words: int, limb_drop: int,
                limb_hi_drop: int = 0) -> list[tuple[int, int]]:
    """Kept (word, byte) pairs in ascending global-limb order 4*word + byte:
    limb_drop removes low limbs (fast mode), limb_hi_drop high ones (the
    Nussbaumer tables, whose values fill only bits + log2(2L) bits)."""
    return [(w, m) for w in range(n_words) for m in range(4)
            if limb_drop <= 4 * w + m < 4 * n_words - limb_hi_drop]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _split_subdigits(digit: torch.Tensor, n_sub: int):
    """Balanced 7-bit chunks of an int32 gadget digit, MSB chunk first:
    d = sum_j 2^(7j) e_j with |e_j| <= 64. The shifts are arithmetic, as on
    the JAX side's int32."""
    if n_sub == 1:
        return (digit,)
    w = MxuPlan.SUB_CHUNK_BITS
    half, msk = 1 << (w - 1), (1 << w) - 1
    rem, chunks = digit, []
    for _ in range(n_sub - 1):
        e = ((rem + half) & msk) - half
        rem = (rem - e) >> w
        chunks.append(e)
    chunks.append(rem)
    return tuple(reversed(chunks))


def _digit_matrix(plan: MxuPlan, diff: torch.Tensor) -> torch.Tensor:
    """Signed gadget decomposition of diff [k+1, B, N] into the int8 digit
    matrix [B, R*N], row blocks in (lev, sub, ki) order."""
    digits = decomposition.decompose_rounded(diff, plan.base_log, plan.level)
    parts = []
    for lev in range(plan.level):
        for dsub in _split_subdigits(digits[..., lev], plan.n_sub):
            parts.extend(dsub[ki].to(torch.int8) for ki in range(diff.shape[0]))
    return torch.cat(parts, dim=1)


def recombine_limb_planes(plan: MxuPlan, s: torch.Tensor) -> torch.Tensor:
    """[B, (kj, m, c)] int32 dot output -> [k+1, B, N] in the torus carrier
    (int32 / int64): the wrapping sum of the limb planes,
    S_m << 8(limb_drop + m), is the value mod 2^bits."""
    b = s.shape[0]
    dt = carrier(plan.bits)
    planes = s.reshape(b, plan.glwe_size, plan.limbs_used, plan.polynomial_size)
    out = planes[:, :, 0].to(dt) << (8 * plan.limb_drop)
    for j in range(1, plan.limbs_used):
        out = out + (planes[:, :, j].to(dt) << (8 * (plan.limb_drop + j)))
    return out.permute(1, 0, 2)


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


def int_mm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None):
    """Exact a [M, K] int8 @ b [K, N] int8 -> [M, N] int32 (torch._int_mm).

    `b` may be row-major or column-major (the transpose of a contiguous
    [N, K], as build_tables returns it): torch._int_mm takes either without
    a copy, and cuBLASLt's int8 product reads the column-major one fastest.

    On CUDA, torch._int_mm refuses M <= 16 and K or N not a multiple of 8,
    and its cuBLASLt call refused every M that is not a multiple of 32 once
    K <= 64 (torch 2.11, H100); such shapes are zero-padded to M a multiple
    of 32 and K, N multiples of 8 (the padding adds zeros and is cut off),
    and only there, into a buffer of b's layout.

    >>> a = torch.ones((2, 3), dtype=torch.int8)
    >>> b = torch.arange(12, dtype=torch.int8).reshape(4, 3).t()  # column-major
    >>> int_mm(a, b).tolist()
    [[3, 12, 21, 30], [3, 12, 21, 30]]
    """
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cuda":
        mp, kp, np_ = -(-m // 32) * 32, _ceil8(k), _ceil8(n)
        if (mp, kp, np_) != (m, k, n):
            ap = torch.zeros((mp, kp), dtype=a.dtype, device=a.device)
            ap[:m, :k] = a
            if _column_major(b):
                bp = torch.zeros((np_, kp), dtype=b.dtype, device=b.device).t()
            else:
                bp = torch.zeros((kp, np_), dtype=b.dtype, device=b.device)
            bp[:k, :n] = b
            res = torch._int_mm(ap, bp)[:m, :n]
            return res if out is None else out.copy_(res)
    if out is None:
        return torch._int_mm(a, b)
    return torch._int_mm(a, b, out=out)


def _column_major(t: torch.Tensor) -> bool:
    """Is the last two axes' layout column-major (their transpose
    contiguous)?"""
    return t.transpose(-1, -2).is_contiguous()


def table_buffer(rows: int, cols: int, groups: int = 1, *,
                 device=None) -> torch.Tensor:
    """An uninitialised build_tables output: [rows, cols] int8 column-major
    (groups=1), or [groups, rows, cols] with each group's matrix
    column-major (the Nussbaumer tables, one per frequency)."""
    buf = torch.empty((groups, cols, rows), dtype=torch.int8, device=device)
    buf = buf.transpose(1, 2)
    return buf[0] if groups == 1 else buf


def _toeplitz_matmul(plan: MxuPlan, d8, rhs, out=None):
    """d8 [B, R*N] x rhs [R*N, (k+1)*L*N] -> [k+1, B, N]: the exact external
    product mod 2^bits (one int8 dot into `out`, then the limb
    recombination)."""
    return recombine_limb_planes(plan, int_mm(d8, rhs, out=out))


# ---------------------------------------------------------------------------
# the four kernels: plain PyTorch versions and wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else is refused."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type == "cpu":
            return True
        if dev.type == "cuda":
            return False
    raise ValueError(f"tensors must share one CPU or CUDA device, got {devices}")


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_kernel_operands(n: int, *tensors):
    """What the CUDA kernels assume beyond shapes: N a power of two >= 4
    (index masks, 4 coefficients a thread) and operands aligned for the
    16-byte (uint4) loads and 4-byte stores."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"polynomial_size {n}: must be a power of two >= 4")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("CUDA kernel operands must be 16-byte aligned")


def build_tables_plain(rings: torch.Tensor, n: int, limb_drop: int = 0,
                       n_words: int = 1, limb_hi_drop: int = 0):
    """rings [R, (k+1)*n_words, 2N] int32 word planes -> RHS
    [R*N, (k+1)*L*N] int8, L = 4*n_words - limb_drop - limb_hi_drop: entry
    (blk*N + r, (kj*L + li)*N + c) is global byte limb_drop+li (byte g & 3 of
    word plane kj*n_words + g//4) of ring[blk, kj][(c - r) mod 2N], the
    negacyclic toeplitz matrix.

    Row r of block blk reads ring[(c - r) mod 2N] for c < N, i.e. the window
    ext[N - r .. 2N - r) of ext = roll(ring, N); reversed rows r' = N-1-r
    are the windows ext[1 + r' ..], a plain strided view."""
    r_blocks = rings.shape[0]
    ks1 = rings.shape[1] // n_words
    words = rings.reshape(r_blocks, ks1, n_words, 2 * n)
    kept = _kept_limbs(n_words, limb_drop, limb_hi_drop)
    limbs = torch.stack([(words[:, :, w] << (24 - 8 * m)) >> 24
                         for w, m in kept], dim=2).to(torch.int8)  # [R, k+1, L, 2N]
    ext = torch.roll(limbs, n, dims=-1).contiguous()
    nk = len(kept)
    windows = ext.as_strided(
        (r_blocks, n, ks1, nk, n), (ks1 * nk * 2 * n, 1, nk * 2 * n, 2 * n, 1),
        storage_offset=ext.storage_offset() + 1)
    return windows.flip(1).reshape(r_blocks * n, ks1 * nk * n)


def build_tables(rings: torch.Tensor, n: int, limb_drop: int = 0,
                 n_words: int = 1, limb_hi_drop: int = 0, *, groups: int = 1,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K1, the toeplitz RHS of one CMux step (build_tables_plain), from u32
    (n_words=1) or u64 (n_words=2) rings, or from the Nussbaumer rings
    (n_words=2 on the u32 torus, 3 on the u64 torus, with limb_hi_drop high
    limbs dropped; n is then M).

    The table is written column-major (table_buffer), the layout
    torch._int_mm's cuBLASLt path reads fastest; the values are
    build_tables_plain's. With `groups` > 1 the R ring blocks split into
    that many consecutive groups, and the result is [groups, R*N/groups,
    cols], each group's matrix column-major (the Nussbaumer backend: one
    group per frequency). `out`, when given, is written in place and
    returned: the blind rotation allocates it once (table_buffer) and
    reuses it every step; on the CPU it may have any layout.

    >>> rings = torch.arange(2 * 2 * 8, dtype=torch.int32).reshape(2, 2, 8)
    >>> t = build_tables(rings, 4)
    >>> t.shape, t.stride(), torch.equal(t, build_tables_plain(rings, 4))
    (torch.Size([8, 32]), (1, 8), True)
    """
    r_blocks, planes = rings.shape[:2]
    ks1 = planes // n_words
    nk = 4 * n_words - limb_drop - limb_hi_drop
    if n_words not in (1, 2, 3) or min(limb_drop, limb_hi_drop) < 0 or nk < 1:
        raise ValueError(f"n_words={n_words}, limb_drop={limb_drop}, "
                         f"limb_hi_drop={limb_hi_drop}")
    if groups < 1 or r_blocks % groups:
        raise ValueError(f"groups={groups} must divide {r_blocks} ring blocks")
    rows, cols = r_blocks // groups * n, ks1 * nk * n
    shape = (rows, cols) if groups == 1 else (groups, rows, cols)
    _check(rings, "rings", torch.int32, (r_blocks, ks1 * n_words, 2 * n))
    if out is not None:
        if out.dtype != torch.int8 or tuple(out.shape) != shape:
            raise ValueError(f"out: expected int8 {shape}, got {out.dtype} "
                             f"{tuple(out.shape)}")
    if _on_cpu(rings, out):
        res = build_tables_plain(rings, n, limb_drop, n_words,
                                 limb_hi_drop).view(shape)
        if out is None:
            out = table_buffer(rows, cols, groups, device=rings.device)
        return out.copy_(res)
    if out is None:
        out = table_buffer(rows, cols, groups, device=rings.device)
    elif not _column_major(out):
        raise ValueError("out: the kernel writes a column-major table "
                         "(table_buffer)")
    _check_kernel_operands(n, rings, out)
    if n % 16:
        raise ValueError(f"N={n}: K1 writes 16-byte runs, N a multiple of 16")
    _cuda.launch("ctt_build_tables", rings, out, r_blocks, ks1, n, nk,
                 limb_drop, n_words, groups)
    _cuda.count_launch(build_tables, R=r_blocks, N=n, ks1=ks1, words=n_words,
                       limbs=nk, groups=groups)
    return out


_cuda.counter(build_tables)


def rotdig_plain(plan: MxuPlan, acc: torch.Tensor, a_hat: torch.Tensor):
    """Digit matrix [B, R*N] int8 of (X^a_hat * acc - acc), acc [k+1, B, N]
    int32 (u32 torus) or int64 (u64 torus), a_hat [B] int32 (read mod 2N)."""
    rot = polynomial.negacyclic_monomial_mul(acc, a_hat[None, :])
    return _digit_matrix(plan, rot - acc)


# K4's plain version: the same arithmetic on int64 carriers
rotdig64_plain = rotdig_plain


def _rotdig_launch(kernel, entry: str, dtype, plan: MxuPlan, acc, a_hat, out):
    """The shared wrapper of K2 (int32 acc) and K4 (int64 acc)."""
    ks1, b, n = acc.shape
    shape = (b, plan.row_blocks * n)
    _check(acc, "acc", dtype, (plan.glwe_size, b, plan.polynomial_size))
    _check(a_hat, "a_hat", torch.int32, (b,))
    if out is not None:
        _check(out, "out", torch.int8, shape)
    if _on_cpu(acc, a_hat, out):
        res = rotdig_plain(plan, acc, a_hat)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=torch.int8, device=acc.device)
    if b:
        _check_kernel_operands(n, acc, out)
        _cuda.launch(entry, acc, a_hat, out, b, ks1, n, plan.base_log,
                     plan.level, plan.n_sub)
        _cuda.count_launch(kernel, B=b, ks1=ks1, N=n, bl=plan.base_log,
                           l=plan.level, n_sub=plan.n_sub)
    return out


def rotdig(plan: MxuPlan, acc: torch.Tensor, a_hat: torch.Tensor, *,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """K2, rotation + gadget digits of one CMux step on the u32 torus
    (rotdig_plain)."""
    return _rotdig_launch(rotdig, "ctt_rotdig", torch.int32, plan, acc, a_hat,
                          out)


def rotdig64(plan: MxuPlan, acc: torch.Tensor, a_hat: torch.Tensor, *,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """K4, rotation + gadget digits of one CMux step on the u64 torus
    (rotdig64_plain), for every base_log*level <= 64."""
    return _rotdig_launch(rotdig64, "ctt_rotdig64", torch.int64, plan, acc,
                          a_hat, out)


_cuda.counter(rotdig)
_cuda.counter(rotdig64)


def rotdig_recombine_plain(plan: MxuPlan, s: torch.Tensor, acc: torch.Tensor,
                           a_hat: torch.Tensor):
    """(acc_new, d8): acc_new = acc + recombine_limb_planes(s) (wrapping),
    d8 = rotdig_plain of acc_new."""
    acc_new = acc + recombine_limb_planes(plan, s)
    return acc_new, rotdig_plain(plan, acc_new, a_hat)


def rotdig_recombine(plan: MxuPlan, s: torch.Tensor, acc: torch.Tensor,
                     a_hat: torch.Tensor, *, acc_out: torch.Tensor | None = None,
                     d8_out: torch.Tensor | None = None):
    """K3, the previous step's limb recombine and accumulate folded into
    this step's rotation + digits (rotdig_recombine_plain). `acc_out` may be
    `acc` itself: the update is then made in place."""
    ks1, b, n = acc.shape
    _check(acc, "acc", torch.int32, (plan.glwe_size, b, plan.polynomial_size))
    _check(s, "s", torch.int32, (b, ks1 * plan.limbs_used * n))
    _check(a_hat, "a_hat", torch.int32, (b,))
    if acc_out is not None:
        _check(acc_out, "acc_out", torch.int32, acc.shape)
    if d8_out is not None:
        _check(d8_out, "d8_out", torch.int8, (b, plan.row_blocks * n))
    if _on_cpu(s, acc, a_hat, acc_out, d8_out):
        acc_new, d8 = rotdig_recombine_plain(plan, s, acc, a_hat)
        if acc_out is not None:
            acc_new = acc_out.copy_(acc_new)
        if d8_out is not None:
            d8 = d8_out.copy_(d8)
        return acc_new, d8
    if acc_out is None:
        acc_out = torch.empty_like(acc)
    if d8_out is None:
        d8_out = torch.empty((b, plan.row_blocks * n), dtype=torch.int8,
                             device=acc.device)
    if b:
        _check_kernel_operands(n, s, acc, acc_out, d8_out)
        _cuda.launch("ctt_rotdig_recombine", s, acc, a_hat, acc_out, d8_out,
                     b, ks1, n, plan.limbs_used, plan.limb_drop,
                     plan.base_log, plan.level, plan.n_sub)
        _cuda.count_launch(rotdig_recombine, B=b, ks1=ks1, N=n,
                           bl=plan.base_log, l=plan.level, n_sub=plan.n_sub)
    return acc_out, d8_out


_cuda.counter(rotdig_recombine)

FUSED_TILE = 64  # K8's column and depth tile (its row tile is 128)


def fused_external_product_acc_plain(plan: MxuPlan, acc: torch.Tensor,
                                     d8: torch.Tensor,
                                     rings: torch.Tensor) -> torch.Tensor:
    """acc [k+1, B, N] int32 + recombine(d8 [B, R*N] int8 @ T(rings)),
    rings [R, k+1, 2N] int32: build_tables_plain -> int_mm ->
    recombine_limb_planes -> add."""
    rhs = build_tables_plain(rings, plan.polynomial_size, plan.limb_drop)
    return acc + recombine_limb_planes(plan, int_mm(d8, rhs))


def fused_external_product_acc(plan: MxuPlan, acc: torch.Tensor,
                               d8: torch.Tensor, rings: torch.Tensor, *,
                               out: torch.Tensor | None = None):
    """K8, the toeplitz CMux accumulation in one kernel
    (fused_external_product_acc_plain) on the u32 torus, limb_drop 0-2: the
    kernel (csrc/fused_kernels.cu) builds the table tiles it needs in shared
    memory from a window of the ring, never writes T to device memory, and
    multiplies them on the int8 tensor cores (mma.sync m16n8k32).
    `out` may be `acc` itself: each output word is read and written by one
    thread, so the update is then made in place.

    >>> plan = MxuPlan.from_config(ServerConfig(lwe_dimension=4,
    ...     glwe_dimension=1, polynomial_size=64, pbs_base_log=7, pbs_level=2,
    ...     ks_base_log=4, ks_level=3))
    >>> acc = torch.ones((2, 3, 64), dtype=torch.int32)
    >>> d8 = torch.zeros((3, plan.row_blocks * 64), dtype=torch.int8)
    >>> rings = torch.zeros((plan.row_blocks, 2, 128), dtype=torch.int32)
    >>> torch.equal(fused_external_product_acc(plan, acc, d8, rings), acc)
    True
    """
    if plan.bits != 32:
        raise ValueError("K8 runs the u32 torus only (the u64 torus keeps "
                         "the unfused step)")
    ks1, b, n = acc.shape
    r = plan.row_blocks
    _check(acc, "acc", torch.int32, (plan.glwe_size, b, plan.polynomial_size))
    _check(d8, "d8", torch.int8, (b, r * n))
    _check(rings, "rings", torch.int32, (r, ks1, 2 * n))
    if out is not None:
        _check(out, "out", torch.int32, acc.shape)
    if _on_cpu(acc, d8, rings, out):
        res = fused_external_product_acc_plain(plan, acc, d8, rings)
        return res if out is None else out.copy_(res)
    if n % FUSED_TILE:
        raise ValueError(f"polynomial_size {n}: K8 takes multiples of "
                         f"{FUSED_TILE}")
    if out is None:
        out = torch.empty_like(acc)
    if b:
        _check_kernel_operands(n, acc, d8, rings, out)
        _cuda.launch("ctt_fused_cmux", acc, d8, rings, out, b, ks1, n, r,
                     plan.limbs_used, plan.limb_drop)
        _cuda.count_launch(fused_external_product_acc, B=b, ks1=ks1, N=n, R=r,
                           limbs=plan.limbs_used)
    return out


_cuda.counter(fused_external_product_acc)

KERNELS = (build_tables, rotdig, rotdig_recombine, rotdig64,
           fused_external_product_acc)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def shape_counts() -> dict[str, dict[str, int]]:
    """Kernel launches per wrapper and shape key since the last reset."""
    return {k.__name__: dict(k.shapes) for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        _cuda.counter(k)


# ---------------------------------------------------------------------------
# one GGSW: external product and CMux
# ---------------------------------------------------------------------------


def external_product_mxu(cfg: ServerConfig, rings, glwe) -> torch.Tensor:
    """Toeplitz-matmul external product <decomp(glwe), GGSW>: glwe
    [..., k+1, N] in the torus carrier (numpy is taken as the torus),
    rings [R, (k+1)*n_words, 2N] int32 of one GGSW (one step's slice of
    bsk_to_mxu). The step of the blind rotation on one GGSW: digits
    (_digit_matrix), the table (K1 build_tables), the int8 product (int_mm)
    and the limb recombination; on rings' device.

    >>> import numpy as np
    >>> cfg = ServerConfig(lwe_dimension=1, glwe_dimension=1, polynomial_size=16,
    ...     pbs_base_log=7, pbs_level=2, ks_base_log=4, ks_level=3)
    >>> ggsw = np.zeros((1, 2, 2, 2, 16), np.uint32)    # a trivial GGSW(0)
    >>> rings = torch.from_numpy(bsk_to_mxu(ggsw, cfg)[0].view(np.int32))
    >>> glwe = np.arange(2 * 16, dtype=np.uint32).reshape(2, 16) << 20
    >>> int(external_product_mxu(cfg, rings, glwe).abs().max())
    0
    """
    plan = MxuPlan.from_config(cfg)
    rings = torch.as_tensor(rings)
    glwe = as_torus(glwe, rings.device, plan.bits)
    ks1, n = plan.glwe_size, plan.polynomial_size
    checks.check_glwe(glwe, ks1, n, "glwe")
    lead = glwe.shape[:-2]
    pbn = glwe.reshape(-1, ks1, n).transpose(0, 1)      # [k+1, B, N]
    d8 = _digit_matrix(plan, pbn)
    rhs = build_tables(rings, n, plan.limb_drop, plan.n_words)
    out = _toeplitz_matmul(plan, d8, rhs)               # [k+1, B, N]
    return out.transpose(0, 1).reshape(lead + (ks1, n))


def cmux_mxu(cfg: ServerConfig, rings, ct0, ct1) -> torch.Tensor:
    """ct0 + extprod(ggsw, ct1 - ct0) (fourier/mod.rs:648-664): ct0 for a
    GGSW of 0, ct1 for a GGSW of 1."""
    dev = torch.as_tensor(rings).device
    ct0 = as_torus(ct0, dev, cfg.bits)
    return ct0 + external_product_mxu(cfg, rings,
                                      as_torus(ct1, dev, cfg.bits) - ct0)


# ---------------------------------------------------------------------------
# blind rotation / bootstrap
# ---------------------------------------------------------------------------


def auto_defer(plan: MxuPlan, batch: int) -> bool:
    """Run the dot-first deferred-recombine loop for this (plan, batch)?

    The rule and its thresholds are the JAX package's crossover, measured
    on a TPU v5e (concrete_tpu/core/bootstrap_mxu.py:auto_defer): defer once
    the per-step dot output S passes ~100 MB, at batch >= 4096 or S >= 200
    MB. The H100 crossover has not been measured yet.

    >>> tpu128 = MxuPlan(lwe_dimension=630, glwe_size=5, polynomial_size=256,
    ...     base_log=7, level=2, n_sub=1, ks_base_log=2, ks_level=6)
    >>> [auto_defer(tpu128, b) for b in (2048, 4096, 8192)]
    [False, False, True]
    """
    s_bytes = batch * plan.glwe_size * plan.limbs_used * \
        plan.polynomial_size * 4
    return s_bytes > 100e6 and (batch >= 4096 or s_bytes >= 200e6)


def _step_buffers(plan: MxuPlan, b: int, device, blocks: int | None = None):
    """The per-step d8 / RHS / S buffers, allocated once per rotation; the
    RHS holds `blocks` ring blocks (a tensor-parallel rank's) or all R."""
    n, r = plan.polynomial_size, plan.row_blocks
    cols = plan.glwe_size * plan.limbs_used * n
    d8 = torch.empty((b, r * n), dtype=torch.int8, device=device)
    rhs = table_buffer((r if blocks is None else blocks) * n, cols,
                       device=device)
    s = torch.zeros((b, cols), dtype=torch.int32, device=device)
    return d8, rhs, s


def step_dot(d8, rhs, s, c0: int = 0, reduce=None):
    """The int8 product of one CMux step into s: d8 [B, R*N] x rhs [R*N,
    cols], or per group (the Nussbaumer frequencies) d8 [G, B, .] x rhs [G,
    ., cols]. Where rhs holds only a tensor-parallel rank's ring blocks,
    its rows meet d8's columns from c0 on, and `reduce` sums the partial S
    over the ranks (exact: the plan's row bound covers the whole
    contraction). Returns S."""
    rows = rhs.shape[-2]
    if rows != d8.shape[-1]:
        d8 = d8[..., c0:c0 + rows].contiguous()
    if d8.dim() == 2:
        int_mm(d8, rhs, out=s)
    else:
        for z in range(d8.shape[0]):
            int_mm(d8[z], rhs[z], out=s[z])
    return s if reduce is None else reduce(s)


def _plain_scan(plan: MxuPlan, bsk_rings, acc, a_hats, block0: int = 0,
                reduce=None):
    """One CMux step per mask element: digits, table, dot, recombine. A
    tensor-parallel rank passes its ring blocks (bsk_rings [n, R/tp, ...]
    from block `block0` on) and `reduce` (step_dot)."""
    n = plan.polynomial_size
    d8, rhs, s = _step_buffers(plan, acc.shape[1], acc.device,
                               bsk_rings.shape[1])
    digits = rotdig if plan.bits == 32 else rotdig64
    acc = acc.clone()
    for i in range(a_hats.shape[0]):
        digits(plan, acc, a_hats[i], out=d8)
        build_tables(bsk_rings[i], n, plan.limb_drop, plan.n_words, out=rhs)
        acc += recombine_limb_planes(
            plan, step_dot(d8, rhs, s, block0 * n, reduce))
    return acc


def _deferred_scan(plan: MxuPlan, bsk_rings, acc, a_hats, block0: int = 0,
                   reduce=None):
    """The dot-first form: step j's dot output S is recombined inside step
    j+1's digit kernel (K3). A first kernel call with S = 0 applies a_hat_0;
    step j then consumes rings_j and a_hat_{j+1}, and the last step's dummy
    a_hat = 0 rotates by X^0 (its digits are discarded). u32 torus only.
    block0 / reduce as in _plain_scan."""
    n = plan.polynomial_size
    d8, rhs, s = _step_buffers(plan, acc.shape[1], acc.device,
                               bsk_rings.shape[1])
    acc = acc.clone()
    rotdig_recombine(plan, s, acc, a_hats[0], acc_out=acc, d8_out=d8)
    a_next = torch.cat([a_hats[1:], torch.zeros_like(a_hats[:1])], dim=0)
    for j in range(a_hats.shape[0]):
        build_tables(bsk_rings[j], n, plan.limb_drop, out=rhs)
        rotdig_recombine(plan, step_dot(d8, rhs, s, block0 * n, reduce), acc,
                         a_next[j], acc_out=acc, d8_out=d8)
    return acc


def _fused_scan(plan: MxuPlan, bsk_rings, acc, a_hats):
    """One CMux step per mask element: digits (K2), then table build, dot,
    recombine and accumulate in one kernel (K8), in place. u32 torus only."""
    n, r = plan.polynomial_size, plan.row_blocks
    d8 = torch.empty((acc.shape[1], r * n), dtype=torch.int8,
                     device=acc.device)
    acc = acc.clone()
    for i in range(a_hats.shape[0]):
        rotdig(plan, acc, a_hats[i], out=d8)
        fused_external_product_acc(plan, acc, d8, bsk_rings[i], out=acc)
    return acc


def scan_for(plan: MxuPlan, batch: int, fused: bool = False):
    """The CMux loop of a blind rotation: K8's with fused, else the
    dot-first loop where auto_defer takes the batch (u32), else the plain
    one. The tensor-parallel pipeline (parallel/mesh.py) runs the same."""
    if fused:
        return _fused_scan
    if plan.bits == 32 and auto_defer(plan, batch):
        return _deferred_scan
    return _plain_scan


def blind_rotate_mxu(cfg: ServerConfig, bsk_rings: torch.Tensor,
                     lut: torch.Tensor, lwe: torch.Tensor, *,
                     ms_offset: int = 0, lut_count_log: int = 0,
                     fused: bool = False):
    """Blind rotation with the toeplitz-matmul CMux chain.

    bsk_rings [n, R, (k+1)*n_words, 2N] int32 (bsk_to_mxu); lut [..., k+1, N]
    and lwe [..., n+1] in the torus carrier (int32 / int64). Returns the
    rotated accumulator [..., k+1, N], bit-identical to concrete_tpu's
    blind_rotate_mxu. The u32 torus takes the dot-first loop where
    auto_defer says so, as the JAX package does; the u64 torus always takes
    the plain loop. `fused=True` (the JAX package's CONCRETE_TPU_FUSED=1)
    takes the plain loop with K8 in place of the table, dot and recombine;
    it runs the u32 torus only and raises ValueError on u64, where the JAX
    package would ignore it."""
    plan = MxuPlan.from_config(cfg)
    if fused and plan.bits != 32:
        raise ValueError("fused=True runs the u32 torus only")
    n_lwe, N, ks1 = cfg.lwe_dimension, plan.polynomial_size, plan.glwe_size
    checks.check_bsk_mxu(bsk_rings, cfg)
    checks.check_lwe(lwe, n_lwe)
    checks.check_glwe(lut, ks1, N, "accumulator")
    if lwe.dtype != carrier(plan.bits) or lut.dtype != lwe.dtype:
        raise TypeError(f"u{plan.bits} torus tensors are {carrier(plan.bits)}")
    lead = lwe.shape[:-1]
    acc, a_hats = rotation_start(lut, lwe, N, ms_offset, lut_count_log)
    acc = scan_for(plan, acc.shape[1], fused)(plan, bsk_rings, acc, a_hats)
    return acc.permute(1, 0, 2).reshape(lead + (ks1, N))


def bootstrap_mxu(cfg: ServerConfig, bsk_rings, lut, lwe, *,
                  fused: bool = False):
    """Full PBS (fourier/mod.rs:878-911): [..., n+1] -> [..., k*N+1]."""
    return sample_extract(blind_rotate_mxu(cfg, bsk_rings, lut, lwe,
                                           fused=fused))


def bootstrap_many_lut_mxu(cfg: ServerConfig, bsk_rings, lut, lwe,
                           lut_count_log: int, *, ms_offset: int = 0,
                           fused: bool = False):
    """Multi-LUT PBS: one blind rotation, 2^lut_count_log extractions ->
    [2^lcl, ..., k*N+1]."""
    acc = blind_rotate_mxu(cfg, bsk_rings, lut, lwe, ms_offset=ms_offset,
                           lut_count_log=lut_count_log, fused=fused)
    return torch.stack(
        [sample_extract_nth(acc, t) for t in range(1 << lut_count_log)], dim=0)


def bootstrap_keyswitch_mxu(cfg: ServerConfig, bsk_rings, ksk8, lut, lwe, *,
                            fused: bool = False):
    """PBS + keyswitch, the per-gate pipeline (server_key/mod.rs:133-166),
    against a limb-prepared keyswitch key (lwe.ksk_to_limbs; any ks_base_log,
    lwe.keyswitch_prepared)."""
    big = bootstrap_mxu(cfg, bsk_rings, lut, lwe, fused=fused)
    return lwe_ops.keyswitch_prepared(ksk8, big, base_log=cfg.ks_base_log,
                                      level_count=cfg.ks_level)
