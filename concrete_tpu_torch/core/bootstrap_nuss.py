"""Large-N programmable bootstrapping: the external product in the
Nussbaumer domain, 2L independent M-point toeplitz products (the "nuss"
backend of concrete_tpu/core/bootstrap_nuss.py), on the u32 torus (int32
carriers) and the u64 torus (int64 carriers).

The toeplitz ("mxu") backend's table is O(N^2) a step and refuses N > 4096.
Here every polynomial lives as 2L strided chunks of M = N/L coefficients
(math/nussbaumer.py): the negacyclic N-product becomes 2L pointwise M-point
products, O(N^2/L) MACs and table bytes, with rotation-only transforms on
either side. That serves N = 8192 and 16384.

Exactness, as in the JAX package: digits are transformed as wrapping int32;
key chunks are transformed mod 2^(bits + log2(2L)) (int64 for the u32 torus,
128-bit (lo, hi) int64 pairs for the u64 torus) and packed as
limbs_used = ceil((bits + log2(2L)) / 8) balanced byte limbs, so the
recombined products are exact mod 2^(bits + log2(2L)) and the inverse
transform's factor 2L leaves as a right shift.

One CMux step, batch B, chunk-major accumulator acc [k+1, B, L, M]:
    rotdig_fwd_nuss (K7)  rotation by a_hat, digits, zero-pad, forward
                          transform, sub-digit split -> d8 [2L, B, R'*M] int8
    build_tables (K1)     per-frequency toeplitz RHS -> [2L, R'*M, cols] int8,
                          each frequency's matrix column-major
    int_mm, per z         S[z] = d8[z] @ rhs[z]           -> [2L, B, cols] int32
    recombine_inv (K5) /  limb recombine, inverse transform, fold, /2L
    recombine_inv64 (K6)                                  -> [k+1, B, L, M]
    acc += update
d8 is frequency-major, a layout of the port's own: torch._int_mm is 2-D, and
each frequency's operand is then one contiguous matrix (the JAX package's is
[B, 2L, R'*M], for its batched dot_general).

Each kernel wrapper takes its plain PyTorch version when its tensors lie on
the CPU and launches the hand-written CUDA kernel (csrc/nuss_kernels.cu)
when they lie on a CUDA device; `launches` counts the kernel launches.

Example:
    >>> from concrete_tpu_torch.core.bootstrap import ServerConfig
    >>> cfg = ServerConfig(lwe_dimension=100, glwe_dimension=1,
    ...     polynomial_size=8192, pbs_base_log=2, pbs_level=3, ks_base_log=2,
    ...     ks_level=5)
    >>> p = NussPlan.from_config(cfg)
    >>> (p.l, p.m, p.n_sub, p.limbs_used, p.n_words, p.limb_hi_drop)
    (32, 256, 1, 5, 2, 3)
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..math import decomposition, nussbaumer as nb
from ..ops import _cuda, graphs
from ..torus import as_torus, carrier, lshr
from . import bootstrap_mxu as bsx
from . import lwe as lwe_ops
from .bootstrap import (
    ServerConfig,
    rotation_start,
    sample_extract,
    sample_extract_nth,
)

# The JAX package's envelope of its fused Nussbaumer kernels (a compile
# limit of its TPU toolchain). It is kept for two reasons: best_l prefers
# chunkings inside it, which fixes the key layout that both packages must
# share; and the CUDA kernels here are sized for it (section "envelope" of
# csrc/nuss_kernels.cu). Re-deriving both on the H100 is an open item.
KERNEL_TWO_L_MAX = 64

_MIN64 = -(1 << 63)


@dataclasses.dataclass(frozen=True)
class NussPlan:
    """Static layout of the Nussbaumer-domain external product."""

    lwe_dimension: int
    glwe_size: int           # k+1
    polynomial_size: int     # N
    l: int                   # chunk count L (2L transform length)
    base_log: int
    level: int
    n_sub: int               # sub-digit chunks of the transformed digits
    ks_base_log: int
    ks_level: int
    bits: int = 32

    @classmethod
    def best_l(cls, cfg: ServerConfig) -> int:
        """The JAX package's chunk count: among feasible L, prefer 2L <= 64
        (KERNEL_TWO_L_MAX), then the least dot work 2L * n_sub * limbs * M^2,
        ties to the smaller L. The rule fixes the key layout, so it is kept
        exactly as in concrete_tpu (keys converted by either package agree).

        >>> cfg = ServerConfig(lwe_dimension=100, glwe_dimension=1,
        ...     polynomial_size=16384, pbs_base_log=2, pbs_level=3,
        ...     ks_base_log=2, ks_level=5)
        >>> NussPlan.best_l(cfg)
        32
        """
        n = cfg.polynomial_size
        candidates = []
        l = 2
        while l * l <= n:
            m = n // l
            if l * m == n and m % l == 0:
                try:
                    plan = cls.from_config(cfg, l)
                except (NotImplementedError, ValueError):
                    l *= 2
                    continue
                cost = 2 * l * plan.n_sub * plan.limbs_used * m * m
                candidates.append((2 * l > KERNEL_TWO_L_MAX, cost, l))
            l *= 2
        if not candidates:
            raise NotImplementedError(
                f"no feasible Nussbaumer chunking for N={n}")
        return min(candidates)[2]

    @classmethod
    def from_config(cls, cfg: ServerConfig, l: int | None = None) -> "NussPlan":
        if cfg.bits not in (32, 64):
            raise NotImplementedError("nussbaumer path: u32/u64 torus only")
        n = cfg.polynomial_size
        if l is None:
            l = cls.best_l(cfg)
        m = n // l
        if l * m != n or m % l != 0:
            raise ValueError(f"need L | M (N={n}, L={l}, M={m})")
        # transformed digits are sums of L rotated gadget digits:
        # |D| <= L * B/2 = 2^(bl_eff - 1) with bl_eff = bl + log2(L)
        bl_eff = cfg.pbs_base_log + (l.bit_length() - 1)
        n_sub = 1 if bl_eff <= 7 else (bl_eff - 8) // 7 + 2
        plan = cls(
            lwe_dimension=cfg.lwe_dimension,
            glwe_size=cfg.glwe_size,
            polynomial_size=n,
            l=l,
            base_log=cfg.pbs_base_log,
            level=cfg.pbs_level,
            n_sub=n_sub,
            ks_base_log=cfg.ks_base_log,
            ks_level=cfg.ks_level,
            bits=cfg.bits,
        )
        k_rows = plan.row_blocks * plan.m
        if k_rows * 64 * 128 >= 2 ** 31:
            raise NotImplementedError(
                f"int32 accumulation bound exceeded (K={k_rows})")
        if plan.bits == 32 and plan.bits + plan.shift > 64 - plan.shift:
            # the u32 torus is carried in int64 words: (v >> shift) mod
            # 2^bits must lie below the garbage-bit floor
            raise NotImplementedError(f"L={l} too large for u64 carriage")
        return plan

    @property
    def m(self) -> int:
        return self.polynomial_size // self.l

    @property
    def two_l(self) -> int:
        return 2 * self.l

    @property
    def shift(self) -> int:
        """log2(2L): the inverse transform's deferred division."""
        return self.two_l.bit_length() - 1

    @property
    def w_prime(self) -> int:
        """Carried modulus width: results are exact mod 2^w_prime."""
        return self.bits + self.shift

    @property
    def limbs_used(self) -> int:
        return (self.w_prime + 7) // 8

    @property
    def n_words(self) -> int:
        """u32 words per stored transformed key coefficient (2 on the u32
        torus, 3 on the u64 torus): only words holding kept limbs."""
        return (self.limbs_used + 3) // 4

    @property
    def limb_hi_drop(self) -> int:
        return 4 * self.n_words - self.limbs_used

    @property
    def row_blocks(self) -> int:
        """R' per frequency = level * (k+1) * n_sub."""
        return self.level * self.glwe_size * self.n_sub

    def sub_multiplier(self, sub: int) -> int:
        return 1 << (bsx.MxuPlan.SUB_CHUNK_BITS * (self.n_sub - 1 - sub))


# ---------------------------------------------------------------------------
# 128-bit (lo, hi) pairs on int64: the u64 torus carried mod 2^(64 + shift).
# Every carry and borrow is an unsigned compare, made on int64 by flipping
# the sign bit of both sides.
# ---------------------------------------------------------------------------


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit words held in int64."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def _pair_add(al, ah, bl_, bh):
    lo = al + bl_
    return lo, ah + bh + _ult(lo, al).to(torch.int64)


def _pair_sub(al, ah, bl_, bh):
    return al - bl_, ah - bh - _ult(al, bl_).to(torch.int64)


def _pair_neg(lo, hi):
    return -lo, -hi - (lo != 0).to(torch.int64)


def _pair_neg_roll_rows(lo, hi, step: int, shift: int = 0):
    """(lo, hi) row j times Z^(j*step + shift) in R_M
    (nussbaumer._neg_roll_rows on pairs)."""
    idx, neg = nb.twiddle_gather(lo.shape[-2], lo.shape[-1], step, shift,
                                 lo.device)
    idx = idx.expand(lo.shape)
    lo, hi = torch.gather(lo, -1, idx), torch.gather(hi, -1, idx)
    nl, nh = _pair_neg(lo, hi)
    return torch.where(neg, nl, lo), torch.where(neg, nh, hi)


def _pair_forward(lo, hi, l: int):
    """nussbaumer.forward on (lo, hi) pairs: the transform mod 2^128."""
    two_l, m = lo.shape[-2], lo.shape[-1]
    root = m // l
    shape = lo.shape
    for s in range(two_l.bit_length() - 1):
        half = two_l >> (s + 1)
        sub = shape[:-2] + (1 << s, 2 * half, m)
        lr, hr = lo.reshape(sub), hi.reshape(sub)
        al, ah, bl_, bh = (lr[..., :half, :], hr[..., :half, :],
                           lr[..., half:, :], hr[..., half:, :])
        sl, sh = _pair_add(al, ah, bl_, bh)
        dl, dh = _pair_sub(al, ah, bl_, bh)
        tl, th = _pair_neg_roll_rows(dl, dh, root << s)
        lo = torch.stack([sl, tl], dim=-3).reshape(shape)
        hi = torch.stack([sh, th], dim=-3).reshape(shape)
    return lo, hi


def _pair_inverse_fold(lo, hi, l: int):
    """nussbaumer.inverse_raw + fold on (lo, hi) pairs [..., 2L, M]."""
    two_l, m = lo.shape[-2], lo.shape[-1]
    root = m // l
    shape = lo.shape
    for s in reversed(range(two_l.bit_length() - 1)):
        half = two_l >> (s + 1)
        sub = shape[:-2] + (1 << s, 2, half, m)
        lr, hr = lo.reshape(sub), hi.reshape(sub)
        ul, uh = lr[..., 0, :, :], hr[..., 0, :, :]
        vl, vh = _pair_neg_roll_rows(lr[..., 1, :, :], hr[..., 1, :, :],
                                     -(root << s))
        al, ah = _pair_add(ul, uh, vl, vh)
        bl_, bh = _pair_sub(ul, uh, vl, vh)
        lo = torch.cat([al, bl_], dim=-2).reshape(shape)
        hi = torch.cat([ah, bh], dim=-2).reshape(shape)
    zl, zh = _pair_neg_roll_rows(lo[..., l:, :], hi[..., l:, :], 0, 1)
    return _pair_add(lo[..., :l, :], hi[..., :l, :], zl, zh)


# ---------------------------------------------------------------------------
# key conversion, on the key's device
# ---------------------------------------------------------------------------


def _low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 words as int32 bit patterns."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _limb_pack64(w: torch.Tensor) -> torch.Tensor:
    """bootstrap_mxu._limb_pack on u64 words held in int64: balanced signed
    byte limbs, byte m = limb c_m mod 256, the top carry wrapping."""
    for b in range(7, 56, 8):
        w = w + (((w >> b) & 1) << (b + 1))
    return w


def _limb_pack_pair(lo, hi, n_bytes: int):
    """Balanced signed-byte limb packing of (lo, hi) pairs over n_bytes*8
    bits (the JAX package's _np_limb_pack_pair)."""
    for b in range(7, 8 * n_bytes - 8, 8):
        bit = (lshr(lo, b) & 1) if b < 64 else (lshr(hi, b - 64) & 1)
        t = b + 1
        if t < 64:
            nl = lo + (bit << t)
            hi = hi + _ult(nl, lo).to(torch.int64)
            lo = nl
        else:
            hi = hi + (bit << (t - 64))
    return lo, hi


def _slice_rows(plan: NussPlan, n_lwe: int) -> int:
    """Rows of the BSK's n axis converted at once: about 4M transformed
    words, so the temporaries stay at a few hundred MB at N = 16384."""
    per_row = plan.level * plan.glwe_size ** 2 * 2 * plan.polynomial_size
    return max(1, min(n_lwe, (1 << 22) // per_row))


def _rings_slice_u32(plan: NussPlan, bsk: torch.Tensor, rings: torch.Tensor):
    """u32 torus: forward transform mod 2^64 on int64 words, limb packing,
    two word planes; rings [nb, 2L, R', k+1, 2, 2M] written in place."""
    m, ks1 = plan.m, plan.glwe_size
    gz = nb.forward(nb.chunk(bsk.to(torch.int64) & 0xFFFFFFFF, plan.l), plan.l)
    blk = 0
    for lev in range(plan.level):
        for sub in range(plan.n_sub):
            s_m = bsx.MxuPlan.SUB_CHUNK_BITS * (plan.n_sub - 1 - sub)
            for ki in range(ks1):
                g = (gz[:, lev, ki] << s_m).transpose(1, 2)   # [nb, 2L, k+1, M]
                pos, neg = _limb_pack64(g), _limb_pack64(-g)
                for w in range(plan.n_words):
                    rings[:, :, blk, :, w, :m] = _low32(lshr(pos, 32 * w))
                    rings[:, :, blk, :, w, m:] = _low32(lshr(neg, 32 * w))
                blk += 1


def _rings_slice_u64(plan: NussPlan, bsk: torch.Tensor, rings: torch.Tensor):
    """u64 torus: forward transform mod 2^128 on (lo, hi) pairs, limb
    packing over 4*n_words bytes, three word planes."""
    m, ks1 = plan.m, plan.glwe_size
    ch = nb.chunk(bsk, plan.l)
    gz_lo, gz_hi = _pair_forward(ch, torch.zeros_like(ch), plan.l)
    n_bytes = 4 * plan.n_words
    blk = 0
    for lev in range(plan.level):
        for sub in range(plan.n_sub):
            s_m = bsx.MxuPlan.SUB_CHUNK_BITS * (plan.n_sub - 1 - sub)
            for ki in range(ks1):
                lo, hi = gz_lo[:, lev, ki], gz_hi[:, lev, ki]
                if s_m:                               # x 2^(7 * sub weight)
                    hi = (hi << s_m) | lshr(lo, 64 - s_m)
                    lo = lo << s_m
                lo, hi = lo.transpose(1, 2), hi.transpose(1, 2)
                packed = (_limb_pack_pair(lo, hi, n_bytes),
                          _limb_pack_pair(*_pair_neg(lo, hi), n_bytes))
                for half, (p_lo, p_hi) in zip((slice(None, m), slice(m, None)),
                                              packed):
                    for w in range(plan.n_words):
                        src = p_lo if w < 2 else p_hi
                        rings[:, :, blk, :, w, half] = _low32(
                            lshr(src, 32 * (w % 2)))
                blk += 1


def bsk_to_nuss(bsk_data, cfg: ServerConfig, l: int | None = None, *,
                device=None) -> torch.Tensor:
    """[n, l, k+1, k+1, N] u32 / u64 BSK -> Nussbaumer-domain toeplitz rings
    [n, 2L*R', (k+1)*n_words, 2M] int32 (the JAX package's u32 words, byte
    for byte), computed on the key's device: `device`, else the tensor's
    own, else the CPU for numpy input.

    Per frequency z (bit-reversed transform order) and row block
    (lev, sub, ki), a ring holds the balanced byte limbs of +/- G_z *
    2^(7*sub_weight), G_z = forward(chunk(g)) mod 2^(64 or 128); K1 keeps
    limbs 0 .. limbs_used-1. The n axis is converted in slices, so the
    temporaries stay bounded."""
    plan = NussPlan.from_config(cfg, l)
    bsk = as_torus(bsk_data, device, plan.bits)
    n_lwe, ks1 = bsk.shape[0], plan.glwe_size
    expect = (n_lwe, plan.level, ks1, ks1, plan.polynomial_size)
    if tuple(bsk.shape) != expect:
        raise ValueError(f"bsk: shape {tuple(bsk.shape)}, expected {expect}")
    rings = torch.empty((n_lwe, plan.two_l, plan.row_blocks, ks1, plan.n_words,
                         2 * plan.m), dtype=torch.int32, device=bsk.device)
    convert = _rings_slice_u32 if plan.bits == 32 else _rings_slice_u64
    step = _slice_rows(plan, n_lwe)
    for i0 in range(0, n_lwe, step):
        convert(plan, bsk[i0:i0 + step], rings[i0:i0 + step])
    return rings.reshape(n_lwe, plan.two_l * plan.row_blocks,
                         ks1 * plan.n_words, 2 * plan.m)


# ---------------------------------------------------------------------------
# the front half: digits and their forward transform
# ---------------------------------------------------------------------------


def _digit_matrix_nuss(plan: NussPlan, diff_cm: torch.Tensor) -> torch.Tensor:
    """Gadget-decompose chunk-major diff [k+1, B, L, M] (int32 / int64),
    transform each digit polynomial (already chunked), split the grown
    digits into balanced 7-bit chunks -> d8 [2L, B, R'*M] int8, column
    blocks in the (lev, sub, ki) order of bsk_to_nuss. The transform runs
    in wrapping int32: where the JAX package takes int16 (bl_eff <= 14) the
    values fit, so the bytes are the same."""
    digits = decomposition.decompose_rounded(
        diff_cm, plan.base_log, plan.level).to(torch.int32)  # [k+1, B, L, M, lv]
    parts = []
    for lev in range(plan.level):
        d = digits[..., lev]
        dz = nb.forward(torch.cat([d, torch.zeros_like(d)], dim=-2), plan.l)
        for dsub in bsx._split_subdigits(dz, plan.n_sub):
            parts.extend(dsub[ki].transpose(0, 1).to(torch.int8)
                         for ki in range(diff_cm.shape[0]))   # [2L, B, M]
    return torch.cat(parts, dim=-1).contiguous()


def rotdig_fwd_nuss_plain(plan: NussPlan, acc_cm: torch.Tensor,
                          a_hat: torch.Tensor) -> torch.Tensor:
    """d8 [2L, B, R'*M] of X^a_hat * acc - acc, acc chunk-major
    [k+1, B, L, M] int32 (u32 torus) or int64 (u64 torus), a_hat [B] int32
    (read mod 2N): monomial_mul_chunked + _digit_matrix_nuss."""
    rot = nb.monomial_mul_chunked(acc_cm, a_hat[None, :], plan.l)
    return _digit_matrix_nuss(plan, rot - acc_cm)


def _in_envelope(plan: NussPlan) -> bool:
    return plan.two_l <= KERNEL_TWO_L_MAX


def rotdig_fwd_nuss(plan: NussPlan, acc_cm: torch.Tensor, a_hat: torch.Tensor,
                    *, out: torch.Tensor | None = None) -> torch.Tensor:
    """K7, rotation + digits + forward transform + sub-digit split of one
    CMux step (rotdig_fwd_nuss_plain), on both tori: one CUDA kernel,
    instantiated on u32 and u64 accumulators.

    The kernel covers 2L <= KERNEL_TWO_L_MAX, every chunking best_l picks.
    For an explicit L beyond it the plain composition runs on the card, as
    the JAX package runs its XLA composition there: that is the reference's
    own routing rule, not a fallback from a failed kernel."""
    ks1, b = acc_cm.shape[:2]
    shape = (plan.two_l, b, plan.row_blocks * plan.m)
    bsx._check(acc_cm, "acc", carrier(plan.bits),
               (plan.glwe_size, b, plan.l, plan.m))
    bsx._check(a_hat, "a_hat", torch.int32, (b,))
    if out is not None:
        bsx._check(out, "out", torch.int8, shape)
    if bsx._on_cpu(acc_cm, a_hat, out) or not _in_envelope(plan):
        res = rotdig_fwd_nuss_plain(plan, acc_cm, a_hat)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=torch.int8, device=acc_cm.device)
    if b:
        bsx._check_kernel_operands(plan.polynomial_size, acc_cm, out)
        entry = "ctt_rotdig_fwd_nuss" if plan.bits == 32 else \
            "ctt_rotdig_fwd_nuss64"
        _cuda.launch(entry, acc_cm, a_hat, out, b, ks1, plan.l, plan.m,
                     plan.base_log, plan.level, plan.n_sub)
        _cuda.count_launch(rotdig_fwd_nuss, B=b, ks1=ks1, L=plan.l, M=plan.m,
                           bits=plan.bits, bl=plan.base_log, l=plan.level,
                           n_sub=plan.n_sub)
    return out


_cuda.counter(rotdig_fwd_nuss)


# ---------------------------------------------------------------------------
# the back half: limb recombine, inverse transform, fold, /2L
# ---------------------------------------------------------------------------


def recombine_inv_plain(plan: NussPlan, s: torch.Tensor) -> torch.Tensor:
    """u32 torus: dot output s [2L, B, (k+1)*lu*M] int32 -> update
    [k+1, B, L, M] int32 (chunk-major). Each frequency's limbs recombine in
    int64 (exact mod 2^64 > 2^w_prime, sign-extended as the JAX kernel's
    arithmetic shift), then the inverse transform, the fold mod (Y^L - Z),
    and /2L as a logical right shift; the low 32 bits are the update."""
    m, lu = plan.m, plan.limbs_used
    outs = []
    for kj in range(plan.glwe_size):
        base = kj * lu * m
        o = s[..., base:base + m].to(torch.int64)
        for j in range(1, lu):
            c0 = base + j * m
            o = o + (s[..., c0:c0 + m].to(torch.int64) << (8 * j))
        outs.append(o)
    oz = torch.stack(outs, dim=0).transpose(1, 2)        # [k+1, B, 2L, M]
    c = nb.fold(nb.inverse_raw(oz, plan.l), plan.l)
    return _low32(lshr(c, plan.shift))


def recombine_inv64_plain(plan: NussPlan, s: torch.Tensor) -> torch.Tensor:
    """u64 torus: s [2L, B, (k+1)*lu*M] int32 -> update [k+1, B, L, M]
    int64. Limbs recombine into (lo, hi) pairs, exact mod 2^(64 + shift);
    inverse transform and fold on the pairs; the shift joins the pair into
    (lo >> shift) | (hi << (64 - shift))."""
    m, lu = plan.m, plan.limbs_used
    los, his = [], []
    for kj in range(plan.glwe_size):
        base = kj * lu * m
        lo = torch.zeros(s.shape[:-1] + (m,), dtype=torch.int64,
                         device=s.device)
        hi = torch.zeros_like(lo)
        for j in range(lu):
            t = 8 * j
            sm = s[..., base + j * m:base + (j + 1) * m].to(torch.int64)
            if t == 0:
                c_lo, c_hi = sm, sm >> 63
            elif t < 64:
                c_lo, c_hi = sm << t, sm >> (64 - t)
            else:
                c_lo, c_hi = torch.zeros_like(sm), sm << (t - 64)
            lo, hi = _pair_add(lo, hi, c_lo, c_hi)
        los.append(lo)
        his.append(hi)
    lo = torch.stack(los, dim=0).transpose(1, 2)         # [k+1, B, 2L, M]
    hi = torch.stack(his, dim=0).transpose(1, 2)
    lo, hi = _pair_inverse_fold(lo, hi, plan.l)
    return lshr(lo, plan.shift) | (hi << (64 - plan.shift))


def _recombine_launch(kernel, entry: str, plain, bits: int, plan: NussPlan,
                      s, out):
    """The shared wrapper of K5 (u32 torus, int32 update) and K6 (u64 torus,
    int64 update)."""
    if plan.bits != bits:
        raise TypeError(f"{kernel.__name__} runs the u{bits} torus, the plan "
                        f"is u{plan.bits}")
    b = s.shape[1]
    dtype = carrier(bits)
    shape = (plan.glwe_size, b, plan.l, plan.m)
    bsx._check(s, "s", torch.int32, (plan.two_l, b, plan.glwe_size *
                                     plan.limbs_used * plan.m))
    if out is not None:
        bsx._check(out, "out", dtype, shape)
    if bsx._on_cpu(s, out) or not _in_envelope(plan):
        res = plain(plan, s)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=s.device)
    if b:
        bsx._check_kernel_operands(plan.polynomial_size, s, out)
        _cuda.launch(entry, s, out, b, plan.glwe_size, plan.limbs_used,
                     plan.l, plan.m, plan.shift)
        _cuda.count_launch(kernel, B=b, ks1=plan.glwe_size, L=plan.l, M=plan.m,
                           limbs=plan.limbs_used)
    return out


def recombine_inv(plan: NussPlan, s: torch.Tensor, *,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """K5, the u32 torus's limb recombine + inverse transform + fold + /2L
    (recombine_inv_plain). The kernel covers 2L <= KERNEL_TWO_L_MAX; beyond
    it the plain composition runs on the card, the JAX package's own
    routing rule (its XLA form), not a fallback from a failed kernel."""
    return _recombine_launch(recombine_inv, "ctt_recombine_inv",
                             recombine_inv_plain, 32, plan, s, out)


def recombine_inv64(plan: NussPlan, s: torch.Tensor, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K6, recombine_inv on the u64 torus (recombine_inv64_plain), exact
    mod 2^(64 + shift); the same envelope rule as K5."""
    return _recombine_launch(recombine_inv64, "ctt_recombine_inv64",
                             recombine_inv64_plain, 64, plan, s, out)


_cuda.counter(recombine_inv)
_cuda.counter(recombine_inv64)

KERNELS = (recombine_inv, recombine_inv64, rotdig_fwd_nuss)


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
# the CMux step, blind rotation, bootstrap
# ---------------------------------------------------------------------------


def _step_buffers(plan: NussPlan, b: int, device, blocks: int | None = None):
    """The per-step d8 / RHS / S buffers, allocated once per rotation; the
    RHS holds `blocks` row blocks of each frequency (a tensor-parallel
    rank's) or all R'."""
    rows = plan.row_blocks * plan.m
    cols = plan.glwe_size * plan.limbs_used * plan.m
    d8 = torch.empty((plan.two_l, b, rows), dtype=torch.int8, device=device)
    rhs = bsx.table_buffer(
        (plan.row_blocks if blocks is None else blocks) * plan.m, cols,
        plan.two_l, device=device)
    s = torch.empty((plan.two_l, b, cols), dtype=torch.int32, device=device)
    return d8, rhs, s


def _dot_recombine_nuss(plan: NussPlan, rings, d8, rhs=None, s=None,
                        block0: int = 0, reduce=None):
    """Per-frequency table build (K1) + one int8 product per frequency +
    recombine (K5 / K6): the tail of one CMux given d8 [2L, B, R'*M]. A
    tensor-parallel rank passes its ring blocks (R'/tp of each frequency,
    from block `block0` on) and `reduce`, which sums the partial products
    over its tp group before the recombine (bootstrap_mxu.step_dot)."""
    rhs = bsx.build_tables(rings, plan.m, 0, plan.n_words, plan.limb_hi_drop,
                           groups=plan.two_l, out=rhs)
    if s is None:
        s = torch.empty((plan.two_l, d8.shape[1], rhs.shape[-1]),
                        dtype=torch.int32, device=d8.device)
    s = bsx.step_dot(d8, rhs, s, block0 * plan.m, reduce)
    recombine = recombine_inv if plan.bits == 32 else recombine_inv64
    return recombine(plan, s)


def rotate_nuss(plan: NussPlan, bsk_rings, acc, a_hats, block0: int = 0,
                reduce=None):
    """The CMux chain from the start accumulator acc [k+1, B, N], which
    stays chunk-major [k+1, B, L, M] for the whole loop. bsk_rings [n,
    2L*R'', (k+1)*n_words, 2M] holds R'' = R' row blocks of each frequency,
    or a tensor-parallel rank's R'/tp from block `block0` on, whose partial
    products `reduce` sums (_dot_recombine_nuss)."""
    acc = nb.chunk(acc, plan.l)[..., :plan.l, :].contiguous()
    d8, rhs, s = _step_buffers(plan, acc.shape[1], acc.device,
                               bsk_rings.shape[1] // plan.two_l)
    for i in range(a_hats.shape[0]):
        rotdig_fwd_nuss(plan, acc, a_hats[i], out=d8)
        acc += _dot_recombine_nuss(plan, bsk_rings[i], d8, rhs, s, block0,
                                   reduce)
    return nb.unchunk(acc, plan.l)


def external_product_nuss(cfg: ServerConfig, rings, glwe, l: int | None = None):
    """Nussbaumer-domain external product: glwe [..., k+1, N] in the torus
    carrier, rings [2L*R', (k+1)*n_words, 2M] int32 (one step of
    bsk_to_nuss) -> the product GGSW x GLWE, [..., k+1, N]."""
    plan = NussPlan.from_config(cfg, l)
    lead = glwe.shape[:-2]
    flat = glwe.reshape((-1,) + tuple(glwe.shape[-2:])).transpose(0, 1)
    cm = nb.chunk(flat, plan.l)[..., :plan.l, :]
    d8 = _digit_matrix_nuss(plan, cm)
    out = nb.unchunk(_dot_recombine_nuss(plan, rings, d8), plan.l)
    return out.transpose(0, 1).reshape(glwe.shape)


def blind_rotate_nuss(cfg: ServerConfig, bsk_rings: torch.Tensor,
                      lut: torch.Tensor, lwe: torch.Tensor, *,
                      l: int | None = None, ms_offset: int = 0,
                      lut_count_log: int = 0) -> torch.Tensor:
    """Blind rotation with the Nussbaumer-domain CMux chain, bit-identical
    to concrete_tpu's blind_rotate_nuss (and to the mxu path). bsk_rings
    [n, 2L*R', (k+1)*n_words, 2M] int32 (bsk_to_nuss); lut [..., k+1, N] and
    lwe [..., n+1] in the torus carrier. The accumulator stays chunk-major
    [k+1, B, L, M] for the whole loop."""
    plan = NussPlan.from_config(cfg, l)
    n_lwe, N, ks1 = cfg.lwe_dimension, plan.polynomial_size, plan.glwe_size
    if tuple(bsk_rings.shape) != (n_lwe, plan.two_l * plan.row_blocks,
                                  ks1 * plan.n_words, 2 * plan.m):
        raise ValueError(f"bsk_rings: shape {tuple(bsk_rings.shape)} does "
                         "not match the configuration")
    if lwe.shape[-1] != n_lwe + 1 or tuple(lut.shape[-2:]) != (ks1, N):
        raise ValueError("lwe / lut shapes do not match the configuration")
    if lwe.dtype != carrier(plan.bits) or lut.dtype != lwe.dtype:
        raise TypeError(f"u{plan.bits} torus tensors are {carrier(plan.bits)}")
    lead = lwe.shape[:-1]
    acc, a_hats = rotation_start(lut, lwe, N, ms_offset, lut_count_log)
    out = rotate_nuss(plan, bsk_rings, acc, a_hats)
    return out.transpose(0, 1).reshape(lead + (ks1, N))


def bootstrap_nuss(cfg: ServerConfig, bsk_rings, lut, lwe, *,
                   l: int | None = None):
    """Full PBS on the Nussbaumer path (fourier/mod.rs:878-911)."""
    return sample_extract(blind_rotate_nuss(cfg, bsk_rings, lut, lwe, l=l))


def bootstrap_many_lut_nuss(cfg: ServerConfig, bsk_rings, lut, lwe,
                            lut_count_log: int, *, ms_offset: int = 0,
                            l: int | None = None):
    """Multi-LUT PBS on the Nussbaumer path: one blind rotation,
    2^lut_count_log extractions -> [2^lcl, ..., k*N+1]."""
    acc = blind_rotate_nuss(cfg, bsk_rings, lut, lwe, l=l,
                            ms_offset=ms_offset, lut_count_log=lut_count_log)
    return torch.stack(
        [sample_extract_nth(acc, t) for t in range(1 << lut_count_log)], dim=0)


def bootstrap_keyswitch_nuss(cfg: ServerConfig, bsk_rings, ksk8, lut, lwe, *,
                             l: int | None = None):
    """PBS + keyswitch, the per-gate pipeline (server_key/mod.rs:133-166),
    against a limb-prepared keyswitch key (lwe.ksk_to_limbs; any ks_base_log,
    lwe.keyswitch_prepared)."""
    big = bootstrap_nuss(cfg, bsk_rings, lut, lwe, l=l)
    return lwe_ops.keyswitch_prepared(ksk8, big, base_log=cfg.ks_base_log,
                                      level_count=cfg.ks_level)


@functools.lru_cache(maxsize=None)
def jit_bootstrap_keyswitch_nuss(cfg: ServerConfig,
                                 l: int | None = None) -> graphs.GraphedCall:
    """bootstrap_keyswitch_nuss for `cfg` (chunk count `l`) in one dispatch,
    as concrete_tpu's jitted one: fn(bsk_rings, ksk8, lut, lwe), one CUDA
    graph per signature on CUDA tensors (ops/graphs.py; bsk_rings and ksk8
    read where they lie, lut and lwe copied in), the eager function on CPU
    tensors. Both tori."""
    return graphs.GraphedCall(
        functools.partial(bootstrap_keyswitch_nuss, cfg, l=l), 2,
        name="bootstrap_keyswitch_nuss")
