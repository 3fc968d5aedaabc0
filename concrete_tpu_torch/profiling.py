"""Profiling and roofline accounting for the port's server-side kernels on
an NVIDIA H100.

The counterpart of concrete_tpu/profiling.py, built for the card: the work
of a call (32-bit integer instructions by pipe, int8 tensor operations and
HBM bytes) against the card's peak rates gives the least time the card
could take (`Roofline.bound_seconds`, `bound_ms`); `time_ms` (device time,
a CUDA graph between CUDA events), `median_s` and `measure` (synchronised
host medians) and `profile_call` (torch.profiler) measure it.
chip_smoke.py takes its bounds and timers from here.

The rates are the H100 SXM's published peaks: HBM at 3.35 TB/s; the int8
tensor cores at 1,979 TOP/s (dense); the integer pipes per clock and SM of
compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
throughput; Nsight Compute's pipe definitions): 64 lanes of 32-bit
multiplies (IMAD, the FMA pipe), 64 lanes of compares, min/max, selects and
logic (the ALU pipe), adds on either pipe, and 128 lanes of issue over both,
x 132 SMs x the 1,980 MHz boost clock; and, for work counted only as one
operation an output element, the float32 non-tensor rate of 67 T/s.

Example:
    >>> from concrete_tpu_torch.profiling import ntt_roofline, report_pbs_efficiency
    >>> ntt_roofline(1024, 2, 2, 256).bound_seconds() > 0
    True
    >>> from concrete_tpu_torch.params import TFHE_LIB_PARAMETERS
    >>> from concrete_tpu_torch.core.bootstrap import ServerConfig
    >>> cfg = ServerConfig.from_boolean_parameters(TFHE_LIB_PARAMETERS)
    >>> r = report_pbs_efficiency(cfg, 2048, 0.2)
    >>> sorted(r), 0 < r["efficiency"] < 1
    (['efficiency', 'hbm_bytes', 'int8_ops', 'lane_ops', 'measured_s', 'speed_of_light_s'], True)
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

# the H100 SXM's published peaks: HBM bytes/s, its float32 non-tensor rate
# (taken for work counted as one ALU operation an output), the dense int8
# tensor rate (hopper-kernels guide)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12
# the integer pipes: lanes per clock and SM, x 132 SMs x 1,980 MHz
SM_CLOCKS_PER_S = 132 * 1.98e9
PIPE_LANES, ISSUE_LANES = 64, 128
# the fewest instructions an operation needs, as (multiplies, adds,
# ALU-only): a Montgomery product is IMAD.WIDE a*b, IMAD m = lo*n' and
# IMAD.WIDE m*p + a*b (whose high word is the REDC sum), then t - p and an
# unsigned min; a modular add or subtract is the sum, the sum minus p or
# plus p, and an unsigned min; two MAC terms share one lazy REDC: a*b and
# IMAD.WIDE c*d + a*b (their sum < 2p^2), the REDC's two multiplies and a
# 64-bit add into the running sum, whose one reduction per output is a
# Montgomery product's cost; the Garner step of one coefficient is a
# modular subtract, a reduction of x1 mod p1 (add, min), a Montgomery
# product, x1 + p0*x2 (one IMAD), the compare with ceil(M/2) (two), its
# conditional subtract and the add into acc. (concrete_tpu's MONT_MUL_OPS =
# 12 counts the TPU's emulated 32 x 32 -> 64 multiply, which the card has.)
MONT, MODADD, MAC_PAIR, GARNER = (3, 1, 1), (0, 2, 1), (4, 2, 0), (4, 6, 5)
# K4's fewest instructions a coefficient, as (multiplies, adds, ALU-only):
# the gather (c - a and the shared address: two adds; the index mask, the
# wrap bit and the negate's xor of both words: four ALU) and the rounded
# difference (v ^ m) - m - x + half (four adds with carries); the prefix's
# shift (one ALU, two when it is wider than 32 bits); a level on the 32-bit
# state: res, st, the carry's bits and their shift (four ALU), res - 1 and
# st + carry (two adds), the digit res - carry * 2^base_log (a multiply);
# the last level needs no st (three ALU, an add, a multiply); a level on
# the 64-bit state: st and st + carry on two words (five ALU, three adds, a
# multiply); a balanced 7-bit sub-digit: (d + 64) >> 7 and d - 128 * that
# (an add, a shift, a multiply); three byte permutes pack four digits
# (0.75 ALU a coefficient, a level and sub-digit)
GATHER64, LEVEL32, LAST32, LEVEL64 = (0, 6, 4), (1, 2, 4), (1, 1, 3), (1, 3, 5)
SUBDIGIT, PACK = (1, 1, 1), (0, 0, 0.75)


def int_ops_s(mul: float, add: float, alu: float) -> float:
    """Seconds the card needs at least for these 32-bit integer
    instructions: each pipe at its rate, both within the issue rate."""
    return max(mul / PIPE_LANES, alu / PIPE_LANES,
               (mul + add + alu) / ISSUE_LANES) / SM_CLOCKS_PER_S


def _weighted(count: dict) -> tuple:
    return tuple(sum(c * op[i] for op, c in count.items()) for i in range(3))


def ntt_cmux_work(cfg, b: int, primes: int = 2) -> tuple[int, tuple]:
    """(Montgomery products, instructions as (multiplies, adds, ALU-only))
    of one NTT-domain CMux step (K9 with two primes) at batch b: per row,
    l*(k+1) forward NTTs per prime (twist + N/2 log2 N butterflies, each a
    product, an add and a subtract), the MAC of each against k+1 key
    spectra (terms in pairs, one reduction per output), (k+1) inverse NTTs
    per prime (butterflies + untwist) and the Garner recombination
    (primes - 1 steps a coefficient). The digit extraction and rotation
    are not counted."""
    n, ks1, lv, p = cfg.polynomial_size, cfg.glwe_size, cfg.pbs_level, primes
    butterflies = n // 2 * (n.bit_length() - 1)
    fwd, inv = b * ks1 * lv * p, b * ks1 * p
    macs = fwd * ks1 * n
    garner = b * ks1 * n * (p - 1)
    products = (fwd + inv) * (n + butterflies) + macs + garner
    count = {MONT: (fwd + inv) * (n + butterflies) + inv * n,
             MODADD: (fwd + inv) * 2 * butterflies,
             MAC_PAIR: macs // 2, GARNER: garner}
    return products, _weighted(count)


def rotdig64_work(plan) -> tuple[float, float, float]:
    """K4's fewest 32-bit instructions a coefficient, as (multiplies, adds,
    ALU-only), at the plan's gadget: the levels that run on the 64-bit
    state until the bits left fit 32, then on the 32-bit state (the costs
    above). Times b * (k+1) * N coefficients for a launch."""
    bl, lv, ns = plan.base_log, plan.level, plan.n_sub
    prefix = bl * lv
    wide = max(0, -(-(prefix - 32) // bl))
    return _weighted({GATHER64: 1, (0, 0, 2 if prefix > 32 else 1): 1,
                      LEVEL64: wide, LEVEL32: lv - 1 - wide, LAST32: 1,
                      SUBDIGIT: lv * (ns - 1), PACK: lv * ns})


def mxu_gemm_ops(plan, b: int) -> int:
    """int8 operations (2 a MAC) of the CMux products of one toeplitz blind
    rotation at batch b: per step [b, R*N] x [R*N, (k+1)*limbs*N]."""
    n = plan.polynomial_size
    return (2 * plan.lwe_dimension * b * plan.row_blocks * n
            * plan.glwe_size * plan.limbs_used * n)


def nuss_gemm_ops(plan, b: int) -> int:
    """The same for the Nussbaumer path: 2L products a step, each
    [b, R'*M] x [R'*M, (k+1)*limbs*M]."""
    m = plan.m
    return (2 * plan.lwe_dimension * plan.two_l * b * plan.row_blocks * m
            * plan.glwe_size * plan.limbs_used * m)


def bound_ms(inputs, outputs, op_s=None) -> tuple[float, str]:
    """The least time the card could take for a kernel call: each input
    read once and each output written once at the HBM rate, against the
    kernel's operations at their peak rate (`op_s` seconds: int8 MACs at
    the tensor rate, integer instructions at the pipes' rates, int_ops_s),
    else one ALU operation per output element (a lower bound on the work)
    at the float32 rate. Returns (ms, "bytes" or "operations")."""
    moved = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    by_bytes = moved / HBM_BYTES_PER_S
    by_ops = (sum(t.numel() for t in outputs) / ALU_OPS_PER_S if op_s is None
              else op_s)
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


@dataclasses.dataclass
class Roofline:
    """Work accounting for one op invocation: 32-bit integer instructions
    as (multiplies, adds, ALU-only), int8 tensor operations (2 a MAC) and
    the fewest HBM bytes (inputs and outputs once)."""

    name: str
    int_instr: tuple = (0, 0, 0)
    hbm_bytes: float = 0.0
    int8_ops: float = 0.0

    @property
    def lane_ops(self) -> float:
        """All integer instructions, lanes counted one each."""
        return float(sum(self.int_instr))

    def bound_seconds(self, hbm_bytes_per_s: float = HBM_BYTES_PER_S,
                      int8_ops_per_s: float = INT8_TENSOR_OPS_PER_S) -> float:
        """Speed-of-light time on the H100: the largest of the integer
        instructions at the pipes' rates (int_ops_s), the int8 operations at
        the tensor rate (1,979 TOP/s) and the bytes at the HBM rate (3.35
        TB/s); pass other rates for another part."""
        return max(int_ops_s(*self.int_instr),
                   self.int8_ops / int8_ops_per_s,
                   self.hbm_bytes / hbm_bytes_per_s)


def ntt_roofline(n: int, n_polys: int, n_primes: int, batch: int) -> Roofline:
    """One batched forward (or inverse) negacyclic NTT of `n_polys`
    polynomials a row over `n_primes` primes: twist + N/2 log2 N butterflies
    a polynomial, counted with the Montgomery product of ntt_cmux_work."""
    butterflies = n // 2 * (n.bit_length() - 1)
    polys = batch * n_polys * n_primes
    instr = _weighted({MONT: polys * (n + butterflies),
                       MODADD: polys * 2 * butterflies})
    return Roofline("ntt", instr, polys * n * 4 * 2)


def external_product_roofline(cfg, batch: int) -> Roofline:
    """One batched NTT-domain external product (the K9 step's transforms,
    MAC and Garner, ntt_cmux_work, over len(cfg.primes) primes): bytes are
    the key spectra and the accumulator in and out."""
    n, ks1, lv = cfg.polynomial_size, cfg.glwe_size, cfg.pbs_level
    p = len(cfg.primes)
    _, instr = ntt_cmux_work(cfg, batch, p)
    ggsw_bytes = lv * ks1 * ks1 * p * n * 4
    io_bytes = batch * ks1 * n * 4 * 2 + ggsw_bytes
    return Roofline("external_product", instr, io_bytes)


def pbs_roofline(cfg, batch: int) -> Roofline:
    """A PBS on the ntt backend: lwe_dimension external-product steps (the
    rotation and digits, a few instructions a coefficient, not counted)."""
    ep = external_product_roofline(cfg, batch)
    n_iter = cfg.lwe_dimension
    return Roofline("pbs", tuple(n_iter * x for x in ep.int_instr),
                    n_iter * ep.hbm_bytes)


def mxu_external_product_roofline(n_iterations: int, poly_size: int,
                                  glwe_size: int, level: int, n_sub: int,
                                  n_limbs: int, batch: int) -> Roofline:
    """Blind rotation on the toeplitz path (core/bootstrap_mxu.py): per
    step the int8 product [B, R*N] x [R*N, (k+1)*n_limbs*N], R =
    level*(k+1)*n_sub, at the tensor rate; HBM traffic per step: the table
    written and read, the dot output written and read, the digit matrix and
    the accumulator update."""
    rows = level * glwe_size * n_sub * poly_size
    cols = glwe_size * n_limbs * poly_size
    macs = n_iterations * batch * rows * cols
    per_iter_hbm = (2 * rows * cols + 2 * batch * cols * 4 + batch * rows
                    + 3 * glwe_size * batch * poly_size * 4)
    return Roofline(f"mxu_blind_rotate(N={poly_size}, B={batch})",
                    hbm_bytes=float(n_iterations * per_iter_hbm),
                    int8_ops=2.0 * macs)


def report_pbs_efficiency(cfg, batch: int, measured_seconds: float) -> dict:
    """A measured ntt PBS time against pbs_roofline's bound. A plain
    function returning the dict (concrete_tpu decorates it as a context
    manager, under which it cannot be used)."""
    rl = pbs_roofline(cfg, batch)
    sol = rl.bound_seconds()
    return {
        "lane_ops": rl.lane_ops,
        "int8_ops": rl.int8_ops,
        "hbm_bytes": rl.hbm_bytes,
        "speed_of_light_s": sol,
        "measured_s": measured_seconds,
        "efficiency": sol / measured_seconds if measured_seconds else 0.0,
    }


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 20) -> float:
    """Device ms per call: `reps` calls captured once in a CUDA graph and
    the graph replayed between two CUDA events, so the Python launch path
    (wrapper checks, ctypes) is not counted, only the kernels. CUDA only."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(fn) -> float:
    """Device ms of one call of `fn` between two CUDA events on the current
    stream: its kernels and the gaps between them, from the first to the
    last. CUDA only."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def median_s(fn, reps: int = 5) -> float:
    """Median host seconds of `reps` calls, each between two device
    synchronisations."""
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure(fn, *args, reps: int = 3) -> float:
    """Median seconds of fn(*args) after one warm-up call (device
    synchronised)."""
    fn(*args)
    return median_s(lambda: fn(*args), reps)


# device kernels by name, as the profiler shows them (demangled): the
# port's, then the int8 GEMM that torch._int_mm runs
KERNEL_KINDS = (("ntt_cmux_kernel", "K9 ntt_cmux"),
                ("ntt_cmux_warp_kernel", "K9 ntt_cmux"),
                ("fused_cmux_kernel", "K8 fused_cmux"),
                ("build_tables", "K1 build_tables"),
                ("rotdig_recombine", "K3 rotdig_recombine"),
                ("rotdig64_kernel", "K4 rotdig64"),
                ("rotdig_kernel", "K2 rotdig"),
                ("recombine_inv_kernel<unsigned long, unsigned int",
                 "K5 recombine_inv"),
                ("recombine_inv_kernel", "K6 recombine_inv64"),
                ("rotdig_fwd_nuss_kernel", "K7 rotdig_fwd_nuss"),
                ("gemm", "int8 GEMM"), ("cutlass", "int8 GEMM"))


def profile_call(fn, gemm_ops=None) -> dict:
    """One call of `fn` under torch.profiler: device time summed by kernel
    kind (KERNEL_KINDS) and the device operations it saw (kernels, copies,
    memsets).
    With `gemm_ops`, the int8 operations of the call's CMux products, also
    the int8 GEMM's rate in TOP/s (its device time includes a gate's
    keyswitch product). CUDA only."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, events = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for pat, k in KERNEL_KINDS if pat in evt.key),
                    "other (torch elementwise, copies)")
        kinds[kind] = kinds.get(kind, 0.0) + evt.self_device_time_total / 1e3
        events += evt.count
    out = {"wall_ms": wall_ms, "device_ms": sum(kinds.values()),
           "device_events": events}
    if gemm_ops and kinds.get("int8 GEMM"):
        out["gemm_tops"] = gemm_ops / (kinds["int8 GEMM"] * 1e-3) / 1e12
    out["device_ms_by_kind"] = dict(sorted(kinds.items(), key=lambda kv: -kv[1]))
    return out
