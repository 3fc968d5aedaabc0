#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of concrete-tpu once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc; it imports no JAX. The phases, in order:

  build   compile csrc/mxu_kernels.cu, nuss_kernels.cu, fused_kernels.cu and
          ntt_kernels.cu for sm_90a, one nvcc each, in parallel
          (concrete_tpu_torch/_build/).
  A       each hand-written kernel against its plain PyTorch version on the
          card, at the shapes of the main paths, bit for bit, with both
          device times (CUDA graph replay between CUDA events), the least
          time the card could take for the same work and the share of it
          reached (K8 also its T MAC/s and share of the int8 tensor rate).
  B       a boolean-gate server at full width (u32 torus) on the toeplitz
          backend, named (backend="mxu"; "auto" resolves to ntt on the u32
          torus, logged per preset): for TPU128,
          DEFAULT and TFHE_LIB parameters, key generation from fixed seeds,
          warmup of the batch tiers, then requests of mixed sizes through
          AND, XOR, NAND and MUX, every row decrypted against its truth
          table; a TFHE_LIB fast-mode key (levels=2) through AND and XOR;
          32 rows of one TPU128 AND request recomputed through the port on
          the CPU must match the card bit for bit; every u32 kernel's launch
          count over this phase must be > 0; the median time of 5 gate calls
          per (parameters, tier), and one profiled AND per preset at B=2048
          with the int8 GEMM's TOP/s.
  C       the high-level API at the full width of examples/int4_lut.py (u64
          torus: LWE128_630, RLWE128_1024_1, PBS base_log 7 level 3, KSK
          base_log 2 level 8): 2048 encrypted 4-bit values through the LUT
          x -> (3x + 1) mod 16, exact and in fast mode (limb_drop=2), then
          keyswitched back to the small key; one multi-LUT call with two
          functions; every PBS output row must decode right under the big
          key, and the keyswitched rows must match the noise model (phase
          std and wrong-row rate, see phase_c); the first 16 CMux steps for
          32 rows and 64 keyswitched rows recomputed on the CPU must match
          the card bit for bit; build_tables and rotdig64 must launch; the
          median time of 5 PBS calls (exact and fast) and of a keyswitch.
  D       the Nussbaumer backend (N > 4096 and any N by request): AND and
          XOR on a backend="nuss" twin of a TFHE_LIB key, 2048 rows, every
          row on its truth table and equal to the mxu backend's; the int4
          LUT of phase C at N = 8192 through the high-level API (LWE128_630,
          RLWEParams(8192, 1, -62), PBS base_log 7 level 3, u64), 256 values
          plus one multi-LUT call, every PBS row decoded under the big key;
          the JAX suite's engine rows (benchmarks/suite.py "nuss": n=100,
          k=1, base_log 2, level 3, B=256, N in {8192, 16384} x {u32, u64})
          with key preparation on the card, the median of 5 PBS calls and
          one profiled call each; the u32 N=8192 cell once more on
          backend="ntt" (K9), equal to nuss, its median beside nuss's; the
          first 2 CMux steps of 8 rows of the u32 N=8192 cell recomputed on
          the CPU must match the card; K1 and K5-K7 must launch.
  E       the exact-NTT backend and the fused toeplitz step: backend="ntt"
          twins of the TPU128, DEFAULT and TFHE_LIB keys (K9 every CMux
          step) through AND, XOR, NAND and MUX requests of 100 and 2048
          rows, every row on its truth table, AND equal to the mxu
          backend's bit for bit, the median of 5 AND calls at B=2048 beside
          the mxu backend's; a TFHE_LIB fast-mode ntt twin (levels=2)
          through AND; 16 rows of a TPU128 ntt AND recomputed on the CPU;
          the int4 LUT of phase C through LWEBSK(backend="ntt") (u64, three
          primes: the torch composition) at B=256, PBS and multi-LUT, every
          row decoded under the big key, equal to the mxu backend, timed
          once; bootstrap_keyswitch_mxu(fused=True) (K8 every step) on the
          three gate keys at B=2048, equal to fused=False, medians of 3
          beside the unfused ones; one profiled TPU128 call each of the ntt
          AND and the fused AND. K8 and K9 must launch.
  F       the client side and the 8-bit adder (examples/adder_circuit.py,
          BASELINE config 5): the DEFAULT and TFHE_LIB boolean keys and the
          int4 high-level keys of phase C's shapes made from fixed seeds on
          the AES-CTR streams (the native AES: its AES-NI use and bytes/s
          logged; a numpy AES call fails the phase), with set-up seconds by
          part (the BSK's fork tree, mask read, noise draw, device
          multisum, key preparation); 2048 random 8-bit pairs through
          circuits.encrypt_uint; the ripple-carry adder on the DEFAULT key's
          auto backend (ntt: K9 every CMux step) and on its mxu twin (K1,
          K2, and K3 for the MUX's 4096 rows), every row equal to
          (a + b) mod 256 with the right carry, the two backends bit
          identical; the sha256 of every key, of the encrypted planes, of
          the sums and carry of rows 0-31 and of a base_log 8 keyswitch of
          64 rows equal to concrete_tpu's (DIGESTS, from
          tools/phase_f_reference.py), that keyswitch equal to its CPU
          recomputation; the median of 3 adds per backend (adds/s and
          gates/s) and one profiled add. K1, K2, K3 and K9 must launch.
  G       the conformance harness, VectorRLWE and the design model: the
          CUDA probe (diagnose.main(): versions, device init, the kernels
          built and one K1 launch held to its plain version) returns 0; the
          fixture grid (fixtures.run_all(repetitions=1, sample_size=100),
          the 63 reports concrete_tpu's gives) on the card, every report
          passing; full-width noise entries through the fixtures' run_one
          (noise_entries: PbsFixture at TPU128, DEFAULT and TFHE_LIB on ntt
          and mxu, TFHE_LIB on nuss, U64PbsFixture at the int4 shape on mxu
          and at N=8192 on nuss, the grid's N=8192 entry at 10 x 64, a u32
          N=16384 nuss entry; 2 repetitions of 2048 samples unless stated),
          each within assert_noise_bounded (slack 0.5 bit) with its
          measured std beside the NPE's; VectorRLWE at full width (8 x 1024
          packed 4-bit values under an RLWE128_1024_1 key: add_with_padding,
          mul_constant_static_encoder, every value decoded right, the
          ciphertexts' and the extracted LWEs' sha256 equal to
          concrete_tpu's, DIGESTS_G; every coefficient extracted,
          keyswitched to LWE128_630 and checked against the noise model as
          in phase C, then bootstrapped through the int4 LUT on mxu, every
          row equal to the LUT entry its modulus-switched phase selects),
          each stage's device and host time; design.search() on the card's
          cost model and, per gate preset, the modelled ntt gates/s within
          2x of phase E's measured AND with report_pbs_efficiency. K1, K2,
          K4-K7 and K9 must launch.
  H       parallel/ and the examples on the card. H1: a process group of
          one rank on NCCL (a FileStore), make_mesh(1, 1), and at B=2048
          gate_pipeline_dp (mxu and ntt) and gate_pipeline_dp_tp_mxu on the
          TPU128 and DEFAULT keys, gate_pipeline_dp_tp (the level-split ntt
          composition) on the TPU128 ntt twin and gate_pipeline_dp_tp_nuss
          on phase D's backend="nuss" TFHE_LIB twin: every output bit for
          bit the unsharded call's and AND's truth table, each pipeline's
          median of 3 beside the unsharded call's, the two called in turn.
          The launch counts are reset just before each of the pipeline's
          timed calls and read just after (the unsharded calls fall
          outside): dp mxu and
          dp_tp_mxu must launch K1 and K2, dp_tp_nuss K1, K5 and K7, dp ntt
          K9; the level-split ntt composition runs no kernel. H2:
          multihost.run(2, 1) on the card, two processes on gloo (NCCL
          refuses two ranks on one GPU), the toy and the TPU128 real-key
          tiers (rank 0 makes the key and broadcasts it) at B=256 with dp and then tp across the
          processes: every shard equal to the single-device call, the
          gathered rows decrypting to a & b, each rank's seconds and bytes
          sent logged beside the plan's count (which they must equal).
          H3: the seven examples' main() at their published parameters and
          sizes on the card, each checking its own answers, its launches a
          path of their own (K1, K4 and K9 must launch).

The bounds and timers (bound_ms, time_ms, median_s, profile_call, the
instruction counts of K4 and K9) come from concrete_tpu_torch.profiling.
Every phase logs its kernels' launches per shape key (launches_by_shape);
after the phases, each phase-A row of K4-K7 is logged beside the
launches of its shape key on the main paths (A_launches).
The last lines are the card's name and power limit (nvidia-smi), a
{"kernels": [...]} JSON line and {"ok": true, "device": {...}}. Any failure
raises, so the exit code is non-zero and no result line is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from concrete_tpu_torch import boolean, design, diagnose, fixtures, highlevel as hl
from concrete_tpu_torch import examples, native, torus
from concrete_tpu_torch.boolean import circuits
from concrete_tpu_torch.core import bootstrap as bs
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.core import bootstrap_ntt as bsntt
from concrete_tpu_torch.core import bootstrap_nuss as bsn
from concrete_tpu_torch.boolean.client_key import PLAINTEXT_LOG_SCALING_FACTOR
from concrete_tpu_torch.core import lwe as lwe_ops
from concrete_tpu_torch.core.ggsw import StandardBootstrapKey, bsk_to_ntt
from concrete_tpu_torch.csprng import EncryptionRandomGenerator, aes
from concrete_tpu_torch.csprng.generator import AesCtrGenerator
from concrete_tpu_torch.highlevel.lwe import _accumulator, generate_functional_lut
from concrete_tpu_torch.ops import _cuda
from concrete_tpu_torch.parallel import mesh as pmesh, multihost
from concrete_tpu_torch.profiling import (
    INT8_TENSOR_OPS_PER_S,
    bound_ms,
    int_ops_s,
    median_s,
    mxu_gemm_ops,
    ntt_cmux_work,
    nuss_gemm_ops,
    profile_call,
    report_pbs_efficiency,
    rotdig64_work,
    time_ms,
)
from concrete_tpu_torch.params import (
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)

PRESETS = {"TPU128": TPU128_PARAMETERS, "DEFAULT": DEFAULT_PARAMETERS,
           "TFHE_LIB": TFHE_LIB_PARAMETERS}
TIERS = {"TPU128": [2048, 8192], "DEFAULT": [2048], "TFHE_LIB": [2048]}
REQUESTS = {"TPU128": [100, 2048, 5000], "DEFAULT": [100, 2048],
            "TFHE_LIB": [100, 2048]}
GATES = ("and_", "xor", "nand", "mux")
MXU_SOURCE = "concrete_tpu_torch/csrc/mxu_kernels.cu"
NUSS_SOURCE = "concrete_tpu_torch/csrc/nuss_kernels.cu"
FUSED_SOURCE = "concrete_tpu_torch/csrc/fused_kernels.cu"
NTT_SOURCE = "concrete_tpu_torch/csrc/ntt_kernels.cu"
# kernel -> (its source, the TPU kernel it replaces)
REPLACES = {
    "build_tables": (MXU_SOURCE, "concrete_tpu/core/bootstrap_mxu.py:238"),
    "rotdig": (MXU_SOURCE, "concrete_tpu/core/bootstrap_mxu.py:449"),
    "rotdig_recombine": (MXU_SOURCE, "concrete_tpu/core/bootstrap_mxu.py:599"),
    "rotdig64": (MXU_SOURCE, "concrete_tpu/core/bootstrap_mxu.py:531"),
    "recombine_inv": (NUSS_SOURCE, "concrete_tpu/core/bootstrap_nuss.py:438"),
    "recombine_inv64": (NUSS_SOURCE, "concrete_tpu/core/bootstrap_nuss.py:657"),
    "rotdig_fwd_nuss": (NUSS_SOURCE, "concrete_tpu/core/bootstrap_nuss.py:833"),
    "fused_external_product_acc": (FUSED_SOURCE,
                                   "concrete_tpu/ops/fused_cmux.py:77"),
    "ntt_cmux": (NTT_SOURCE, "concrete_tpu/ops/pallas_cmux.py:114"),
}
# the kernels each main path must launch (phase B: u32 gates, C: u64 PBS,
# D: the Nussbaumer backend on both tori, E: the ntt backend and the fused
# toeplitz step, F: the 8-bit adder on ntt and on mxu, G: the fixture grid,
# the full-width noise entries and VectorRLWE)
PATH_KERNELS = {"B": ("build_tables", "rotdig", "rotdig_recombine"),
                "C": ("build_tables", "rotdig64"),
                "D": ("build_tables", "recombine_inv", "recombine_inv64",
                      "rotdig_fwd_nuss"),
                "E": ("ntt_cmux", "fused_external_product_acc"),
                "F": ("ntt_cmux", "build_tables", "rotdig", "rotdig_recombine"),
                "G": ("build_tables", "rotdig", "rotdig64", "recombine_inv",
                      "recombine_inv64", "rotdig_fwd_nuss", "ntt_cmux"),
                # H1: the pipelines' timed calls, H3: the examples (H2's
                # ranks are other processes)
                "H1": ("build_tables", "rotdig", "recombine_inv",
                       "rotdig_fwd_nuss", "ntt_cmux"),
                "H3": ("build_tables", "rotdig64", "ntt_cmux")}
# phase H1: the kernels each pipeline must launch in its own timed calls
H1_KERNELS = {
    "gate_pipeline_dp mxu": ("build_tables", "rotdig"),
    "gate_pipeline_dp ntt": ("ntt_cmux",),
    "gate_pipeline_dp_tp_mxu": ("build_tables", "rotdig"),
    "gate_pipeline_dp_tp (ntt, level split)": (),
    "gate_pipeline_dp_tp_nuss": ("build_tables", "recombine_inv",
                                 "rotdig_fwd_nuss"),
}
CPU_ROWS = 32
# phase C: examples/int4_lut.py at the JAX suite's batch
INT4 = {"lwe": hl.LWE128_630, "rlwe": hl.RLWE128_1024_1, "pbs": (7, 3),
        "ks": (2, 8), "batch": 2048}
CPU_STEPS = 16
KS_CPU_ROWS = 64
# phase D: the JAX suite's large-N engine rows (benchmarks/suite.py "nuss")
NUSS_ENGINE = {"lwe_dimension": 100, "pbs": (2, 3), "batch": 256,
               "sizes": (8192, 16384)}
# and the int4 LUT at N = 8192: sigma 2^-62 is 4 units of the 64-bit torus
INT4_8192 = {"rlwe": hl.RLWEParams(8192, 1, -62), "batch": 256}
NUSS_CPU_STEPS, NUSS_CPU_ROWS = 2, 8
NUSS_GATE_ROWS = 2048
# phase E
NTT_REQUESTS = (100, 2048)
NTT_CPU_ROWS = 16
INT4_NTT_BATCH = 256

# phase F: the client side and the 8-bit adder (examples/adder_circuit.py's
# key seeds; examples/int4_lut.py's key shapes and KSK/BSK seeds, with
# secret seeds of its own). tools/phase_f_reference.py computes DIGESTS
# with concrete_tpu from these seeds.
PHASE_F = {"gate_seeds": (1, 2, 3), "presets": ("DEFAULT", "TFHE_LIB"),
           "int4_seeds": (5, 6, 1, 2, 3, 4), "rows": 2048, "ref_rows": 32,
           "nbits": 8, "values_seed": 9, "a_seeds": (4, 5), "b_seeds": (6, 7),
           "ks": (8, 3), "ks_seeds": (61, 62), "ks_ct_seeds": (63, 64),
           "ks_rows": 64}
# sha256[:16] of each, from concrete_tpu on the CPU
# (tools/phase_f_reference.py)
DIGESTS = {
    "DEFAULT lwe_key": "5b9733c303f7ad31",
    "DEFAULT glwe_key": "f5b40b4f94647f5c",
    "DEFAULT bsk": "de0f1c34582c5ede",
    "DEFAULT ksk": "54db03ce92d74145",
    "TFHE_LIB lwe_key": "e7f5dbc803910bdf",
    "TFHE_LIB glwe_key": "8f0272af76551d26",
    "TFHE_LIB bsk": "441c8db9dd669d11",
    "TFHE_LIB ksk": "d272bfe3681a4bc0",
    "int4 lwe_key": "f0dccdbe39e412c1",
    "int4 rlwe_key": "292194c36a39ec0b",
    "int4 bsk": "688a59a556027501",
    "int4 ksk": "de7c8a3ad3b0fc1a",
    "a planes": "fa6b221654412758",
    "b planes": "57e7536d9e479c50",
    "adder sums": "3f84947ebcac32fb",
    "adder carry": "d70851aa61ed64d4",
    "ks key": "362733fd86195321",
    "ks out": "d20e812c4ae90f96"}

# phase G: the conformance grid (concrete_tpu's run_all(repetitions=1) gives
# 63 reports), full-width noise entries (fixtures' run_one, fixed seeds) and
# VectorRLWE at the int4 keys' shapes (its own seeds). tools/phase_f_reference.py
# computes DIGESTS_G with concrete_tpu from these seeds.
GRID_REPORTS = 63
NOISE_REPS, NOISE_SAMPLES = 2, 2048
PHASE_G = {"lwe_seed": 71, "rlwe_seed": 72, "a_seeds": (73, 74),
           "b_seeds": (75, 76), "ksk_seeds": (77, 78), "bsk_seeds": (79, 80),
           "values_seed": 81, "ciphertexts": 8,
           "constants": (1, 2, 1, 2, 2, 1, 2, 1)}
DIGESTS_G = {
    "vrlwe a": "4ada53e0b77250fd",
    "vrlwe b": "cfb58da32d52944c",
    "vrlwe add_mul": "35a54d6e2c6eb245",
    "vrlwe extracted": "0660a1c97f6ab8db"}
# phase H: parallel/ on one card (H1 on NCCL, H2 two processes on gloo)
PHASE_H = {"batch": 2048, "reps": 3, "h2_processes": 2, "h2_batch": 256,
           "seed": 8000}
_COUNTED = (bsx, bsn, bsntt)
# phase -> {kernel: {shape key: launches}} of its main path (read_launches),
# and phase A's rows that name a shape key (kernel, label, key, ms, bound)
PATH_SHAPES: dict[str, dict[str, dict[str, int]]] = {}
KEYED_ROWS: list[tuple[str, str, str, float, float]] = []


def adder_values() -> tuple[np.ndarray, np.ndarray]:
    """Phase F's 8-bit operands, PHASE_F["rows"] each (np.uint64)."""
    rng = np.random.default_rng(PHASE_F["values_seed"])
    vals = rng.integers(0, 1 << PHASE_F["nbits"], size=(2, PHASE_F["rows"]))
    return vals[0].astype(np.uint64), vals[1].astype(np.uint64)


def reset_launch_counts():
    for mod in _COUNTED:
        mod.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {k: v for mod in _COUNTED for k, v in mod.launch_counts().items()}


def read_launches(phase: str) -> dict[str, int]:
    """The launches of each kernel since the last reset; logs them per
    shape key as well (the wrappers' `shapes`)."""
    shapes = {k: v for mod in _COUNTED for k, v in mod.shape_counts().items()
              if v}
    PATH_SHAPES[phase] = shapes
    log(phase=phase, launches_by_shape=shapes)
    return launch_counts()


def add_launches(path: str, total: dict[str, int]) -> dict[str, int]:
    """The launches since the last reset, added to `total` and, per shape
    key, to PATH_SHAPES[path] (a path read in several windows)."""
    counts = launch_counts()
    shapes = PATH_SHAPES.setdefault(path, {})
    for mod in _COUNTED:
        for kernel, by_key in mod.shape_counts().items():
            for key, n in by_key.items():
                into = shapes.setdefault(kernel, {})
                into[key] = into.get(key, 0) + n
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return counts


def log(**fields):
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log_profile(label: str, fn, card, gemm_ops=None, phase="profile"):
    """One call of `fn` under profiling.profile_call, logged with its host
    time (wall less device time). Returns fn's result."""
    box = {}
    stats = profile_call(lambda: box.setdefault("out", fn()), gemm_ops)
    log(phase=phase, cell=label, **stats,
        host_ms=stats["wall_ms"] - stats["device_ms"], card=card)
    return box["out"]


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)

    def wide(t):  # int8 differences fit int16 (the tables reach 906 MB)
        return t.to(torch.int16 if t.dtype == torch.int8 else torch.int64)

    return max(int((wide(g) - wide(w)).abs().max()) for g, w in zip(got, want))


def kernel_cases(dev):
    """(kernel, label, run the kernel, run its plain version, the inputs it
    reads) at the main paths' shapes: one CMux step's table per preset and
    for the u64 int4 configuration (limb_drop 0 and 2), the digit kernel at
    B=2048 per preset, the deferred kernel at the TPU128 B=8192 tier, and
    the u64 digit kernel at the int4 shape plus three wider gadgets (n_sub
    2, the non_rep == 32 edge, a 48-bit prefix)."""
    rng = np.random.default_rng(0)

    def u32(shape):
        return torus.from_numpy(
            rng.integers(0, 1 << 32, size=shape, dtype=np.uint32), dev)

    def u64(shape):
        """Random u64 words, the first rows seeded with word-boundary
        values (tests/test_bootstrap_mxu.py)."""
        acc = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        acc[0, 0, :4] = [0, 1, 0xFFFF_FFFF, 0x1_0000_0000]
        acc[0, 1, :4] = [0xFFFF_FFFF_FFFF_FFFF, 0x8000_0000,
                         0x7FFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0000]
        return torus.from_numpy(acc, dev)

    def degrees(n, b):
        return torch.from_numpy(
            rng.integers(0, 2 * n + 1, size=b).astype(np.int32)).to(dev)

    cases = []
    for name, params in PRESETS.items():
        plan = bsx.MxuPlan.from_config(bs.ServerConfig.from_boolean_parameters(params))
        n, ks1, r = plan.polynomial_size, plan.glwe_size, plan.row_blocks
        rings = u32((r, ks1, 2 * n))
        rhs = bsx.table_buffer(r * n, ks1 * 4 * n, device=dev)
        cases.append(("build_tables", f"{name} one step",
                      lambda rings=rings, n=n, rhs=rhs: bsx.build_tables(rings, n, out=rhs),
                      lambda rings=rings, n=n: bsx.build_tables_plain(rings, n),
                      (rings,)))
        b = 2048
        acc, a_hat = u32((ks1, b, n)), degrees(n, b)
        d8 = torch.empty((b, r * n), dtype=torch.int8, device=dev)
        cases.append(("rotdig", f"{name} B={b} n_sub={plan.n_sub}",
                      lambda p=plan, acc=acc, a=a_hat, d8=d8: bsx.rotdig(p, acc, a, out=d8),
                      lambda p=plan, acc=acc, a=a_hat: bsx.rotdig_plain(p, acc, a),
                      (acc, a_hat)))
    plan = bsx.MxuPlan.from_config(
        bs.ServerConfig.from_boolean_parameters(TPU128_PARAMETERS))
    n, ks1, b = plan.polynomial_size, plan.glwe_size, 8192
    s, acc, a_hat = u32((b, ks1 * 4 * n)), u32((ks1, b, n)), degrees(n, b)
    cases.append(("rotdig_recombine", f"TPU128 B={b}",
                  lambda p=plan, s=s, acc=acc, a=a_hat: bsx.rotdig_recombine(p, s, acc, a),
                  lambda p=plan, s=s, acc=acc, a=a_hat: bsx.rotdig_recombine_plain(p, s, acc, a),
                  (s, acc, a_hat)))
    n, b = INT4["rlwe"].polynomial_size, INT4["batch"]
    for bl, lv in [INT4["pbs"], (10, 3), (16, 2), (16, 3)]:
        plan = bsx.MxuPlan.from_config(_int4_config(bl, lv))
        ks1 = plan.glwe_size
        acc, a_hat = u64((ks1, b, n)), degrees(n, b)
        d8 = torch.empty((b, plan.row_blocks * n), dtype=torch.int8, device=dev)
        per_coef = rotdig64_work(plan)
        coefs = b * ks1 * n
        cases.append((
            "rotdig64", f"int4 B={b} bl={bl} l={lv} n_sub={plan.n_sub}",
            lambda p=plan, acc=acc, a=a_hat, d8=d8: bsx.rotdig64(p, acc, a, out=d8),
            lambda p=plan, acc=acc, a=a_hat: bsx.rotdig64_plain(p, acc, a),
            (acc, a_hat),
            {"op_s": int_ops_s(*(coefs * w for w in per_coef)),
             "instr_per_coef": per_coef,
             "key": f"B={b} ks1={ks1} N={n} bl={bl} l={lv} n_sub={plan.n_sub}"}))
    for drop in (0, 2):
        plan = bsx.MxuPlan.from_config(_int4_config(*INT4["pbs"], drop))
        rings = u32((plan.row_blocks, plan.glwe_size * 2, 2 * n))
        rhs = bsx.table_buffer(plan.row_blocks * n, plan.glwe_size * plan.limbs_used * n,
                               device=dev)
        cases.append((
            "build_tables", f"int4 u64 one step limb_drop={drop}",
            lambda rings=rings, d=drop, rhs=rhs: bsx.build_tables(rings, n, d, 2, out=rhs),
            lambda rings=rings, d=drop: bsx.build_tables_plain(rings, n, d, 2),
            (rings,)))
    cases += nuss_kernel_cases(dev, rng, u32, u64, degrees)
    cases += ntt_kernel_cases(dev, rng, u32, degrees)
    cases += fused_kernel_cases(dev, rng, u32)
    return cases


def ntt_kernel_cases(dev, rng, u32, degrees):
    """K9 at one CMux step of each gate preset at B=2048, and at the u32
    N=8192 engine shape at B=256 (dynamic shared memory, 160 KB a block);
    key spectra random residues below each prime."""
    cases = []
    cfgs = [(f"{name} one step B=2048",
             bs.ServerConfig.from_boolean_parameters(params), 2048)
            for name, params in PRESETS.items()]
    cfgs.append(("u32 N=8192 engine one step B=256",
                 nuss_config(8192, 32, *NUSS_ENGINE["pbs"]), 256))
    for label, cfg, b in cfgs:
        n, ks1 = cfg.polynomial_size, cfg.glwe_size
        acc, a_hat = u32((ks1, b, n)), degrees(n, b)
        ggsw = torch.from_numpy(np.stack([
            rng.integers(0, p, size=(cfg.pbs_level, ks1, ks1, n), dtype=np.uint32)
            for p in cfg.primes]).view(np.int32)).to(dev)
        out = torch.empty_like(acc)
        cases.append((
            "ntt_cmux", label,
            lambda c=cfg, acc=acc, a=a_hat, g=ggsw, o=out: bsntt.ntt_cmux(c, acc, a, g, out=o),
            lambda c=cfg, acc=acc, a=a_hat, g=ggsw: bsntt.ntt_cmux_plain(c, acc, a, g),
            (acc, a_hat, ggsw),
            {"op_s": int_ops_s(*ntt_cmux_work(cfg, b)[1]),
             "mont_products": ntt_cmux_work(cfg, b)[0]}))
    return cases


def fused_kernel_cases(dev, rng, u32):
    """K8 at one CMux step of each gate preset at B=2048 (limb_drop 0;
    DEFAULT's base_log 8 gives n_sub 2) and TPU128 with limb_drop 1, beside
    the unfused mxu step it replaces (K1, torch._int_mm, recombine, add)."""
    cases = []
    cfgs = [(name, bs.ServerConfig.from_boolean_parameters(params))
            for name, params in PRESETS.items()]
    cfgs.append(("TPU128 drop 1", dataclasses.replace(cfgs[0][1], mxu_limb_drop=1)))
    b = 2048
    for name, cfg in cfgs:
        plan = bsx.MxuPlan.from_config(cfg)
        n, ks1, r = plan.polynomial_size, plan.glwe_size, plan.row_blocks
        acc, rings = u32((ks1, b, n)), u32((r, ks1, 2 * n))
        d8 = torch.from_numpy(rng.integers(-64, 65, size=(b, r * n),
                                           dtype=np.int8)).to(dev)
        out = torch.empty_like(acc)
        rhs = bsx.table_buffer(r * n, ks1 * plan.limbs_used * n, device=dev)
        s = torch.empty((b, ks1 * plan.limbs_used * n), dtype=torch.int32,
                        device=dev)
        macs = b * r * n * ks1 * plan.limbs_used * n
        cases.append((
            "fused_external_product_acc",
            f"{name} one step B={b} n_sub={plan.n_sub} limbs={plan.limbs_used}",
            lambda p=plan, acc=acc, d8=d8, rg=rings, o=out:
                bsx.fused_external_product_acc(p, acc, d8, rg, out=o),
            lambda p=plan, acc=acc, d8=d8, rg=rings:
                bsx.fused_external_product_acc_plain(p, acc, d8, rg),
            (acc, d8, rings),
            {"op_s": 2 * macs / INT8_TENSOR_OPS_PER_S, "macs": macs,
             "unfused": lambda p=plan, acc=acc, d8=d8, rg=rings, rhs=rhs, s=s:
                 acc + bsx._toeplitz_matmul(
                     p, d8, bsx.build_tables(rg, p.polynomial_size, p.limb_drop,
                                             out=rhs), out=s)}))
    return cases


def nuss_config(n: int, bits: int, base_log: int, level: int,
                lwe_dimension: int = NUSS_ENGINE["lwe_dimension"]):
    return bs.ServerConfig(
        lwe_dimension=lwe_dimension, glwe_dimension=1, polynomial_size=n,
        pbs_base_log=base_log, pbs_level=level, ks_base_log=2, ks_level=5,
        bits=bits)


def nuss_kernel_cases(dev, rng, u32, u64, degrees):
    """Phase A's Nussbaumer rows at the phase-D shapes (k+1=2, L=32): K5 at
    the u32 N=8192 and 16384 engine shapes (B=256) and on the TFHE_LIB ring
    (N=1024, M=32, B=2048), K6 at u64 N=8192 (the engine and int4 N=8192
    shape) and 16384, K7 at u32 N=8192 (n_sub 1),
    at base_log 7 (n_sub 2, u32 and the u64 int4 cell) and on the TFHE_LIB
    ring (n_sub 2, B=2048), K1 on the u64 N=8192 engine rings (3 word
    planes, 9 limbs), the int4 N=8192 rings (n_sub 2: the 906 MB table) and
    the TFHE_LIB ring, one table per frequency as the blind rotation
    builds them."""
    b = NUSS_ENGINE["batch"]
    cases = []

    def dot_output(plan, b):
        return torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=(plan.two_l, b, plan.glwe_size *
                                       plan.limbs_used * plan.m),
            dtype=np.int32)).to(dev)

    tfhe_lib = bsn.NussPlan.from_config(
        bs.ServerConfig.from_boolean_parameters(PRESETS["TFHE_LIB"]))
    for plan, bb in [(bsn.NussPlan.from_config(nuss_config(n, bits, *NUSS_ENGINE["pbs"])), b)
                     for n, bits in ((8192, 32), (16384, 32), (8192, 64),
                                     (16384, 64))] + [
                         (tfhe_lib, NUSS_GATE_ROWS)]:
        bits = plan.bits
        kernel, plain = ((bsn.recombine_inv, bsn.recombine_inv_plain) if bits == 32
                         else (bsn.recombine_inv64, bsn.recombine_inv64_plain))
        s = dot_output(plan, bb)
        out = torch.empty((plan.glwe_size, bb, plan.l, plan.m), device=dev,
                          dtype=torch.int32 if bits == 32 else torch.int64)
        cases.append((kernel.__name__,
                      f"u{bits} N={plan.polynomial_size} L={plan.l} M={plan.m} B={bb}",
                      lambda k=kernel, p=plan, s=s, o=out: k(p, s, out=o),
                      lambda f=plain, p=plan, s=s: f(p, s), (s,),
                      {"key": f"B={bb} ks1={plan.glwe_size} L={plan.l} "
                              f"M={plan.m} limbs={plan.limbs_used}"}))
    k7_plans = [(bsn.NussPlan.from_config(nuss_config(8192, bits, bl, lv)), b)
                for bits, (bl, lv) in ((32, NUSS_ENGINE["pbs"]), (32, INT4["pbs"]),
                                       (64, INT4["pbs"]))]
    for plan, bb in k7_plans + [(tfhe_lib, NUSS_GATE_ROWS)]:
        n, bits = plan.polynomial_size, plan.bits
        shape = (plan.glwe_size, bb, plan.l, plan.m)
        acc = (u32(shape) if bits == 32
               else u64((plan.glwe_size, bb, n)).view(shape))
        a_hat = degrees(n, bb)
        d8 = torch.empty((plan.two_l, bb, plan.row_blocks * plan.m),
                         dtype=torch.int8, device=dev)
        cases.append((
            "rotdig_fwd_nuss",
            f"u{bits} N={n} L={plan.l} M={plan.m} bl={plan.base_log} "
            f"l={plan.level} n_sub={plan.n_sub} B={bb}",
            lambda p=plan, acc=acc, a=a_hat, d8=d8: bsn.rotdig_fwd_nuss(p, acc, a, out=d8),
            lambda p=plan, acc=acc, a=a_hat: bsn.rotdig_fwd_nuss_plain(p, acc, a),
            (acc, a_hat),
            {"key": f"B={bb} ks1={plan.glwe_size} L={plan.l} M={plan.m} "
                    f"bits={bits} bl={plan.base_log} l={plan.level} "
                    f"n_sub={plan.n_sub}"}))
    int4_8192 = bsn.NussPlan.from_config(dataclasses.replace(
        _int4_config(*INT4["pbs"]),
        polynomial_size=INT4_8192["rlwe"].polynomial_size))
    for label, plan in (("engine", bsn.NussPlan.from_config(
                            nuss_config(8192, 64, *NUSS_ENGINE["pbs"]))),
                        ("int4", int4_8192), ("TFHE_LIB", tfhe_lib)):
        m, nw, hd = plan.m, plan.n_words, plan.limb_hi_drop
        rows, cols = plan.row_blocks * m, plan.glwe_size * plan.limbs_used * m
        rings = u32((plan.two_l * plan.row_blocks, plan.glwe_size * nw, 2 * m))
        rhs = bsx.table_buffer(rows, cols, plan.two_l, device=dev)
        cases.append((
            "build_tables",
            f"nuss {label} u{plan.bits} N={plan.polynomial_size} one step "
            f"({nw} words, {plan.limbs_used} limbs, {rhs.numel() / 1e6:.1f} MB)",
            lambda r=rings, p=plan, o=rhs: bsx.build_tables(
                r, p.m, 0, p.n_words, p.limb_hi_drop, groups=p.two_l, out=o),
            lambda r=rings, p=plan: bsx.build_tables_plain(
                r, p.m, 0, p.n_words, p.limb_hi_drop).view(
                    p.two_l, p.row_blocks * p.m, -1),
            (rings,)))
    return cases


def _int4_config(base_log, level, drop=0) -> bs.ServerConfig:
    return bs.ServerConfig(
        lwe_dimension=INT4["lwe"].dimension, glwe_dimension=INT4["rlwe"].dimension,
        polynomial_size=INT4["rlwe"].polynomial_size, pbs_base_log=base_log,
        pbs_level=level, ks_base_log=INT4["ks"][0], ks_level=INT4["ks"][1],
        bits=64, mxu_limb_drop=drop)


def phase_a(dev, card):
    """Every kernel equal to its plain version; returns the headline row
    per kernel (its first case) for the kernels line."""
    rows = {}
    for kernel, label, run, plain, inputs, *extra in kernel_cases(dev):
        extra = extra[0] if extra else {}
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        same = all(torch.equal(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        if not same:
            raise AssertionError(f"{kernel} ({label}) differs from its plain "
                                 f"version, max |err| = {err}")
        ms, plain_ms = time_ms(run), time_ms(plain)
        bound, bound_by = bound_ms(inputs, got if isinstance(got, tuple)
                                   else (got,), extra.get("op_s"))
        # the achieved share of the bound; K8's MAC rate against the int8
        # tensor rate (2 operations a MAC)
        more = {"bound_share": bound / ms}
        if "macs" in extra:
            more["t_mac_per_s"] = extra["macs"] / (ms * 1e-3) / 1e12
            more["int8_tensor_share"] = (2 * extra["macs"] / (ms * 1e-3)
                                         / INT8_TENSOR_OPS_PER_S)
        if "unfused" in extra:
            more["unfused_step_ms"] = time_ms(extra["unfused"])
        if "mont_products" in extra:
            more["mont_products"] = extra["mont_products"]
        if "instr_per_coef" in extra:  # (multiplies, adds, ALU-only)
            more["fewest_instr_per_coef"] = extra["instr_per_coef"]
        log(phase="A", kernel=kernel, shape=label, equal=True, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            **more, card=card)
        if "key" in extra:
            KEYED_ROWS.append((kernel, label, extra["key"], ms, bound))
        row = rows.setdefault(kernel, {"ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": bound, "bound_by": bound_by,
                                       "max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return rows


def encrypt_bools(cks, n_rows, seed):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=n_rows).astype(bool) for _ in range(3)]
    cts = [cks.encrypt(v, mask_seed=seed + i, noise_seed=seed + 10 + i)
           for i, v in enumerate(bits)]
    return bits, cts


def truth(gate, a, b, c):
    return {"and_": a & b, "xor": a ^ b, "nand": ~(a & b),
            "mux": np.where(a, b, c)}[gate]


def call_gate(sks, gate, ca, cb, cc):
    return sks.mux(ca, cb, cc) if gate == "mux" else getattr(sks, gate)(ca, cb)


def phase_b(dev, card):
    """The gate server per preset; returns the CPU cross-check inputs."""
    cpu_check = None
    for name, params in PRESETS.items():
        t0 = time.perf_counter()
        cks, sks = boolean.gen_keys(params, secret_seed=11, mask_seed=12,
                                    noise_seed=13, device=dev)
        keygen_s = time.perf_counter() - t0
        # phase B measures the toeplitz path, which "auto" no longer picks
        # on the u32 torus (phase E runs the ntt twin it resolves to)
        auto = sks.resolved_backend()
        sks = dataclasses.replace(sks, backend="mxu")
        t0 = time.perf_counter()
        sks.bsk_mxu, sks.ksk8  # noqa: B018 - evaluation keys onto the card
        prep_s = time.perf_counter() - t0
        warm = sks.warmup(TIERS[name])
        log(phase="B", params=name, auto_backend=auto,
            backend=sks.resolved_backend(), keygen_s=keygen_s,
            key_prep_s=prep_s,
            warmup_s={f"{gate} B={tier}": s for (gate, tier), s in warm.items()})
        for size in REQUESTS[name]:
            (a, b, c), (ca, cb, cc) = encrypt_bools(cks, size, 1000 + size)
            for gate in GATES:
                out = call_gate(sks, gate, ca, cb, cc)
                if out.device.type != dev.type or out.shape != ca.shape:
                    raise AssertionError(f"{name} {gate}: bad output "
                                         f"{out.device} {tuple(out.shape)}")
                ok = np.array_equal(cks.decrypt(out), truth(gate, a, b, c))
                if not ok:
                    raise AssertionError(f"{name} {gate} size {size}: wrong "
                                         "truth table")
                if name == "TPU128" and gate == "and_" and size == 5000:
                    cpu_check = (sks, ca[:CPU_ROWS], cb[:CPU_ROWS],
                                 out[:CPU_ROWS].cpu())
            log(phase="B", params=name, request_rows=size, gates=list(GATES),
                truth_tables="ok")
        for tier in TIERS[name]:
            _, (ca, cb, _) = encrypt_bools(cks, tier, 7)
            ca, cb = torus.from_numpy(ca, dev), torus.from_numpy(cb, dev)
            med = median_s(lambda: sks.and_(ca, cb))
            plan = bsx.MxuPlan.from_config(sks.cfg)
            log(phase="B", params=name, tier=tier, gate="and_",
                ms_per_call=med * 1e3, gates_per_s=tier / med,
                deferred=bsx.auto_defer(plan, tier), card=card)
            if tier == 2048:
                log_profile(f"{name} mxu AND B={tier}",
                            lambda: sks.and_(ca, cb), card,
                            gemm_ops=mxu_gemm_ops(plan, tier))
        if name == "TFHE_LIB":
            fast_mode_request(cks, sks, card)
        del sks
        torch.cuda.empty_cache()
    return cpu_check


def fast_mode_request(cks, sks, card):
    """One 2048-row request through a fast-mode (levels=2) twin of the
    TFHE_LIB key, AND and XOR checked on their truth tables, AND timed."""
    fast = sks.with_fast_mode()
    fast.warmup([2048])
    (a, b, c), (ca, cb, cc) = encrypt_bools(cks, 2048, 3000)
    for gate in ("and_", "xor"):
        if not np.array_equal(cks.decrypt(call_gate(fast, gate, ca, cb, cc)),
                              truth(gate, a, b, c)):
            raise AssertionError(f"TFHE_LIB fast mode {gate}: wrong truth table")
    ca, cb = torus.from_numpy(ca, sks.device), torus.from_numpy(cb, sks.device)
    med = median_s(lambda: fast.and_(ca, cb))
    log(phase="B", params="TFHE_LIB fast (levels=2)", tier=2048,
        gates=["and_", "xor"], truth_tables="ok", ms_per_call=med * 1e3,
        gates_per_s=2048 / med, card=card)
    log_profile("TFHE_LIB fast (levels=2) AND B=2048",
                lambda: fast.and_(ca, cb), card,
                gemm_ops=mxu_gemm_ops(bsx.MxuPlan.from_config(fast.cfg), 2048))


def int4_table(x) -> float:
    return float((3 * int(round(x)) + 1) % 16)


# the multi-LUT rounds every rotation to a multiple of 2, which doubles the
# modulus-switch error: 3-bit messages keep it 6 sigma inside the box
MULTI_FNS = (lambda x: float((int(round(x)) + 3) % 8),
             lambda x: float(7 - int(round(x))))


def multi_lut_inputs(sk, xs, seed):
    """(3-bit encoder, ciphertexts of xs mod 8, the rows MULTI_FNS must
    give) for one multi-LUT call."""
    enc3 = hl.Encoder.new(0.0, 7.0, nb_bit_precision=3, nb_bit_padding=1)
    x3 = xs % 8
    ct3 = hl.LWE.encode_encrypt(sk, x3, enc3, mask_seed=seed,
                                noise_seed=seed + 1)
    return enc3, ct3, [(x3 + 3) % 8, 7 - x3]


def check_multi_lut(label, multi, want3, big):
    for t, (out, w) in enumerate(zip(multi, want3)):
        if not np.array_equal(np.round(out.decrypt_decode(big)), w):
            raise AssertionError(f"{label}: multi-LUT function {t} decodes "
                                 "wrong")


def check_keyswitched(label, ks, sk, enc, want, ksk, card, phase="C"):
    """The keyswitched rows against the noise model. With the example's
    keyswitch key (base_log 2, level 8, output noise 2^-14) the NPE puts
    the phase std near 2^-7.1 against a half message spacing of 2^-6, so a
    few percent of rows decode wrong by design.

    The NPE's variance (the std the API tracks, VectorLWE.variances) is the
    mean square error over keys. One fixed keyswitch key also shifts every
    row it switches by the same amount: the balanced digits d of
    [-B/2, B/2) have mean -1/2, so each row carries 1/2 of the sum of the
    key's n_in * l noise values, a bias whose std over keys is
    sqrt(n_in * l) * sigma_ksk / 2 (a sixth of the variance at base 4).
    The rest of the NPE variance is the rows' own spread around it.
    The check: the RMS phase error within [0.5, 1.5] of the tracked std;
    the bias within 3 of its std over keys; and the wrong rows at most
    twice the tail of a Gaussian of the measured bias and the NPE's
    per-row std sqrt(tracked^2 - bias_std^2), plus 0.5%."""
    err = (sk.inner.decrypt(ks.data) - enc.encode_core(want)).view(
        np.int64) * 2.0 ** -64
    bias, spread = float(err.mean()), float(err.std())
    rms = math.sqrt(float(np.mean(err ** 2)))
    tracked = math.sqrt(float(ks.variances[0]))
    n_in, levels = ksk.inner.data.shape[:2]
    bias_std = 0.5 * math.sqrt(n_in * levels * ksk.variance)
    row_std = math.sqrt(tracked ** 2 - bias_std ** 2)
    half = 2.0 ** -(enc.nb_bit_precision + enc.nb_bit_padding + 1)
    p_row = 0.5 * sum(math.erfc((half + sign * bias) / row_std / math.sqrt(2.0))
                      for sign in (-1, 1))
    wrong = int(np.sum(np.round(ks.decrypt_decode(sk)) != want))
    log(phase=phase, pbs=label, stage="keyswitch", rows=len(want),
        phase_rms=rms, tracked_std=tracked, rms_ratio=rms / tracked,
        phase_bias=bias, bias_std=bias_std, phase_spread=spread,
        row_std=row_std,
        wrong_rows=wrong, expected_wrong_rows=p_row * len(want), card=card)
    if not (0.5 <= rms / tracked <= 1.5 and abs(bias) <= 3 * bias_std
            and wrong <= (2 * p_row + 0.005) * len(want)):
        raise AssertionError(f"{label}: keyswitched rows disagree with the "
                             "noise model")


def phase_c(dev, card):
    """The int4 LUT through the high-level API at full width (u64 torus).
    Returns the kernel launches of its main path."""
    (bl, lv), (ks_bl, ks_l), b = INT4["pbs"], INT4["ks"], INT4["batch"]
    t0 = time.perf_counter()
    sk = hl.LWESecretKey.new(INT4["lwe"], secret_seed=21)
    rsk = hl.RLWESecretKey.new(INT4["rlwe"], secret_seed=22)
    big = rsk.to_lwe_secret_key()
    bsk = hl.LWEBSK.new(sk, rsk, bl, lv, mask_seed=23, noise_seed=24,
                        device=dev)
    ksk = hl.LWEKSK.new(big, sk, ks_bl, ks_l, mask_seed=25, noise_seed=26,
                        device=dev)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsk.bsk_mxu, ksk.limbs  # noqa: B018 - evaluation keys onto the card
    torch.cuda.synchronize()
    log(phase="C", auto_backend=bsk.resolved_backend(), keygen_s=keygen_s,
        key_prep_s=time.perf_counter() - t0)

    enc = hl.Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    xs = np.random.default_rng(27).integers(0, 16, size=b).astype(np.float64)
    want = (3 * xs + 1) % 16
    v = hl.VectorLWE.encode_encrypt(sk, xs, enc, mask_seed=28, noise_seed=29)
    fast = bsk.with_fast_mode(limb_drop=2)
    enc3, ct3, want3 = multi_lut_inputs(sk, xs, 30)

    t0 = time.perf_counter()
    reset_launch_counts()
    outs = {}
    for label, key in (("exact", bsk), ("drop2", fast)):
        out = v.bootstrap_all_with_function(key, int4_table, enc)
        outs[label] = (out, out.keyswitch(ksk))
    multi = ct3.bootstrap_with_functions(bsk, MULTI_FNS, enc3)
    torch.cuda.synchronize()
    launches = read_launches("C")
    log(phase="C", main_path_s=time.perf_counter() - t0, launches=launches)

    for label, (out, ks) in outs.items():
        wrong = int(np.sum(np.round(out.decrypt_decode(big)) != want))
        err = (big.inner.decrypt(out.data) - enc.encode_core(want)).view(np.int64)
        log(phase="C", pbs=label, stage="pbs", rows=b, wrong_rows=wrong,
            phase_std=float(np.std(err * 2.0 ** -64)),
            tracked_std=math.sqrt(float(out.variances[0])), card=card)
        if wrong:
            raise AssertionError(f"int4 LUT ({label}): {wrong} of {b} PBS "
                                 "rows decode wrong")
        check_keyswitched(label, ks, sk, enc, want, ksk, card)
    check_multi_lut("int4", multi, want3, big)
    log(phase="C", multi_lut_functions=len(MULTI_FNS), rows=b, decoded="ok")

    acc = torus.from_numpy(
        _accumulator(bsk, generate_functional_lut(bsk, enc, enc, int4_table)),
        dev)
    cts = torus.from_numpy(v.data, dev)
    for label, key in (("exact", bsk), ("drop2", fast)):
        med = median_s(lambda key=key: key.run_bootstrap(acc, cts))
        log(phase="C", pbs=label, batch=b, ms_per_call=med * 1e3,
            pbs_per_s=b / med, card=card)
        log_profile(f"int4 PBS {label} B={b}",
                    lambda key=key: key.run_bootstrap(acc, cts), card,
                    gemm_ops=mxu_gemm_ops(bsx.MxuPlan.from_config(key.cfg), b))
    big_ct = bsk.run_bootstrap(acc, cts)
    med = median_s(lambda: ksk.run_keyswitch(big_ct))
    log(phase="C", keyswitch=f"{big.dimension}->{sk.dimension}", batch=b,
        ms_per_call=med * 1e3, card=card)
    log_profile(f"int4 keyswitch B={b}", lambda: ksk.run_keyswitch(big_ct),
                card)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(bsk.cfg, lwe_dimension=CPU_STEPS)
    rows = v.data[:CPU_ROWS]
    lwe = np.concatenate([rows[:, :CPU_STEPS], rows[:, -1:]], axis=1)
    rings = bsk.bsk_mxu[:CPU_STEPS]
    on_card = bsx.blind_rotate_mxu(cfg, rings, acc,
                                   torus.from_numpy(lwe, dev)).cpu()
    on_cpu = bsx.blind_rotate_mxu(cfg, rings.cpu(), acc.cpu(),
                                  torus.from_numpy(lwe))
    out, ks = outs["exact"]
    ks_cpu = lwe_ops.keyswitch_limbs(
        ksk.limbs.cpu(), torus.from_numpy(out.data[:KS_CPU_ROWS]),
        base_log=ks_bl, level_count=ks_l)
    if not (torch.equal(on_card, on_cpu) and
            np.array_equal(torus.to_numpy(ks_cpu), ks.data[:KS_CPU_ROWS])):
        raise AssertionError("CPU recomputation differs from the card")
    log(phase="cpu_check", params="int4", cmux_steps=CPU_STEPS, rows=CPU_ROWS,
        keyswitch_rows=KS_CPU_ROWS, bit_identical=True,
        seconds=time.perf_counter() - t0)
    return launches


def nuss_gates(dev, card):
    """D, part 1: a 2048-row request through AND and XOR on a
    backend="nuss" twin of a TFHE_LIB key (N=1024, L=32, M=32): every row on
    its truth table and equal to the mxu backend's, bit for bit."""
    rows = NUSS_GATE_ROWS
    cks, sks = boolean.gen_keys(PRESETS["TFHE_LIB"], secret_seed=11,
                                mask_seed=12, noise_seed=13, device=dev)
    mxu = dataclasses.replace(sks, backend="mxu")
    nuss = dataclasses.replace(sks, backend="nuss", _warmed_tiers=set())
    plan = bsn.NussPlan.from_config(nuss.cfg)
    t0 = time.perf_counter()
    nuss.bsk_nuss  # noqa: B018 - key preparation on the card
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    (a, b, c), (ca, cb, cc) = encrypt_bools(cks, rows, 4000)
    for gate in ("and_", "xor"):
        got = call_gate(nuss, gate, ca, cb, cc)
        if not np.array_equal(cks.decrypt(got), truth(gate, a, b, c)):
            raise AssertionError(f"TFHE_LIB nuss {gate}: wrong truth table")
        if not torch.equal(got, call_gate(mxu, gate, ca, cb, cc)):
            raise AssertionError(f"TFHE_LIB nuss {gate} differs from mxu")
    ca, cb = torus.from_numpy(ca, dev), torus.from_numpy(cb, dev)
    med = median_s(lambda: nuss.and_(ca, cb))
    log(phase="D", params="TFHE_LIB nuss", auto_backend=sks.resolved_backend(),
        L=plan.l, M=plan.m,
        n_sub=plan.n_sub, key_prep_s=prep_s, rows=rows, gates=["and_", "xor"],
        truth_tables="ok", equal_to_mxu=True, ms_per_call=med * 1e3,
        gates_per_s=rows / med, card=card)
    log_profile(f"TFHE_LIB nuss AND B={rows}", lambda: nuss.and_(ca, cb), card,
                gemm_ops=nuss_gemm_ops(plan, rows))


def nuss_int4(dev, card):
    """D, part 2: the int4 LUT of phase C at N = 8192 through the high-level
    API (auto backend -> nuss), 256 values and one multi-LUT call; every
    PBS row must decode under the big key."""
    (bl, lv), b = INT4["pbs"], INT4_8192["batch"]
    t0 = time.perf_counter()
    sk = hl.LWESecretKey.new(INT4["lwe"], secret_seed=21)
    rsk = hl.RLWESecretKey.new(INT4_8192["rlwe"], secret_seed=32)
    big = rsk.to_lwe_secret_key()
    bsk = hl.LWEBSK.new(sk, rsk, bl, lv, mask_seed=33, noise_seed=34,
                        device=dev)
    keygen_s = time.perf_counter() - t0
    if bsk.resolved_backend() != "nuss":
        raise AssertionError(f"N=8192 resolved to {bsk.resolved_backend()}")
    plan = bsn.NussPlan.from_config(bsk.cfg)
    t0 = time.perf_counter()
    rings = bsk.bsk_nuss
    torch.cuda.synchronize()
    log(phase="D", cell="int4 N=8192", auto_backend=bsk.resolved_backend(),
        backend="nuss", L=plan.l, M=plan.m,
        n_sub=plan.n_sub, keygen_s=keygen_s,
        key_prep_s=time.perf_counter() - t0,
        rings_gb=rings.numel() * 4 / 1e9)

    enc = hl.Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    xs = np.random.default_rng(35).integers(0, 16, size=b).astype(np.float64)
    want = (3 * xs + 1) % 16
    v = hl.VectorLWE.encode_encrypt(sk, xs, enc, mask_seed=36, noise_seed=37)
    out = v.bootstrap_all_with_function(bsk, int4_table, enc)
    wrong = int(np.sum(np.round(out.decrypt_decode(big)) != want))
    err = (big.inner.decrypt(out.data) - enc.encode_core(want)).view(np.int64)
    log(phase="D", cell="int4 N=8192", stage="pbs", rows=b, wrong_rows=wrong,
        phase_std=float(np.std(err * 2.0 ** -64)),
        tracked_std=math.sqrt(float(out.variances[0])), card=card)
    if wrong:
        raise AssertionError(f"int4 LUT at N=8192: {wrong} of {b} PBS rows "
                             "decode wrong")
    enc3, ct3, want3 = multi_lut_inputs(sk, xs, 38)
    check_multi_lut("int4 N=8192",
                    ct3.bootstrap_with_functions(bsk, MULTI_FNS, enc3), want3,
                    big)
    log(phase="D", cell="int4 N=8192", multi_lut_functions=len(MULTI_FNS),
        rows=b, decoded="ok")
    acc = torus.from_numpy(
        _accumulator(bsk, generate_functional_lut(bsk, enc, enc, int4_table)),
        dev)
    cts = torus.from_numpy(v.data, dev)
    med = median_s(lambda: bsk.run_bootstrap(acc, cts), reps=3)
    log(phase="D", cell="int4 N=8192", batch=b, ms_per_call=med * 1e3,
        pbs_per_s=b / med, card=card)
    log_profile(f"int4 N=8192 PBS B={b}", lambda: bsk.run_bootstrap(acc, cts),
                card, gemm_ops=nuss_gemm_ops(plan, b))


def nuss_engine(dev, card):
    """D, part 3: the JAX suite's engine rows at full width and depth, random
    keys from a fixed seed; key preparation on the card, the median of 5
    PBS calls, one profiled call. Returns the CPU cross-check of the u32
    N=8192 cell: the first CMux steps of a few rows."""
    rng = np.random.default_rng(41)
    n_lwe, (bl, lv), b = (NUSS_ENGINE["lwe_dimension"], NUSS_ENGINE["pbs"],
                          NUSS_ENGINE["batch"])
    cpu_check = None
    for n in NUSS_ENGINE["sizes"]:
        for bits in (32, 64):
            cfg = nuss_config(n, bits, bl, lv, n_lwe)
            plan = bsn.NussPlan.from_config(cfg)
            dt = torus.UNSIGNED[bits]
            bsk = rng.integers(0, np.iinfo(dt).max, size=(n_lwe, lv, 2, 2, n),
                               dtype=dt, endpoint=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rings = bsn.bsk_to_nuss(bsk, cfg, device=dev)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            lut = bs.trivial_lut_constant(cfg, 1 << (bits - 3), dev)
            cts = torus.from_numpy(rng.integers(
                0, np.iinfo(dt).max, size=(b, n_lwe + 1), dtype=dt,
                endpoint=True), dev)
            label = f"engine u{bits} N={n}"
            run = (lambda cfg=cfg, rings=rings, lut=lut, cts=cts:
                   bsn.bootstrap_nuss(cfg, rings, lut, cts))
            out = run()
            if out.shape != (b, n + 1):
                raise AssertionError(f"{label}: output {tuple(out.shape)}")
            med = median_s(run)
            log(phase="D", cell=label, auto_backend=bsn.resolve_backend(cfg, "auto"),
                backend="nuss", L=plan.l, M=plan.m, limbs=plan.limbs_used,
                key_prep_s=prep_s, batch=b, ms_per_call=med * 1e3,
                pbs_per_s=b / med, card=card)
            log_profile(f"{label} PBS B={b}", run, card, gemm_ops=nuss_gemm_ops(plan, b))
            if (n, bits) == (NUSS_ENGINE["sizes"][0], 32):
                engine_ntt(cfg, bsk, lut, cts, out, med, card)
            if n == NUSS_ENGINE["sizes"][0] and bits == 32:
                cpu_check = (cfg, bsk[:NUSS_CPU_STEPS], rings[:NUSS_CPU_STEPS],
                             lut, cts[:NUSS_CPU_ROWS])
            del rings, out
            torch.cuda.empty_cache()
    return cpu_check


def engine_ntt(cfg, bsk, lut, cts, nuss_out, nuss_s, card):
    """The u32 N=8192 engine cell on backend="ntt" (K9 every step), beside
    its nuss median: the measurement behind auto's u32 rule at large N. The
    output must equal the nuss backend's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spectra = bsk_to_ntt(bsk, cfg.primes, 32, device=cts.device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    run = lambda: bsntt.bootstrap(cfg, spectra, lut, cts)  # noqa: E731
    if not torch.equal(run(), nuss_out):
        raise AssertionError("engine u32 N=8192: ntt differs from nuss")
    med = median_s(run)
    log(phase="D", cell=f"engine u32 N={cfg.polynomial_size}", backend="ntt",
        k9=bsntt.kernel_applies(cfg), key_prep_s=prep_s, batch=cts.shape[0],
        ms_per_call=med * 1e3, pbs_per_s=cts.shape[0] / med,
        nuss_ms_per_call=nuss_s * 1e3, equal_to_nuss=True, card=card)
    log_profile(f"engine u32 N={cfg.polynomial_size} ntt PBS B={cts.shape[0]}",
                run, card)


def nuss_cpu_check(cfg, bsk, rings, lut, cts):
    """The first CMux steps of a few rows of the u32 N=8192 engine cell,
    key preparation included, through the port on the CPU: equal to the
    card bit for bit."""
    t0 = time.perf_counter()
    steps = bsk.shape[0]
    small = dataclasses.replace(cfg, lwe_dimension=steps)
    lwe = torch.cat([cts[:, :steps], cts[:, -1:]], dim=1)
    on_card = bsn.blind_rotate_nuss(small, rings, lut, lwe).cpu()
    rings_cpu = bsn.bsk_to_nuss(bsk, cfg, device="cpu")
    on_cpu = bsn.blind_rotate_nuss(small, rings_cpu, lut.cpu(), lwe.cpu())
    if not (torch.equal(rings_cpu, rings.cpu()) and torch.equal(on_card, on_cpu)):
        raise AssertionError("CPU recomputation of the nuss cell differs")
    log(phase="cpu_check", params="engine u32 N=8192 (nuss)", cmux_steps=steps,
        rows=cts.shape[0], key_prep_equal=True, bit_identical=True,
        seconds=time.perf_counter() - t0)


def phase_d(dev, card):
    """The Nussbaumer backend; returns the kernel launches of its main path
    (the CPU cross-check runs after the count is read)."""
    reset_launch_counts()
    nuss_gates(dev, card)
    torch.cuda.empty_cache()
    nuss_int4(dev, card)
    torch.cuda.empty_cache()
    cpu_check = nuss_engine(dev, card)
    torch.cuda.synchronize()
    launches = read_launches("D")
    log(phase="D", launches=launches)
    nuss_cpu_check(*cpu_check)
    return launches


def ntt_gate_server(name, params, dev, card):
    """E, per preset: the ntt twin of the phase-B key (same seeds) serving
    AND/XOR/NAND/MUX requests, AND equal to the mxu backend; the AND median
    beside the mxu one; K8 through the fused gate pipeline. Returns the
    TPU128 CPU cross-check inputs (else None) and the ntt AND's median
    seconds at B=2048."""
    cks, sks = boolean.gen_keys(params, secret_seed=11, mask_seed=12,
                                noise_seed=13, device=dev)
    auto = sks.resolved_backend()
    sks = dataclasses.replace(sks, backend="mxu")
    ntt = dataclasses.replace(sks, backend="ntt", _warmed_tiers=set())
    t0 = time.perf_counter()
    ntt.bsk_ntt, ntt.ksk8  # noqa: B018 - key preparation on the card
    torch.cuda.synchronize()
    log(phase="E", params=name, auto_backend=auto, backend=ntt.resolved_backend(),
        primes=list(ntt.cfg.primes), k9=bsntt.kernel_applies(ntt.cfg),
        key_prep_s=time.perf_counter() - t0,
        bsk_ntt_mb=ntt.bsk_ntt.numel() * 4 / 1e6)
    cpu_check = None
    for size in NTT_REQUESTS:
        (a, b, c), (ca, cb, cc) = encrypt_bools(cks, size, 5000 + size)
        for gate in GATES:
            out = call_gate(ntt, gate, ca, cb, cc)
            if not np.array_equal(cks.decrypt(out), truth(gate, a, b, c)):
                raise AssertionError(f"{name} ntt {gate} size {size}: wrong "
                                     "truth table")
            if gate == "and_":
                if not torch.equal(out, sks.and_(ca, cb)):
                    raise AssertionError(f"{name} ntt AND differs from mxu")
                if name == "TPU128" and size == 2048:
                    cpu_check = (ntt, ca[:NTT_CPU_ROWS], cb[:NTT_CPU_ROWS],
                                 out[:NTT_CPU_ROWS].cpu())
        log(phase="E", params=name, backend="ntt", request_rows=size,
            gates=list(GATES), truth_tables="ok", and_equal_to_mxu=True)
    (a, b, _), (ca, cb, _) = encrypt_bools(cks, 2048, 7)
    ca, cb = torus.from_numpy(ca, dev), torus.from_numpy(cb, dev)
    ntt_s = median_s(lambda: ntt.and_(ca, cb))
    mxu_s = median_s(lambda: sks.and_(ca, cb))
    log(phase="E", params=name, tier=2048, gate="and_",
        ntt_ms_per_call=ntt_s * 1e3, ntt_gates_per_s=2048 / ntt_s,
        mxu_ms_per_call=mxu_s * 1e3, mxu_gates_per_s=2048 / mxu_s, card=card)

    # AND's linear combination (server_key/mod.rs): a + b - 1/8 of the torus
    lin = ca + cb
    lin[:, -1] -= 1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR)

    def gate_mxu(fused):
        return bsx.bootstrap_keyswitch_mxu(sks.cfg, sks.bsk_mxu, sks.ksk8,
                                           sks._lut(), lin, fused=fused)

    fused_out = gate_mxu(True)
    if not np.array_equal(cks.decrypt(fused_out), a & b):
        raise AssertionError(f"{name}: the fused AND's truth table is wrong")
    if not torch.equal(fused_out, gate_mxu(False)):
        raise AssertionError(f"{name}: the fused gate differs from unfused")
    fused_s = median_s(lambda: gate_mxu(True), reps=3)
    unfused_s = median_s(lambda: gate_mxu(False), reps=3)
    log(phase="E", params=name, tier=2048, gate="and_ (bootstrap_keyswitch_mxu)",
        fused_equal_to_unfused=True, fused_ms_per_call=fused_s * 1e3,
        unfused_ms_per_call=unfused_s * 1e3, card=card)
    if name == "TPU128":
        log_profile("TPU128 ntt AND B=2048", lambda: ntt.and_(ca, cb), card)
        log_profile("TPU128 fused AND B=2048", lambda: gate_mxu(True), card)
    if name == "TFHE_LIB":
        fast = ntt.with_fast_mode()
        (a, b, _), (ca2, cb2, _) = encrypt_bools(cks, 2048, 3000)
        if not np.array_equal(cks.decrypt(fast.and_(ca2, cb2)), a & b):
            raise AssertionError("TFHE_LIB fast ntt AND: wrong truth table")
        ca2, cb2 = torus.from_numpy(ca2, dev), torus.from_numpy(cb2, dev)
        med = median_s(lambda: fast.and_(ca2, cb2), reps=3)
        log(phase="E", params="TFHE_LIB fast (levels=2) ntt",
            primes=list(fast.cfg.primes), tier=2048, truth_tables="ok",
            ms_per_call=med * 1e3, gates_per_s=2048 / med, card=card)
    return cpu_check, ntt_s


def ntt_int4(dev, card):
    """E: the int4 LUT of phase C through LWEBSK(backend="ntt") at B=256
    (u64, three primes: the torch composition on the card): one PBS and
    one multi-LUT call, every row decoded under the big key, equal to the
    mxu backend, the PBS timed once."""
    (bl, lv), b = INT4["pbs"], INT4_NTT_BATCH
    sk = hl.LWESecretKey.new(INT4["lwe"], secret_seed=21)
    rsk = hl.RLWESecretKey.new(INT4["rlwe"], secret_seed=22)
    big = rsk.to_lwe_secret_key()
    bsk = hl.LWEBSK.new(sk, rsk, bl, lv, mask_seed=23, noise_seed=24,
                        device=dev, backend="ntt")
    t0 = time.perf_counter()
    bsk.bsk_ntt  # noqa: B018 - key preparation on the card
    torch.cuda.synchronize()
    log(phase="E", cell=f"int4 ntt B={b}", primes=list(bsk.cfg.primes),
        k9=bsntt.kernel_applies(bsk.cfg), key_prep_s=time.perf_counter() - t0)
    enc = hl.Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    xs = np.random.default_rng(27).integers(0, 16, size=b).astype(np.float64)
    v = hl.VectorLWE.encode_encrypt(sk, xs, enc, mask_seed=28, noise_seed=29)
    out = v.bootstrap_all_with_function(bsk, int4_table, enc)
    wrong = int(np.sum(np.round(out.decrypt_decode(big)) != (3 * xs + 1) % 16))
    if wrong:
        raise AssertionError(f"int4 ntt: {wrong} of {b} PBS rows decode wrong")
    acc = torus.from_numpy(
        _accumulator(bsk, generate_functional_lut(bsk, enc, enc, int4_table)),
        dev)
    cts = torus.from_numpy(v.data, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bsk.run_bootstrap(acc, cts)
    torch.cuda.synchronize()
    pbs_s = time.perf_counter() - t0
    mxu = dataclasses.replace(bsk, backend="mxu")
    if not torch.equal(got, mxu.run_bootstrap(acc, cts)):
        raise AssertionError("int4 ntt PBS differs from mxu")
    enc3, ct3, want3 = multi_lut_inputs(sk, xs, 30)
    check_multi_lut("int4 ntt", ct3.bootstrap_with_functions(bsk, MULTI_FNS, enc3),
                    want3, big)
    log(phase="E", cell=f"int4 ntt B={b}", rows=b, wrong_rows=0,
        multi_lut_functions=len(MULTI_FNS), equal_to_mxu=True,
        ms_per_call=pbs_s * 1e3, pbs_per_s=b / pbs_s, card=card)


def phase_e(dev, card):
    """The ntt backend and the fused step; returns the kernel launches of
    the main path (the CPU cross-check runs after the count is read) and
    the ntt AND's median seconds at B=2048 per preset."""
    reset_launch_counts()
    cpu_check, ntt_and_s = None, {}
    for name, params in PRESETS.items():
        check, ntt_and_s[name] = ntt_gate_server(name, params, dev, card)
        cpu_check = check or cpu_check
        torch.cuda.empty_cache()
    ntt_int4(dev, card)
    torch.cuda.synchronize()
    launches = read_launches("E")
    log(phase="E", launches=launches)
    t0 = time.perf_counter()
    ntt, ca, cb, want = cpu_check
    if not torch.equal(ntt.to("cpu").and_(ca, cb), want):
        raise AssertionError("CPU recomputation of the ntt AND differs")
    log(phase="cpu_check", params="TPU128 ntt", gate="and_", rows=NTT_CPU_ROWS,
        bit_identical=True, seconds=time.perf_counter() - t0)
    return launches, ntt_and_s


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def check_digests(found: dict[str, str]):
    """Each digest equal to concrete_tpu's (DIGESTS)."""
    bad = {k: (v, DIGESTS[k]) for k, v in found.items() if v != DIGESTS[k]}
    log(phase="F", digests=found, equal_to_concrete_tpu=not bad)
    if bad:
        raise AssertionError(f"phase F digests differ from concrete_tpu's: {bad}")


def keygen_parts(cks, sks, dev):
    """Set-up seconds by part for a boolean key: the server key's BSK made
    once more with the same seeds by the batched generator with its
    timings (the same bytes, checked), and the key preparation on the card
    of the ntt spectra, of the toeplitz rings of an mxu twin and of the KSK
    limbs. Returns (parts, the mxu twin)."""
    p = cks.parameters
    _, m, n = PHASE_F["gate_seeds"]
    parts = {}
    t0 = time.perf_counter()
    bsk = StandardBootstrapKey.generate(
        cks.lwe_secret_key, cks.glwe_secret_key, p.pbs_base_log, p.pbs_level,
        p.glwe_modular_std_dev.std_dev, EncryptionRandomGenerator(m, n),
        device=dev, timings=parts)
    parts["bsk_s"] = time.perf_counter() - t0
    if not np.array_equal(bsk.data, sks.bsk_standard):
        raise AssertionError("the timed BSK differs from gen_keys'")
    mxu = dataclasses.replace(sks, backend="mxu", _warmed_tiers=set())
    for name, prep in (("ntt", lambda: sks.bsk_ntt),
                       ("mxu", lambda: mxu.bsk_mxu),
                       ("ksk_limbs", lambda: sks.ksk8)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep()
        torch.cuda.synchronize()
        parts[f"key_prep_{name}_s"] = time.perf_counter() - t0
    mxu._ksk8 = sks.ksk8
    return parts, mxu


ADDER_GATES = 2 + 3 * (PHASE_F["nbits"] - 1)   # XOR + AND, then XOR XOR MUX


def phase_f(dev, card):
    """The client side on the AES-CTR streams and the 8-bit adder at
    DEFAULT (see the module docstring). Returns the kernel launches of the
    adders' run."""
    f = PHASE_F
    numpy_calls = aes.NUMPY_CALLS
    aesni = native.has_aesni()
    gen = AesCtrGenerator(key=1)
    t0 = time.perf_counter()
    gen.generate_bytes(1 << 26)
    log(phase="F", aes="native", library=native.lib_path().name, aesni=aesni,
        aes_bytes_per_s=(1 << 26) / (time.perf_counter() - t0))
    found = {}
    s, m, n = f["gate_seeds"]
    keys = {}
    for name in f["presets"]:
        t0 = time.perf_counter()
        cks, sks = boolean.gen_keys(PRESETS[name], secret_seed=s, mask_seed=m,
                                    noise_seed=n, device=dev)
        keygen_s = time.perf_counter() - t0
        found.update({f"{name} lwe_key": digest(cks.lwe_secret_key.key),
                      f"{name} glwe_key": digest(cks.glwe_secret_key.key),
                      f"{name} bsk": digest(sks.bsk_standard),
                      f"{name} ksk": digest(sks.ksk)})
        parts, mxu = keygen_parts(cks, sks, dev)
        log(phase="F", params=name, keygen_s=keygen_s, **parts, card=card)
        keys[name] = (cks, sks, mxu)
    s_lwe, s_rlwe, bm, bn, km, kn = f["int4_seeds"]
    t0 = time.perf_counter()
    sk = hl.LWESecretKey.new(INT4["lwe"], secret_seed=s_lwe)
    rsk = hl.RLWESecretKey.new(INT4["rlwe"], secret_seed=s_rlwe)
    bsk = hl.LWEBSK.new(sk, rsk, *INT4["pbs"], mask_seed=bm, noise_seed=bn,
                        device=dev)
    ksk = hl.LWEKSK.new(rsk.to_lwe_secret_key(), sk, *INT4["ks"], mask_seed=km,
                        noise_seed=kn, device=dev)
    log(phase="F", params="int4", keygen_s=time.perf_counter() - t0, card=card)
    found.update({"int4 lwe_key": digest(sk.inner.key),
                  "int4 rlwe_key": digest(rsk.inner.key),
                  "int4 bsk": digest(bsk.coefficient_bsk),
                  "int4 ksk": digest(ksk.inner.data)})
    del bsk, ksk

    cks, sks, mxu = keys["DEFAULT"]
    del keys
    a, b = adder_values()
    t0 = time.perf_counter()
    a_bits = circuits.encrypt_uint(cks, a, f["nbits"], mask_seed=f["a_seeds"][0],
                                   noise_seed=f["a_seeds"][1])
    b_bits = circuits.encrypt_uint(cks, b, f["nbits"], mask_seed=f["b_seeds"][0],
                                   noise_seed=f["b_seeds"][1])
    encrypt_s = time.perf_counter() - t0
    found.update({"a planes": digest(a_bits), "b planes": digest(b_bits)})
    if sks.resolved_backend() != "ntt":
        raise AssertionError(f"DEFAULT auto is {sks.resolved_backend()}, not ntt")
    for key in (sks, mxu):
        key.warmup([f["rows"]], gates=("xor", "and"), mux=True)
    a_dev, b_dev = torus.from_numpy(a_bits, dev), torus.from_numpy(b_bits, dev)
    log(phase="F", rows=f["rows"], encrypt_uint_s=encrypt_s)

    t0 = time.perf_counter()
    reset_launch_counts()
    outs = {key.resolved_backend(): circuits.ripple_carry_adder(key, a_dev, b_dev)
            for key in (sks, mxu)}
    torch.cuda.synchronize()
    launches = read_launches("F")
    log(phase="F", main_path_s=time.perf_counter() - t0, launches=launches)

    sums, carry = outs["ntt"]
    if not (torch.equal(sums, outs["mxu"][0]) and torch.equal(carry, outs["mxu"][1])):
        raise AssertionError("the adder's ntt and mxu outputs differ")
    total = a + b
    got = circuits.decrypt_uint(cks, sums)
    wrong = int(np.sum(got != total % 256))
    wrong_carry = int(np.sum(cks.decrypt(carry) != (total >= 256)))
    r = f["ref_rows"]
    found.update({"adder sums": digest(torus.to_numpy(sums[:, :r])),
                  "adder carry": digest(torus.to_numpy(carry[:r]))})
    log(phase="F", rows=f["rows"], wrong_sums=wrong, wrong_carries=wrong_carry,
        backends_bit_identical=True)
    if wrong or wrong_carry:
        raise AssertionError(f"adder: {wrong} sums, {wrong_carry} carries wrong")
    for key in (sks, mxu):
        med = median_s(lambda key=key: circuits.ripple_carry_adder(key, a_dev, b_dev),
                       reps=3)
        log(phase="F", backend=key.resolved_backend(), rows=f["rows"],
            ms_per_add=med * 1e3, adds_per_s=f["rows"] / med,
            gates_per_s=ADDER_GATES * f["rows"] / med, card=card)
    log_profile(f"DEFAULT ntt 8-bit add B={f['rows']}",
                lambda: circuits.ripple_carry_adder(sks, a_dev, b_dev), card)

    big = cks.glwe_secret_key.into_lwe_key()
    bl, lv = f["ks"]
    std = PRESETS["DEFAULT"].lwe_modular_std_dev.std_dev
    kskey = lwe_ops.LweKeyswitchKey.generate(
        big, cks.lwe_secret_key, bl, lv, std,
        EncryptionRandomGenerator(*f["ks_seeds"]))
    msgs = np.arange(f["ks_rows"], dtype=np.uint32) << np.uint32(24)
    cts = big.encrypt(msgs, std, EncryptionRandomGenerator(*f["ks_ct_seeds"]))
    on_card = lwe_ops.keyswitch(kskey.data, torus.from_numpy(cts, dev),
                                base_log=bl, level_count=lv).cpu()
    on_cpu = lwe_ops.keyswitch(kskey.data, torus.from_numpy(cts),
                               base_log=bl, level_count=lv)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("the general keyswitch on the card differs from "
                             "its CPU recomputation")
    found.update({"ks key": digest(kskey.data),
                  "ks out": digest(torus.to_numpy(on_card))})
    log(phase="F", keyswitch=f"{big.dimension}->{cks.lwe_secret_key.dimension}",
        base_log=bl, level=lv, rows=f["ks_rows"], cpu_bit_identical=True)
    check_digests(found)
    if aes.NUMPY_CALLS != numpy_calls:
        raise AssertionError("phase F ran the numpy AES")
    return launches


def noise_entries() -> list:
    """(label, fixture class, entry, repetitions) of phase G's full-width
    noise entries: PbsFixture at the three gate presets' full n, k, N,
    base_log and level on ntt and mxu, TFHE_LIB also on nuss; U64PbsFixture
    at the int4 shape on mxu and at N=8192 on nuss; the grid's own N=8192
    PbsFixture entry at the class's REPETITIONS x SAMPLE_SIZE; a u32
    N=16384 nuss entry."""
    out = []
    for name, p in PRESETS.items():
        entry = {"n": p.lwe_dimension, "k": p.glwe_dimension,
                 "N": p.polynomial_size, "base_log": p.pbs_base_log,
                 "levels": p.pbs_level, "samples": NOISE_SAMPLES}
        for backend in ("ntt", "mxu") + (("nuss",) if name == "TFHE_LIB" else ()):
            out.append((f"{name} {backend}", fixtures.PbsFixture,
                        dict(entry, backend=backend), NOISE_REPS))
    (bl, lv), n = INT4["pbs"], INT4["lwe"].dimension
    int4 = {"n": n, "k": 1, "N": INT4["rlwe"].polynomial_size, "base_log": bl,
            "levels": lv}
    out.append(("int4 u64 mxu", fixtures.U64PbsFixture,
                dict(int4, backend="mxu", samples=NOISE_SAMPLES), NOISE_REPS))
    out.append(("int4 u64 N=8192 nuss", fixtures.U64PbsFixture,
                dict(int4, N=8192, backend="nuss", samples=256), NOISE_REPS))
    fx = fixtures.PbsFixture
    grid = next(e for e in fx.PARAMETERS if e["N"] == 8192)
    entry = {k: v for k, v in grid.items() if k not in ("reps", "samples")}
    out.append(("grid N=8192 nuss", fx, dict(entry, samples=fx.SAMPLE_SIZE),
                fx.REPETITIONS))
    out.append(("u32 N=16384 nuss", fx,
                {"n": 100, "k": 1, "N": 16384, "base_log": 7, "levels": 2,
                 "backend": "nuss", "samples": 256}, NOISE_REPS))
    return out


def phase_g_noise(dev, card):
    """Each full-width entry through its fixture's run_one (fresh keys from
    the fixture's seeds each repetition, the criterion unchanged:
    assert_noise_bounded, slack 0.5 bit); the measured phase-error std
    beside the NPE's."""
    for label, cls, entry, reps in noise_entries():
        fx = cls()
        fx.device = dev
        t0 = time.perf_counter()
        for rep in range(reps):
            measured, predicted = fx.run_one(entry, rep_seed=1000 * rep + 7)
            log(phase="G", noise_entry=label, fixture=fx.name, entry=entry,
                rep=rep, measured_std=measured, npe_std=predicted,
                ratio=measured / predicted, bound_ratio=2.0 ** 0.5, card=card)
        log(phase="G", noise_entry=label, reps=reps,
            seconds=time.perf_counter() - t0)


def vrlwe_values() -> tuple[np.ndarray, np.ndarray]:
    """Phase G's 4-bit messages: x in [0, 15] and y in [0, 15 - x], one per
    coefficient of PHASE_G["ciphertexts"] RLWE ciphertexts of N=1024, so
    that c * (x + y) stays in the added encoder's interval for c <= 2."""
    rng = np.random.default_rng(PHASE_G["values_seed"])
    rows = PHASE_G["ciphertexts"] * INT4["rlwe"].polynomial_size
    x = rng.integers(0, 16, size=rows)
    y = rng.integers(0, 16 - x)
    return x.astype(np.float64), y.astype(np.float64)


def pbs_expected(ks, sk, lut: np.ndarray, n: int) -> np.ndarray:
    """The torus value each PBS row must carry, read from the LUT where the
    row's modulus-switched phase points (what the blind rotation computes
    exactly): LUT[p] for p < N, -LUT[p - N] above (negacyclic)."""
    hat = bs.pbs_modulus_switch(torus.from_numpy(ks.data), n).numpy()
    key = sk.inner.key.astype(np.int64)
    phase = (hat[:, -1].astype(np.int64) - hat[:, :-1].astype(np.int64) @ key) \
        % (2 * n)
    lo = lut[np.minimum(phase, n - 1)]
    hi = (np.uint64(0) - lut[np.maximum(phase - n, 0)]).astype(np.uint64)
    return np.where(phase < n, lo, hi)


def phase_g_vector_rlwe(dev, card):
    """VectorRLWE at full width: 8 x 1024 packed 4-bit messages, added to a
    second vector and multiplied by a constant per ciphertext, every value
    decoded right; every coefficient extracted (dimension 1024),
    keyswitched to 630 (checked against the noise model as in phase C) and
    bootstrapped through the int4 LUT on LWEBSK (auto: mxu, K4 + K1), every
    row equal to the LUT entry its modulus-switched phase selects; the
    packed ciphertexts' digests equal to concrete_tpu's."""
    g = PHASE_G
    t0 = time.perf_counter()
    sk = hl.LWESecretKey.new(INT4["lwe"], secret_seed=g["lwe_seed"])
    rsk = hl.RLWESecretKey.new(INT4["rlwe"], secret_seed=g["rlwe_seed"])
    big = rsk.to_lwe_secret_key()
    ksk = hl.LWEKSK.new(big, sk, *INT4["ks"], mask_seed=g["ksk_seeds"][0],
                        noise_seed=g["ksk_seeds"][1], device=dev)
    bsk = hl.LWEBSK.new(sk, rsk, *INT4["pbs"], mask_seed=g["bsk_seeds"][0],
                        noise_seed=g["bsk_seeds"][1], device=dev)
    bsk.bsk_mxu, ksk.limbs  # noqa: B018 - evaluation keys onto the card
    torch.cuda.synchronize()
    log(phase="G", stage="VectorRLWE keys", auto_backend=bsk.resolved_backend(),
        seconds=time.perf_counter() - t0)
    if bsk.resolved_backend() != "mxu":
        raise AssertionError(f"int4 LWEBSK auto is {bsk.resolved_backend()}")
    enc = hl.Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    x, y = vrlwe_values()
    a, b = (log_profile(f"encode_encrypt_packed {name}",
                        lambda v=v, ms=ms, ns=ns: hl.VectorRLWE.encode_encrypt_packed(
                            rsk, v, enc, mask_seed=ms, noise_seed=ns, device=dev),
                        card, phase="G")
            for name, v, (ms, ns) in (("a", x, g["a_seeds"]),
                                      ("b", y, g["b_seeds"])))
    consts = np.asarray(g["constants"])
    out = log_profile("add_with_padding + mul_constant_static_encoder",
                      lambda: a.add_with_padding(b).mul_constant_static_encoder(consts),
                      card, phase="G")
    want = np.repeat(consts, rsk.polynomial_size) * (x + y)
    dec = log_profile("decrypt_decode", lambda: out.decrypt_decode(rsk), card,
                      phase="G")
    wrong = int(np.sum(np.round(dec) != want))
    log(phase="G", stage="VectorRLWE arithmetic", values=want.size,
        wrong=wrong, nb_valid=out.nb_valid())
    if wrong or out.nb_valid() != want.size:
        raise AssertionError(f"VectorRLWE: {wrong} of {want.size} values "
                             "decode wrong")
    found = {"vrlwe a": digest(a.data), "vrlwe b": digest(b.data),
             "vrlwe add_mul": digest(out.data)}

    def extract():
        parts = [a.extract_bunch_of_lwes(range(a.polynomial_size), i)
                 for i in range(a.nb_ciphertexts)]
        return hl.VectorLWE(np.concatenate([p.data for p in parts]),
                            [e for p in parts for e in p.encoders],
                            np.concatenate([p.variances for p in parts]))

    lwes = log_profile("extract_bunch_of_lwes", extract, card, phase="G")
    if lwes.data.shape != (x.size, big.dimension + 1):
        raise AssertionError(f"extracted {lwes.data.shape}")
    if not np.array_equal(np.round(lwes.decrypt_decode(big)), x):
        raise AssertionError("extracted LWEs decode wrong under the big key")
    found["vrlwe extracted"] = digest(lwes.data)
    check_digests_g(found)
    ks = log_profile("keyswitch 1024 -> 630", lambda: lwes.keyswitch(ksk), card,
                     phase="G")
    check_keyswitched("VectorRLWE", ks, sk, enc, x, ksk, card, phase="G")
    pbs = log_profile("PBS int4 LUT (mxu)",
                      lambda: ks.bootstrap_all_with_function(bsk, int4_table, enc),
                      card, phase="G")
    lut = generate_functional_lut(bsk, enc, enc, int4_table)
    expect = np.round(enc.decode_core(pbs_expected(ks, sk, lut,
                                                   bsk.polynomial_size)))
    got = np.round(pbs.decrypt_decode(big))
    lut_x = (3 * x + 1) % 16
    at_pbs = expect == lut_x            # input in x's box at the PBS
    ks_right = np.round(ks.decrypt_decode(sk)) == x
    log(phase="G", stage="VectorRLWE PBS", rows=x.size,
        keyswitched_right=int(ks_right.sum()), right_at_pbs=int(at_pbs.sum()),
        pbs_right=int((got == lut_x).sum()),
        pbs_equal_to_lut_entry=int((got == expect).sum()), card=card)
    if not (np.array_equal(got, expect) and np.all(got[at_pbs] == lut_x[at_pbs])):
        raise AssertionError("VectorRLWE PBS rows differ from the LUT entries "
                             "their modulus-switched phases select")


def check_digests_g(found: dict[str, str]):
    """Each VectorRLWE digest equal to concrete_tpu's (DIGESTS_G)."""
    bad = {k: (v, DIGESTS_G.get(k)) for k, v in found.items()
           if v != DIGESTS_G.get(k)}
    log(phase="G", digests=found, equal_to_concrete_tpu=not bad)
    if bad:
        raise AssertionError(f"phase G digests differ from concrete_tpu's: {bad}")


def phase_g_design(card, ntt_and_s):
    """design.search on the card's cost model (concrete_tpu's sweep ranges)
    and its top candidate; per gate preset the modelled ntt gates/s beside
    phase E's measured ntt AND at B=2048 (`ntt_and_s`, seconds per preset;
    within a factor of 2), and report_pbs_efficiency of that call."""
    t0 = time.perf_counter()
    cands = design.search()
    model = design.GpuCostModel()
    top = cands[0]
    log(phase="G", design_candidates=len(cands),
        top=dataclasses.asdict(top.params) | {"gates_per_s": top.gates_per_s,
                                              "err_log2": top.err_log2},
        k9_share=model.k9_share, ks_share=model.ks_share,
        seconds=time.perf_counter() - t0)
    for name, p in PRESETS.items():
        if name not in ntt_and_s:
            log(phase="G", params=name, modelled_gates_per_s=model.gates_per_s(p),
                measured="not measured (phase E not run)")
            continue
        measured = 2048 / ntt_and_s[name]
        modelled = model.gates_per_s(p, 2048)
        eff = report_pbs_efficiency(bs.ServerConfig.from_boolean_parameters(p),
                                    2048, ntt_and_s[name])
        log(phase="G", params=name, modelled_gates_per_s=modelled,
            measured_gates_per_s=measured, ratio=modelled / measured,
            pbs_efficiency=eff, card=card)
        if not 0.5 <= modelled / measured <= 2.0:
            raise AssertionError(f"{name}: modelled {modelled:.0f} gates/s "
                                 f"vs measured {measured:.0f}")


def phase_g(dev, card, ntt_and_s):
    """The probe, the conformance grid on the card, the full-width noise
    entries, VectorRLWE and the design model (against phase E's ntt AND
    seconds, `ntt_and_s`). Returns the kernel launches of its main path
    (all but the probe and the design)."""
    t0 = time.perf_counter()
    rc = diagnose.main()
    log(phase="G", probe_rc=rc, seconds=time.perf_counter() - t0)
    if rc:
        raise AssertionError(f"diagnose.main() returned {rc}")
    reset_launch_counts()
    t0 = time.perf_counter()
    reports = fixtures.run_all(repetitions=1, sample_size=100, device=dev)
    log(phase="G", grid_seconds=time.perf_counter() - t0,
        reports=[[r.name, r.parameters, r.passed] for r in reports])
    failed = [(r.name, r.parameters, r.detail) for r in reports if not r.passed]
    if failed or len(reports) != GRID_REPORTS:
        raise AssertionError(f"grid: {len(reports)} reports, failed: {failed}")
    phase_g_noise(dev, card)
    torch.cuda.empty_cache()
    phase_g_vector_rlwe(dev, card)
    torch.cuda.synchronize()
    launches = read_launches("G")
    log(phase="G", launches=launches)
    phase_g_design(card, ntt_and_s)
    return launches


def timed(fn):
    """(seconds, output) of one synchronised call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def h1_cell(name, pipeline, fn, unsharded, args, cks, a, b, card, total):
    """One H1 pipeline: its output equal to the unsharded call's and AND's
    truth table; PHASE_H["reps"] timed calls of each, in turn, their
    medians and every time logged; the launches of the pipeline's timed
    calls alone (reset just before each, read just after) must include
    H1_KERNELS[pipeline] and are added to `total`."""
    want = unsharded(*args)
    if not np.array_equal(cks.decrypt(want), a & b):
        raise AssertionError(f"{name} {pipeline}: AND's truth table")
    pmesh.reset_sent_bytes()
    counted, mesh_t, base_t = {}, [], []
    for _ in range(PHASE_H["reps"]):   # in turn: host drift falls on both
        base_t.append(timed(lambda: unsharded(*args))[0])
        reset_launch_counts()
        secs, out = timed(lambda: fn(*args))
        add_launches("H1", counted)
        mesh_t.append(secs)
        if not torch.equal(out, want):
            raise AssertionError(f"{name} {pipeline}: differs from the "
                                 "unsharded call")
    launches = {k: n for k, n in counted.items() if n}
    for k, n in counted.items():
        total[k] = total.get(k, 0) + n
    mesh_s, base_s = statistics.median(mesh_t), statistics.median(base_t)
    log(phase="H1", params=name, pipeline=pipeline, mesh="1x1 nccl",
        batch=PHASE_H["batch"], bit_identical=True, truth_table="ok",
        ms_per_call=mesh_s * 1e3, unsharded_ms_per_call=base_s * 1e3,
        wrapper_ms=(mesh_s - base_s) * 1e3, ms_each=[t * 1e3 for t in mesh_t],
        unsharded_ms_each=[t * 1e3 for t in base_t],
        sent_bytes=pmesh.sent_bytes(), launches_in_timed_calls=launches,
        card=card)
    missing = [k for k in H1_KERNELS[pipeline] if k not in launches]
    if missing:
        raise AssertionError(f"H1 {name} {pipeline} never launched {missing}")


def phase_h1(dev, card):
    """Every pipeline of parallel/mesh.py on a world of one (NCCL), at full
    width, against the unsharded call. Returns the launches of the
    pipelines' timed calls."""
    total = {}
    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "h1_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1, "cuda")
        for name in ("TPU128", "DEFAULT", "TFHE_LIB"):
            cks, sks = boolean.gen_keys(PRESETS[name], secret_seed=11,
                                        mask_seed=12, noise_seed=13,
                                        device=dev)
            cfg = sks.cfg
            (a, b, _), (ca, cb, _) = encrypt_bools(cks, PHASE_H["batch"],
                                                   PHASE_H["seed"])
            lin = torus.from_numpy(ca, dev) + torus.from_numpy(cb, dev)
            lin[:, -1] -= 1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR)   # AND
            lut = sks._lut()
            if name == "TFHE_LIB":     # phase D's backend="nuss" twin
                nuss = (sks.bsk_nuss, sks.ksk8, lut, lin)
                cells = [("gate_pipeline_dp_tp_nuss",
                          pmesh.gate_pipeline_dp_tp_nuss(cfg, mesh),
                          lambda *x: bsn.bootstrap_keyswitch_nuss(cfg, *x),
                          nuss)]
            else:
                mxu = (sks.bsk_mxu, sks.ksk8, lut, lin)
                ntt = (sks.bsk_ntt, sks.ksk8, lut, lin)
                cells = [
                    ("gate_pipeline_dp mxu",
                     pmesh.gate_pipeline_dp(cfg, mesh, "mxu"),
                     lambda *x: bsx.bootstrap_keyswitch_mxu(cfg, *x), mxu),
                    ("gate_pipeline_dp ntt",
                     pmesh.gate_pipeline_dp(cfg, mesh, "ntt"),
                     lambda *x: bsntt.bootstrap_keyswitch(cfg, *x), ntt),
                    ("gate_pipeline_dp_tp_mxu",
                     pmesh.gate_pipeline_dp_tp_mxu(cfg, mesh),
                     lambda *x: bsx.bootstrap_keyswitch_mxu(cfg, *x), mxu)]
            if name == "TPU128":
                cells.append(("gate_pipeline_dp_tp (ntt, level split)",
                              pmesh.gate_pipeline_dp_tp(cfg, mesh),
                              lambda *x: bsntt.bootstrap_keyswitch(cfg, *x),
                              ntt))
            for pipeline, fn, unsharded, args in cells:
                h1_cell(name, pipeline, fn, unsharded, args, cks, a, b, card,
                        total)
            del sks, cells
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


def phase_h2(card):
    """multihost.run(2, 1) on the card: two processes on gloo (CUDA
    tensors), the toy and TPU128 real-key tiers, dp then tp across the
    processes; every rank's seconds and bytes sent beside the plan's."""
    t0 = time.perf_counter()
    stats = multihost.run(PHASE_H["h2_processes"], 1, timeout=600,
                          device="cuda", backend="gloo",
                          batch=PHASE_H["h2_batch"])
    for s in stats:
        if s["sent_bytes"] != s["planned_bytes"]:
            raise AssertionError(f"H2 {s['tag']} rank {s['rank']}: sent "
                                 f"{s['sent_bytes']} bytes, the plan says "
                                 f"{s['planned_bytes']}")
        log(phase="H2", backend="gloo (CUDA tensors)", batch=PHASE_H["h2_batch"],
            **s, card=card)
    log(phase="H2", processes=PHASE_H["h2_processes"], calls=len(stats),
        bit_identical=True, and_truth_table="ok",
        seconds=time.perf_counter() - t0)


def phase_h3(card):
    """The seven examples at their published parameters and sizes on the
    card, each checking its own answers."""
    for name in examples.NAMES:
        t0 = time.perf_counter()
        mod = importlib.import_module(f"concrete_tpu_torch.examples.{name}")
        lines = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        log(phase="H3", example=name, lines=len(lines), answers="ok",
            seconds=time.perf_counter() - t0, card=card)


def phase_h(dev, card):
    """parallel/ and the examples; returns the kernel launches of two
    paths, H1 (the pipelines' timed calls) and H3 (the examples); H2's
    ranks count in their own processes."""
    t0 = time.perf_counter()
    h1 = phase_h1(dev, card)
    log(phase="H1", launches=h1, launches_by_shape=PATH_SHAPES["H1"],
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_h2(card)
    log(phase="H2", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    reset_launch_counts()
    phase_h3(card)
    torch.cuda.synchronize()
    h3 = read_launches("H3")
    log(phase="H3", launches=h3, seconds=time.perf_counter() - t0)
    return {"H1": h1, "H3": h3}


def log_row_launches():
    """Each keyed phase-A row beside the launches of its shape key on the
    main paths that run its kernel (phases B-E) and launches x (ms - bound
    ms), the time the card could save there."""
    for kernel, label, key, ms, bound in KEYED_ROWS:
        n = sum(shapes.get(kernel, {}).get(key, 0)
                for path, shapes in PATH_SHAPES.items()
                if kernel in PATH_KERNELS[path])
        log(phase="A_launches", kernel=kernel, shape=label, key=key,
            launches=n, ms=ms, bound_ms=bound,
            launches_x_gap_s=n * (ms - bound) * 1e-3)


def check_launched(path: str, launches: dict):
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase {path} never launched {missing}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="ABCDEFGH",
                        help="phases to run (default all: ABCDEFGH)")
    phases = parser.parse_args().phases
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one GPU")
    dev = torch.device("cuda")
    card = card_line()
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    _cuda.load_all()
    build_s = time.perf_counter() - t0
    log(phase="build", seconds=build_s, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    for name in _cuda.SOURCES:
        log_path = _cuda.build_log(name)
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "Used" in line or "spill" in line or "Compiling" in line:
                    print(f"ptxas ({name}):", line.strip(), flush=True)

    t0 = time.perf_counter()
    rows = phase_a(dev, card)
    log(phase="A", seconds=time.perf_counter() - t0)
    path_launches = {}

    if "B" in phases:
        t0 = time.perf_counter()
        reset_launch_counts()
        cpu_check = phase_b(dev, card)
        path_launches["B"] = read_launches("B")
        log(phase="B", seconds=time.perf_counter() - t0,
            launches=path_launches["B"])
        check_launched("B", path_launches["B"])

        t0 = time.perf_counter()
        sks, ca, cb, want = cpu_check
        got = sks.to("cpu").and_(ca, cb)
        if not torch.equal(got, want):
            raise AssertionError("CPU recomputation differs from the card")
        log(phase="cpu_check", rows=CPU_ROWS, params="TPU128", gate="and_",
            bit_identical=True, seconds=time.perf_counter() - t0)
        del sks, cpu_check
        torch.cuda.empty_cache()

    ntt_and_s = {}   # phase E's ntt AND seconds, phase G's design check
    for path, run in (("C", phase_c), ("D", phase_d), ("E", phase_e),
                      ("F", phase_f), ("G", phase_g), ("H", phase_h)):
        if path in phases:
            t0 = time.perf_counter()
            if path == "E":
                path_launches[path], ntt_and_s = run(dev, card)
            elif path == "G":
                path_launches[path] = run(dev, card, ntt_and_s)
            elif path == "H":
                path_launches.update(run(dev, card))
            else:
                path_launches[path] = run(dev, card)
            log(phase=path, seconds=time.perf_counter() - t0)
            for p in ("H1", "H3") if path == "H" else (path,):
                check_launched(p, path_launches[p])
            torch.cuda.empty_cache()
    log(phase="all", seconds=time.perf_counter() - t_all)
    log_row_launches()

    launches = {k: sum(counts[k] for path, counts in path_launches.items()
                       if k in PATH_KERNELS[path]) for k in REPLACES}
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[k], "max_abs_err": rows[k]["max_abs_err"],
         "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
         "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k]["bound_by"],
         "library_ms": None}
        for k, (src, tpu) in REPLACES.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
