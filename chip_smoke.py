#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of concrete-tpu once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc; it imports no JAX. The phases, in order:

  build   compile csrc/mxu_kernels.cu for sm_90a (concrete_tpu_torch/_build/).
  A       each hand-written kernel against its plain PyTorch version on the
          card, at the shapes of the main path, bit for bit, with both
          device times (CUDA graph replay between CUDA events).
  B       a boolean-gate server at full width: for TPU128, DEFAULT and
          TFHE_LIB parameters, key generation from fixed seeds, warmup of
          the batch tiers, then requests of mixed sizes through AND, XOR,
          NAND and MUX, every row decrypted against its truth table; 32 rows
          of one TPU128 AND request recomputed through the port on the CPU
          must match the card bit for bit; every kernel's launch count over
          this phase must be > 0; the median time of 5 gate calls per
          (parameters, tier).

The last lines are the card's name and power limit (nvidia-smi), a
{"kernels": [...]} JSON line and {"ok": true, "device": {...}}. Any failure
raises, so the exit code is non-zero and no result line is printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from concrete_tpu_torch import boolean, torus
from concrete_tpu_torch.core import bootstrap as bs
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.ops import _cuda
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
SOURCE = "concrete_tpu_torch/csrc/mxu_kernels.cu"
REPLACES = {"build_tables": "concrete_tpu/core/bootstrap_mxu.py:238",
            "rotdig": "concrete_tpu/core/bootstrap_mxu.py:449",
            "rotdig_recombine": "concrete_tpu/core/bootstrap_mxu.py:599"}
CPU_ROWS = 32


def log(**fields):
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Device ms per call: `reps` calls captured once in a CUDA graph and the
    graph replayed between two CUDA events, so the Python launch path
    (wrapper checks, ctypes) is not counted, only the kernels."""
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


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def kernel_cases(dev):
    """(kernel, label, run the kernel, run its plain version) at the main
    path's shapes: one CMux step's table per preset, the digit kernel at
    B=2048 per preset, the deferred kernel at the TPU128 B=8192 tier."""
    rng = np.random.default_rng(0)

    def u32(shape):
        return torus.from_numpy(
            rng.integers(0, 1 << 32, size=shape, dtype=np.uint32), dev)

    def degrees(n, b):
        return torch.from_numpy(
            rng.integers(0, 2 * n + 1, size=b).astype(np.int32)).to(dev)

    cases = []
    for name, params in PRESETS.items():
        plan = bsx.MxuPlan.from_config(bs.ServerConfig.from_boolean_parameters(params))
        n, ks1, r = plan.polynomial_size, plan.glwe_size, plan.row_blocks
        rings = u32((r, ks1, 2 * n))
        rhs = torch.empty((r * n, ks1 * 4 * n), dtype=torch.int8, device=dev)
        cases.append(("build_tables", f"{name} one step",
                      lambda rings=rings, n=n, rhs=rhs: bsx.build_tables(rings, n, out=rhs),
                      lambda rings=rings, n=n: bsx.build_tables_plain(rings, n)))
        b = 2048
        acc, a_hat = u32((ks1, b, n)), degrees(n, b)
        d8 = torch.empty((b, r * n), dtype=torch.int8, device=dev)
        cases.append(("rotdig", f"{name} B={b} n_sub={plan.n_sub}",
                      lambda p=plan, acc=acc, a=a_hat, d8=d8: bsx.rotdig(p, acc, a, out=d8),
                      lambda p=plan, acc=acc, a=a_hat: bsx.rotdig_plain(p, acc, a)))
    plan = bsx.MxuPlan.from_config(
        bs.ServerConfig.from_boolean_parameters(TPU128_PARAMETERS))
    n, ks1, b = plan.polynomial_size, plan.glwe_size, 8192
    s, acc, a_hat = u32((b, ks1 * 4 * n)), u32((ks1, b, n)), degrees(n, b)
    cases.append(("rotdig_recombine", f"TPU128 B={b}",
                  lambda: bsx.rotdig_recombine(plan, s, acc, a_hat),
                  lambda: bsx.rotdig_recombine_plain(plan, s, acc, a_hat)))
    return cases


def phase_a(dev, card):
    """Every kernel equal to its plain version; returns the headline row
    per kernel (its first case) for the kernels line."""
    rows = {}
    for kernel, label, run, plain in kernel_cases(dev):
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
        log(phase="A", kernel=kernel, shape=label, equal=True, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, card=card)
        row = rows.setdefault(kernel, {"ms": ms, "plain_ms": plain_ms,
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
        t0 = time.perf_counter()
        sks.bsk_mxu, sks.ksk8  # noqa: B018 - evaluation keys onto the card
        prep_s = time.perf_counter() - t0
        warm = sks.warmup(TIERS[name])
        log(phase="B", params=name, keygen_s=keygen_s, key_prep_s=prep_s,
            warmup_s=warm)
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
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sks.and_(ca, cb)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            log(phase="B", params=name, tier=tier, gate="and_",
                ms_per_call=med * 1e3, gates_per_s=tier / med,
                deferred=bsx.auto_defer(bsx.MxuPlan.from_config(sks.cfg), tier),
                card=card)
        del sks
        torch.cuda.empty_cache()
    return cpu_check


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one GPU")
    dev = torch.device("cuda")
    card = card_line()
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    log(phase="build", seconds=build_s, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    log_path = _cuda.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)

    t0 = time.perf_counter()
    rows = phase_a(dev, card)
    log(phase="A", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    bsx.reset_launch_counts()
    cpu_check = phase_b(dev, card)
    launches = bsx.launch_counts()
    log(phase="B", seconds=time.perf_counter() - t0, launches=launches)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    t0 = time.perf_counter()
    sks, ca, cb, want = cpu_check
    got = sks.to("cpu").and_(ca, cb)
    if not torch.equal(got, want):
        raise AssertionError("CPU recomputation differs from the card")
    log(phase="cpu_check", rows=CPU_ROWS, params="TPU128", gate="and_",
        bit_identical=True, seconds=time.perf_counter() - t0)
    log(phase="all", seconds=time.perf_counter() - t_all)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": rows[k]["max_abs_err"],
         "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"]}
        for k in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
