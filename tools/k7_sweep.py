#!/usr/bin/env python3
"""Split K7's time by phase and try its block size, on one GPU.

    python3 tools/k7_sweep.py [other_nuss_kernels.cu ...]

Builds copies of concrete_tpu_torch/csrc/nuss_kernels.cu with nvcc (into
concrete_tpu_torch/_build/sweep/): the kernel as it is, at 128 and 512
threads a block, and copies that each skip one phase of K7 (the coalesced
gather and rounding, the digit steps, the transform, the sub-digit split
into shared memory, the stores to d8; all but the gather), one with a
straight-line unit loop, one held to 3 blocks an SM. At chip_smoke.py's
K7 shapes (u32 N=8192 base_log 2 and 7, u64 N=8192 base_log 7, all at B=256, and the
TFHE_LIB ring, N=1024 L=32, at B=2048) it times every build, 20 launches
in a CUDA graph replayed between CUDA events, and checks the whole builds
against rotdig_fwd_nuss_plain. One JSON line per (shape, build); a phase's
cost is the whole kernel's time less the time of the copy that skips it.
Other versions of the source given as arguments are built and timed whole
beside it (an A/B comparison inside one run).
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from concrete_tpu_torch.core import bootstrap as bs  # noqa: E402
from concrete_tpu_torch.core import bootstrap_nuss as bsn  # noqa: E402
from concrete_tpu_torch.ops import _cuda  # noqa: E402
from concrete_tpu_torch.params import TFHE_LIB_PARAMETERS  # noqa: E402

# phase -> the source text that starts it, and what replaces it
SKIPS = {
    "no_gather": ("  for (int q0 = 0; q0 < per; q0 += 8) {",
                  "  for (int q0 = 0; q0 < 0; q0 += 8) {"),
    "no_digits": ("        for (int i = 0; i < L; ++i) {\n          S* sp",
                  "        for (int i = 0; i < 0; ++i) {\n          S* sp"),
    "no_transform": ("        dif_stages<L, 1>(x, k);", ""),
    "no_split": ("        for (int jj = 0; jj < n_sub; ++jj) {  // jj = 0: least",
                 "        for (int jj = 0; jj < 0; ++jj) {  // jj = 0: least"),
    "no_store": ("      for (int w = threadIdx.x; w < total; w += blockDim.x) {",
                 "      for (int w = threadIdx.x; w < 0; w += blockDim.x) {"),
    "only_gather": ("  for (int step = 0; step < level; ++step) {",
                    "  for (int step = 0; step < 0; ++step) {"),
    # the block layout of every shape here has one unit a lane group
    "one_unit": ("      for (int it = 0; it < units_per_group; ++it) {",
                 "      {\n        const int it = 0;"),
    "min3_blocks": ("__global__ void __launch_bounds__(kK7Threads) rotdig_fwd_nuss_kernel(",
                    "__global__ void __launch_bounds__(kK7Threads, 3) rotdig_fwd_nuss_kernel("),
}
THREADS_LINE = "constexpr int kK7Threads = 256;"


def builds(others=()) -> dict:
    """(threads, variant) -> shared library, all nvcc runs in parallel."""
    src = _cuda.SOURCES["nuss_kernels"].read_text()
    if THREADS_LINE not in src:
        raise SystemExit(f"the source no longer has {THREADS_LINE!r}")
    out = _cuda.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    todo = {(256, "whole"): src}
    for threads in (128, 512):
        todo[(threads, "whole")] = src.replace(
            THREADS_LINE, f"constexpr int kK7Threads = {threads};")
    for name, (line, skip) in SKIPS.items():
        if line not in src:
            raise SystemExit(f"{name}: the source no longer has {line!r}")
        todo[(256, name)] = src.replace(line, skip)
    for path in others:
        todo[(256, Path(path).stem)] = Path(path).read_text()
    procs, libs = [], {}
    for (threads, name), text in todo.items():
        cu = out / f"nuss_{threads}_{name}.cu"
        cu.write_text(text)
        libs[(threads, name)] = cu.with_suffix(".so")
        procs.append((cu, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for cu, proc in procs:
        output, _ = proc.communicate()
        cu.with_suffix(".log").write_text(output)  # ptxas's register report
        if proc.returncode:
            raise SystemExit(output)
    return libs


def shapes():
    engine = [bs.ServerConfig(lwe_dimension=100, glwe_dimension=1,
                              polynomial_size=8192, pbs_base_log=bl,
                              pbs_level=3, ks_base_log=2, ks_level=5, bits=bits)
              for bits, bl in ((32, 2), (32, 7), (64, 7))]
    out = [(f"u{c.bits} N=8192 bl={c.pbs_base_log}", bsn.NussPlan.from_config(c), 256)
           for c in engine]
    out.append(("TFHE_LIB ring N=1024", bsn.NussPlan.from_config(
        bs.ServerConfig.from_boolean_parameters(TFHE_LIB_PARAMETERS)), 2048))
    return out


def graph_us(fn, reps: int = 20) -> float:
    """Device us a launch: `reps` launches captured in a CUDA graph and
    replayed between two CUDA events, so the host's launch path (ctypes,
    the launcher's set-up) is not counted."""
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
    return start.elapsed_time(end) / reps * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k7_sweep: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fns = {}
    for key, so in builds(sys.argv[1:]).items():
        lib = ctypes.CDLL(str(so))
        for entry in ("ctt_rotdig_fwd_nuss", "ctt_rotdig_fwd_nuss64"):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fns[key] = lib
    rng = np.random.default_rng(0)
    for label, plan, b in shapes():
        n, ks1 = plan.polynomial_size, plan.glwe_size
        shape = (ks1, b, plan.l, plan.m)
        if plan.bits == 32:
            acc = torch.from_numpy(rng.integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32).view(np.int32))
        else:
            acc = torch.from_numpy(rng.integers(0, 1 << 64, size=shape,
                                                dtype=np.uint64).view(np.int64))
        acc = acc.to(dev)
        a_hat = torch.from_numpy(
            rng.integers(0, 2 * n + 1, size=b).astype(np.int32)).to(dev)
        want = bsn.rotdig_fwd_nuss_plain(plan, acc, a_hat)
        out = torch.empty_like(want)
        entry = "ctt_rotdig_fwd_nuss" if plan.bits == 32 else "ctt_rotdig_fwd_nuss64"
        for (threads, name), lib in fns.items():
            fn = getattr(lib, entry)

            def run(fn=fn):
                err = fn(acc.data_ptr(), a_hat.data_ptr(), out.data_ptr(), b,
                         ks1, plan.l, plan.m, plan.base_log, plan.level,
                         plan.n_sub, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            run()
            torch.cuda.synchronize()
            whole = name == "whole" or name not in SKIPS
            equal = torch.equal(out, want) if whole else None
            if equal is False:
                raise AssertionError(f"{label} {threads} differs")
            print(json.dumps({
                "shape": label, "threads": threads, "build": name,
                "equal": equal, "us": graph_us(run), "card": card}), flush=True)


if __name__ == "__main__":
    main()
