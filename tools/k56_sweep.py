#!/usr/bin/env python3
"""Split K5's and K6's time by phase and try their geometry, on one GPU.

    python3 tools/k56_sweep.py [other_nuss_kernels.cu ...]

Builds copies of concrete_tpu_torch/csrc/nuss_kernels.cu with nvcc (into
concrete_tpu_torch/_build/sweep56/): the kernels as they are; K5 at 128
and 512 threads a block and K6 at 256 (2, 8 and 4 class slots at L = 32:
blocks an SM, registers a thread); held to 2 blocks an SM by
__launch_bounds__; with 2 and 8 rows' limbs loaded at once by a thread
(loads in flight); K5's gather loop rolled and K6's unrolled (unrolled,
the next rows' loads start before this batch's recombine); K6 on unsigned
__int128 in place of the 96-bit pair (at 256 threads: 16-byte values fill
shared memory at 512); and copies that each skip one phase (the gather's
global loads, the in-register transform stages, the fold, the stores).
At chip_smoke.py's K5 / K6 shapes (u32 and u64 at N = 8192 and 16384,
B = 256, and the TFHE_LIB ring, N=1024 L=32 M=32, B = 2048) it times every
build, 20 launches in a CUDA graph replayed between CUDA events, and
checks the whole builds against recombine_inv_plain /
recombine_inv64_plain. One JSON line per (shape,
build) with the card's name and power limit; a phase's cost is the whole
kernel's time less the time of the copy that skips it. Other versions of
the source given as arguments (the parent commit's, say) are built and
timed whole beside it, an A/B comparison inside one run.
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

# build -> (the source text it changes, what replaces it); "whole" builds
# are checked against the plain versions
VARIANTS = {
    "k5_threads128": ("constexpr int kRecThreads = 256;",
                      "constexpr int kRecThreads = 128;"),
    "k5_threads512": ("constexpr int kRecThreads = 256;",
                      "constexpr int kRecThreads = 512;"),
    "k6_threads256": ("constexpr int kRecThreads64 = 512;",
                      "constexpr int kRecThreads64 = 256;"),
    "min2_blocks": ("__launch_bounds__(RecMaxThreads<V, L>::value)",
                    "__launch_bounds__(RecMaxThreads<V, L>::value, 2)"),
    "batch2": ("constexpr int kRecBatch = 4;", "constexpr int kRecBatch = 2;"),
    "batch8": ("constexpr int kRecBatch = 4;", "constexpr int kRecBatch = 8;"),
    # K5's gather loop rolled, K6's unrolled (the next rows' loads issued
    # before this batch's recombine)
    "gather_swapped": [("#pragma unroll\n      for (int i0 = 0; i0 < L; i0 += kBatch) rows(i0);",
                        "#pragma unroll 1\n      for (int i0 = 0; i0 < L; i0 += kBatch) rows(i0);"),
                       ("#pragma unroll 1\n      for (int i0 = 0; i0 < L; i0 += kBatch) rows(i0);\n    }\n  }",
                        "#pragma unroll\n      for (int i0 = 0; i0 < L; i0 += kBatch) rows(i0);\n    }\n  }")],
    # 16-byte values fill shared memory at 512 threads: 256 with them
    "u128": [("using K6Value = U96;", "using K6Value = u128;"),
             ("constexpr int kRecThreads64 = 512;",
              "constexpr int kRecThreads64 = 256;")],
}
SKIPS = {
    "no_gather": ("    const bool valid = pidx < n_polys;",
                  "    const bool valid = false;"),
    "no_transform": ("  inv_stages<V, L, 1>(x, k);\n", ""),
    "no_fold": ("  for (int i = 0; i < L / 2; ++i) {\n    const int t = i + (half",
                "  for (int i = 0; i < 0; ++i) {\n    const int t = i + (half"),
    "no_store": ("  for (int w = tid * step; w < words; w += threads * step) {",
                 "  for (int w = tid * step; w < 0; w += threads * step) {"),
}
ENTRIES = ("ctt_recombine_inv", "ctt_recombine_inv64")


def builds(others=()) -> dict:
    """build name -> shared library, all nvcc runs in parallel; ptxas's
    register report in <name>.log beside each."""
    src = _cuda.SOURCES["nuss_kernels"].read_text()
    out = _cuda.BUILD_DIR / "sweep56"
    out.mkdir(parents=True, exist_ok=True)
    todo = {"whole": src}
    for name, edits in {**VARIANTS, **SKIPS}.items():
        text = src
        for line, new in edits if isinstance(edits, list) else [edits]:
            if line not in text:
                raise SystemExit(f"{name}: the source no longer has {line!r}")
            text = text.replace(line, new)
        todo[name] = text
    for path in others:
        todo[Path(path).stem] = Path(path).read_text()
    procs, libs = [], {}
    for name, text in todo.items():
        cu = out / f"nuss_{name}.cu"
        cu.write_text(text)
        libs[name] = cu.with_suffix(".so")
        procs.append((cu, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for cu, proc in procs:
        output, _ = proc.communicate()
        cu.with_suffix(".log").write_text(output)
        if proc.returncode:
            raise SystemExit(output)
    return libs


def shapes():
    out = []
    for n in (8192, 16384):
        for bits in (32, 64):
            cfg = bs.ServerConfig(lwe_dimension=100, glwe_dimension=1,
                                  polynomial_size=n, pbs_base_log=2,
                                  pbs_level=3, ks_base_log=2, ks_level=5,
                                  bits=bits)
            out.append((f"u{bits} N={n}", bsn.NussPlan.from_config(cfg), 256))
    out.append(("TFHE_LIB ring N=1024", bsn.NussPlan.from_config(
        bs.ServerConfig.from_boolean_parameters(TFHE_LIB_PARAMETERS)), 2048))
    return out


def graph_us(fn, reps: int = 20) -> float:
    """Device us a launch: `reps` launches captured in a CUDA graph and
    replayed between two CUDA events."""
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
        raise SystemExit("k56_sweep: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = {}
    for name, so in builds(sys.argv[1:]).items():
        lib = ctypes.CDLL(str(so))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        libs[name] = lib
    rng = np.random.default_rng(0)
    for label, plan, b in shapes():
        s = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=(plan.two_l, b, plan.glwe_size *
                                       plan.limbs_used * plan.m),
            dtype=np.int32)).to(dev)
        plain = bsn.recombine_inv_plain if plan.bits == 32 else bsn.recombine_inv64_plain
        want = plain(plan, s)
        out = torch.empty_like(want)
        entry = ENTRIES[plan.bits == 64]
        for name, lib in libs.items():
            if name == "u128" and plan.bits == 32:
                continue
            fn = getattr(lib, entry)

            def run(fn=fn):
                err = fn(s.data_ptr(), out.data_ptr(), b, plan.glwe_size,
                         plan.limbs_used, plan.l, plan.m, plan.shift,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            out.zero_()
            run()
            torch.cuda.synchronize()
            equal = None if name in SKIPS else torch.equal(out, want)
            if equal is False:
                raise AssertionError(f"{label} {name} differs")
            print(json.dumps({"shape": label, "build": name, "equal": equal,
                              "us": graph_us(run), "card": card}), flush=True)


if __name__ == "__main__":
    main()
