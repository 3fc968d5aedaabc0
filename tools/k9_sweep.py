#!/usr/bin/env python3
"""Sweep K9's block geometry and split its time by phase, on one GPU.

    python3 tools/k9_sweep.py

Builds copies of concrete_tpu_torch/csrc/ntt_kernels.cu with nvcc (into
concrete_tpu_torch/_build/sweep/): the kernel as it is at 256 and 512
threads a block, and four copies at 256 threads that each skip one phase
(the MAC, the forward transforms, the inverse transforms, the digits).
At chip_smoke.py's four K9 shapes (TPU128, DEFAULT, TFHE_LIB at B=2048 and
u32 N=8192 at B=256) it times every build at 1-4 rows a block (the
phase-skipping copies at bootstrap_ntt.block_geometry's rows), 20 launches
between CUDA events after 3 warm-up launches, and checks the whole builds
against ntt_cmux_plain. One JSON line per (shape, build, rows); a phase's
cost is the whole kernel's time less the time of the copy that skips it.
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

from concrete_tpu_torch import torus  # noqa: E402
from concrete_tpu_torch.core import bootstrap as bs  # noqa: E402
from concrete_tpu_torch.core import bootstrap_ntt as bsntt  # noqa: E402
from concrete_tpu_torch.ops import _cuda  # noqa: E402
from concrete_tpu_torch.params import (  # noqa: E402
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)

# phase -> the source line that starts it, and what replaces it
SKIPS = {
    "no_mac": ("    for (int c = threadIdx.x; c < n; c += blockDim.x) {\n"
               "      const int pc = pad(c);",
               "    for (int c = threadIdx.x; c < 0; c += blockDim.x) {\n"
               "      const int pc = pad(c);"),
    "no_forward": ("    ntts<false>(dig,", "    if (n < 0) ntts<false>(dig,"),
    "no_inverse": ("  ntts<true>(spec,", "  if (n < 0) ntts<true>(spec,"),
    "no_digits": ("    for (int ri = 0; ri < nrows * ks1; ++ri) {",
                  "    for (int ri = 0; ri < 0; ++ri) {"),
}
THREADS_LINE = "constexpr int kThreads = 256;"


def builds() -> dict:
    """(threads, variant) -> shared library, all nvcc runs in parallel."""
    src = _cuda.SOURCES["ntt_kernels"].read_text()
    out = _cuda.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    todo = {(256, "whole"): src,
            (512, "whole"): src.replace(THREADS_LINE,
                                        "constexpr int kThreads = 512;")}
    for name, (line, skip) in SKIPS.items():
        if line not in src:
            raise SystemExit(f"{name}: the source no longer has {line!r}")
        todo[(256, name)] = src.replace(line, skip)
    procs, libs = [], {}
    for (threads, name), text in todo.items():
        cu = out / f"ntt_{threads}_{name}.cu"
        cu.write_text(text)
        libs[(threads, name)] = cu.with_suffix(".so")
        procs.append(subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for proc in procs:
        output, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(output)
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k9_sweep: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fns = {}
    for key, so in builds().items():
        fn = ctypes.CDLL(str(so)).ctt_ntt_cmux
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fns[key] = fn
    rng = np.random.default_rng(0)
    shapes = [(name, bs.ServerConfig.from_boolean_parameters(p), 2048)
              for name, p in (("TPU128", TPU128_PARAMETERS),
                              ("DEFAULT", DEFAULT_PARAMETERS),
                              ("TFHE_LIB", TFHE_LIB_PARAMETERS))]
    shapes.append(("u32 N=8192", bs.ServerConfig(
        lwe_dimension=100, glwe_dimension=1, polynomial_size=8192,
        pbs_base_log=2, pbs_level=3, ks_base_log=2, ks_level=5), 256))
    for label, cfg, b in shapes:
        n, ks1, lv = cfg.polynomial_size, cfg.glwe_size, cfg.pbs_level
        acc = torus.from_numpy(
            rng.integers(0, 1 << 32, size=(ks1, b, n), dtype=np.uint32), dev)
        a_hat = torch.from_numpy(
            rng.integers(0, 2 * n + 1, size=b).astype(np.int32)).to(dev)
        ggsw = torch.from_numpy(np.stack([
            rng.integers(0, p, size=(lv, ks1, ks1, n), dtype=np.uint32)
            for p in cfg.primes]).view(np.int32)).to(dev)
        tables, consts = bsntt._device_tables(n, cfg.primes, dev)
        want = bsntt.ntt_cmux_plain(cfg, acc, a_hat, ggsw)
        out = torch.empty_like(acc)
        cols, group, rows0 = bsntt.block_geometry(ks1, n, lv, b)
        for (threads, name), fn in fns.items():
            all_rows = group == 2 * lv * ks1 and name == "whole"
            for rows in ((1, 2, 3, 4) if all_rows else (rows0,)):
                if rows * (2 * cols + group) * (n + n // 8) * 4 > 232448 - 32:
                    continue

                def run(fn=fn, rows=rows):
                    err = fn(acc.data_ptr(), a_hat.data_ptr(), ggsw.data_ptr(),
                             tables.data_ptr(), consts.data_ptr(), out.data_ptr(),
                             b, ks1, n, lv, cfg.pbs_base_log, cols, group, rows,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")

                run()
                torch.cuda.synchronize()
                equal = torch.equal(out, want) if name == "whole" else None
                if equal is False:
                    raise AssertionError(f"{label} {threads} rows {rows} differs")
                for _ in range(3):
                    run()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run()
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({
                    "shape": label, "threads": threads, "build": name,
                    "cols": cols, "group": group, "rows": rows,
                    "default_rows": rows0, "equal": equal,
                    "us": start.elapsed_time(end) / 20 * 1e3, "card": card}),
                    flush=True)


if __name__ == "__main__":
    main()
