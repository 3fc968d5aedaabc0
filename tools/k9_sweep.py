#!/usr/bin/env python3
"""Time K9's two paths, sweep their block geometry and split their time by
phase, on one GPU.

    python3 tools/k9_sweep.py [--out DIR] [--paths block,warp] [other.cu ...]

Builds copies of concrete_tpu_torch/csrc/ntt_kernels.cu, and of each other
source given (an older commit's, for an A/B inside one call), with nvcc into
concrete_tpu_torch/_build/sweep/: the source as it is, the block path at 512
threads a block, and copies that each skip one phase of one path (the
digits, the forward transforms, the MAC, the inverse transforms). At
TPU128, DEFAULT and TFHE_LIB with B = 16, 256 and 2048, and u32 N=8192 at
B=256, it times each path a source has (the warp path at bootstrap_ntt.
WARP_N only): the whole build at every geometry that fits (block path: 1-4
rows a block; warp path: both primes a pass or one), the
phase-skipping copies at the geometry the wrapper picks; 20 launches
between CUDA events after 3 warm-up launches. Every whole build is checked
against ntt_cmux_plain. One JSON line per timing, then one summary line per
(source, shape, batch, path): the time at the wrapper's geometry, its bound
(profiling.external_product_roofline) and each phase's cost, the whole
kernel's time less the time of the copy that skips it. With --out, ptxas's
report of each source's whole build goes to DIR/k9_ptxas_<source>.txt.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from concrete_tpu_torch import profiling, torus  # noqa: E402
from concrete_tpu_torch.core import bootstrap as bs  # noqa: E402
from concrete_tpu_torch.core import bootstrap_ntt as bsntt  # noqa: E402
from concrete_tpu_torch.ops import _cuda  # noqa: E402
from concrete_tpu_torch.params import (  # noqa: E402
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)

# path -> phase -> [(a source line that does it, what replaces it)]
SKIPS = {
    "block": {
        "no_digits": [("    for (int ri = 0; ri < nrows * ks1; ++ri) {",
                       "    for (int ri = 0; ri < 0; ++ri) {")],
        "no_forward": [("    ntts<false>(dig,", "    if (n < 0) ntts<false>(dig,")],
        "no_mac": [("    for (int c = threadIdx.x; c < n; c += blockDim.x) {\n"
                    "      const int pc = pad(c);",
                    "    for (int c = threadIdx.x; c < 0; c += blockDim.x) {\n"
                    "      const int pc = pad(c);")],
        "no_inverse": [("  ntts<true>(spec,", "  if (n < 0) ntts<true>(spec,")],
    },
    "warp": {
        "no_digits": [
            ("      warp_digits_start<T>(state, acc + row, a, non_rep, lane);",
             "      for (int t = 0; t < T; ++t) state[t] = lane + t;"),
            ("        warp_digits_level<T>(v, state, base_log, twist, lane, p, np);",
             "        for (int t = 0; t < T; ++t) v[t] = state[t] + lev;")],
        "no_forward": [("        warp_forward<T>(v, slot, tw, lane, p, np);",
                        "        store_b<T>(slot, v, lane);")],
        "no_mac": [("      warp_mac<T>(v, dig, g, terms, ks1 * n, lane, p, np);",
                    "      for (int t = 0; t < T; ++t) v[t] = lane + t + pl;")],
        "no_inverse": [("      warp_inverse<T>(v, scr, tw, lane, p, np);", "")],
    },
}
THREADS_LINE = "constexpr int kThreads = 256;"
WARP_MARK = "ntt_cmux_warp_kernel"
BATCHES = (16, 256, 2048)


def variants(src: str) -> dict:
    """build name -> source text: whole, block512, <path>.<phase>."""
    todo = {"whole": src,
            "block512": src.replace(THREADS_LINE, "constexpr int kThreads = 512;")}
    for path, phases in SKIPS.items():
        if path == "warp" and WARP_MARK not in src:
            continue
        for phase, edits in phases.items():
            text = src
            for line, skip in edits:
                if line not in text:
                    raise SystemExit(f"{path} {phase}: the source no longer "
                                     f"has {line!r}")
                text = text.replace(line, skip)
            todo[f"{path}.{phase}"] = text
    return todo


def build(sources: dict, out_dir) -> dict:
    """(source label, build name) -> ctypes library, all nvcc runs at once."""
    work = _cuda.BUILD_DIR / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        for name, text in variants(src).items():
            cu = work / f"{label}_{name}.cu"
            cu.write_text(text)
            procs[(label, name)] = (cu.with_suffix(".so"), subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (label, name), (so, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(output)
        if out_dir and name == "whole":
            (out_dir / f"k9_ptxas_{label}.txt").write_text(output)
        lib = ctypes.CDLL(str(so))
        lib.ctt_ntt_cmux.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
        if hasattr(lib, "ctt_ntt_cmux_warp"):
            lib.ctt_ntt_cmux_warp.argtypes = ([ctypes.c_void_p] * 6
                                              + [ctypes.c_int] * 6
                                              + [ctypes.c_void_p])
        libs[(label, name)] = lib
    return libs


def geometries(path: str, ks1: int, n: int, lv: int, b: int) -> list:
    """Every geometry of `path` that fits, the wrapper's first."""
    if path == "block":
        cols, group, rows0 = bsntt.block_geometry(ks1, n, lv, b)
        out = [(cols, group, rows0)]
        if group == 2 * lv * ks1:
            out += [(cols, group, r) for r in range(1, bsntt.ROWS_MAX + 1)
                    if r != rows0 and r <= b
                    and r * (2 * cols + group) * (n + n // 8) * 4 <= 232448 - 32]
        return out
    first = bsntt.warp_geometry(ks1, n, lv)
    return [first] + ([(1,)] if first != (1,) else [])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("others", nargs="*", help="other ntt_kernels.cu sources")
    ap.add_argument("--out", type=Path, help="directory for ptxas reports")
    ap.add_argument("--paths", default="block,warp",
                    help="the paths to time, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k9_sweep: no CUDA device")
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sources = {"this": _cuda.SOURCES["ntt_kernels"].read_text()}
    for other in args.others:
        sources[Path(other).stem] = Path(other).read_text()
    libs = build(sources, args.out)
    rng = np.random.default_rng(0)
    shapes = [(name, bs.ServerConfig.from_boolean_parameters(p), b)
              for name, p in (("TPU128", TPU128_PARAMETERS),
                              ("DEFAULT", DEFAULT_PARAMETERS),
                              ("TFHE_LIB", TFHE_LIB_PARAMETERS))
              for b in BATCHES]
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
        bound_us = profiling.external_product_roofline(
            cfg, b).bound_seconds() * 1e6
        ptrs = [t.data_ptr() for t in (acc, a_hat, ggsw, tables, consts, out)]
        for src in sources:
            for path in args.paths.split(","):
                if path == "warp" and (n not in bsntt.WARP_N
                                       or (src, "warp.no_mac") not in libs):
                    continue
                geos = geometries(path, ks1, n, lv, b)
                builds = ["whole"] + (["block512"] if path == "block" else [])
                builds += [k for s, k in libs if s == src
                           and k.startswith(path + ".")]
                times = {}
                for name in builds:
                    lib = libs[(src, name)]
                    for geo in (geos if name in ("whole", "block512")
                                else geos[:1]):
                        fn = (lib.ctt_ntt_cmux if path == "block"
                              else lib.ctt_ntt_cmux_warp)

                        def run(fn=fn, geo=geo):
                            err = fn(*ptrs, b, ks1, n, lv, cfg.pbs_base_log,
                                     *geo,
                                     torch.cuda.current_stream().cuda_stream)
                            if err:
                                raise RuntimeError(f"CUDA error {err}")

                        run()
                        torch.cuda.synchronize()
                        equal = (torch.equal(out, want)
                                 if name in ("whole", "block512") else None)
                        if equal is False:
                            raise AssertionError(
                                f"{src} {label} B={b} {path} {name} {geo} "
                                "differs")
                        for _ in range(3):
                            run()
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(20):
                            run()
                        end.record()
                        torch.cuda.synchronize()
                        us = start.elapsed_time(end) / 20 * 1e3
                        times[(name, geo)] = us
                        print(json.dumps({
                            "source": src, "shape": label, "batch": b,
                            "path": path, "build": name, "geometry": geo,
                            "default": geo == geos[0], "equal": equal,
                            "us": us, "card": card}), flush=True)
                whole = times[("whole", geos[0])]
                best = min((us, geo) for (name, geo), us in times.items()
                           if name == "whole")
                print(json.dumps({
                    "summary": True, "source": src, "shape": label,
                    "batch": b, "path": path, "geometry": geos[0],
                    "us": whole, "bound_us": bound_us,
                    "share": bound_us / whole,
                    "best": {"us": best[0], "geometry": best[1]},
                    "phases_us": {name.split(".")[1][3:]: whole - us
                                  for (name, geo), us in times.items()
                                  if "." in name},
                    "card": card}), flush=True)


if __name__ == "__main__":
    main()
