#!/usr/bin/env python3
"""Time K4 (rotdig64) against other builds of it and split its time by
phase, on one GPU; count the instructions its SASS issues.

    python3 tools/k4_sweep.py [other_mxu_kernels.cu ...]

Builds copies of concrete_tpu_torch/csrc/mxu_kernels.cu with nvcc (into
concrete_tpu_torch/_build/sweep4/): the kernel as it is; every gadget
through the generic instance (no unrolled level loop); at 64 and 256
threads a block (4 and 1 coefficient groups a thread at N = 1024; 2 as it
is); with 1, 2, 8 and 16 rows a block (1: no row's load runs under
another row's digits inside a block); the gather in the unrotated word
order (lanes 32 bytes apart, 4-way bank conflicts: the earlier kernel's
order) and as 16-byte windows (two aligned 16-byte loads of the row's
words and three of the rotated window, a select on the window's parity);
with the loads' L2 prefetch hint at 256 bytes; and copies that each skip
one phase (the cp.async loads, the shared-memory gather, the digit loop,
the stores). Other versions of the source given as arguments (the parent
commit's, say) are built and timed whole beside it, an A/B comparison
inside one run. At chip_smoke.py's four K4 shapes (int4, B = 2048, N =
1024, k+1 = 2: base_log 7 level 3, 10/3, 16/2, 16/3) it times every build,
20 launches in a CUDA graph replayed between CUDA events (profiling.time_ms),
and checks the whole builds against rotdig64_plain. One JSON line per
(shape, build) with the card's name and power limit; a phase's cost is the
whole kernel's time less the time of the copy that skips it.

Then `cuobjdump -sass` of the whole build and of the others: each K4
function's instructions by pipe (sass_counts), written with the SASS to
chiprun_out/k4_sass/, its loops, and the instructions a coefficient issues
at each shape (issued_per_coefficient), to hold beside
profiling.rotdig64_work's fewest.
"""

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from concrete_tpu_torch import torus  # noqa: E402
from concrete_tpu_torch.core import bootstrap_mxu as bsx  # noqa: E402
from concrete_tpu_torch.ops import _cuda  # noqa: E402
from concrete_tpu_torch.profiling import time_ms  # noqa: E402

# the K4 loop that gathers a thread's four words (kept by every build but
# "window", which replaces it)
GATHER = """      for (int q = 0; q < 4; ++q) {
        const uint32_t c = c0 + ((q + rot) & 3);
        const uint32_t t = (c - a) & static_cast<uint32_t>(2 * n - 1);
        const uint64_t v = row[t & static_cast<uint32_t>(n - 1)];
"""
WINDOW = """      const uint32_t s0 = (static_cast<uint32_t>(c0) - a) &
                          static_cast<uint32_t>(n - 1);
      const uint4* quads = reinterpret_cast<const uint4*>(row);
      uint64_t win[6], xs[4];
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        const uint4 p = quads[(((s0 & ~1u) + 2 * h) & (n - 1)) / 2];
        win[2 * h] = p.x | (uint64_t(p.y) << 32);
        win[2 * h + 1] = p.z | (uint64_t(p.w) << 32);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 p = quads[c0 / 2 + h];
        xs[2 * h] = p.x | (uint64_t(p.y) << 32);
        xs[2 * h + 1] = p.z | (uint64_t(p.w) << 32);
      }
      for (int q = 0; q < 4; ++q) {
        const uint32_t c = c0 + q;
        const uint32_t t = (c - a) & static_cast<uint32_t>(2 * n - 1);
        const uint64_t v = (s0 & 1) ? win[q + 1] : win[q];
"""
# build -> [(the source text it changes, what replaces it)]; "whole" builds
# are checked against rotdig64_plain
VARIANTS = {
    "generic": [("  CTT_ROTDIG64(7, 3, 1)\n  CTT_ROTDIG64(10, 3, 2)\n"
                 "  CTT_ROTDIG64(16, 2, 3)\n  CTT_ROTDIG64(16, 3, 3)\n", "")],
    "threads64": [("constexpr int kRd64Threads = 128;",
                   "constexpr int kRd64Threads = 64;")],
    "threads256": [("constexpr int kRd64Threads = 128;",
                    "constexpr int kRd64Threads = 256;")],
    "rows1": [("constexpr int kRd64Rows = 4;", "constexpr int kRd64Rows = 1;")],
    "rows2": [("constexpr int kRd64Rows = 4;", "constexpr int kRd64Rows = 2;")],
    "rows8": [("constexpr int kRd64Rows = 4;", "constexpr int kRd64Rows = 8;")],
    "rows16": [("constexpr int kRd64Rows = 4;", "constexpr int kRd64Rows = 16;")],
    "l2_256": [("cp.async.cg.shared.global [%0], [%1], 16;",
                "cp.async.cg.shared.global.L2::256B [%0], [%1], 16;")],
    "unrotated": [("const int rot = (threadIdx.x >> 2) & 3;",
                   "const int rot = 0;")],
    "window": [("const int rot = (threadIdx.x >> 2) & 3;", "const int rot = 0;"),
               (GATHER, WINDOW),
               ("(v ^ m) - m - row[c] + half;", "(v ^ m) - m - xs[q] + half;")],
}
SKIPS = {
    "no_load": [("      cp_async16(dst + i, src + i);\n", "")],
    "no_gather": [("const uint64_t v = row[t & static_cast<uint32_t>(n - 1)];",
                   "const uint64_t v = t * 0x9E3779B97F4A7C15ull;"),
                  ("(v ^ m) - m - row[c] + half;",
                   "(v ^ m) - m - c * 0x2545F4914F6CDD1Dull + half;")],
    "no_digits": [("digit[q] = gadget_digit(s64[q], bl, false);",
                   "digit[q] = static_cast<int32_t>(s64[q]);"),
                  ("digit[q] = gadget_digit(s32[q], bl, step == level - 1);",
                   "digit[q] = static_cast<int32_t>(s32[q] >> step);")],
    "no_stores": [("          *reinterpret_cast<uint32_t*>(\n              out +",
                   "          if (packed == 0x01020304u)  // next to never\n"
                   "            *reinterpret_cast<uint32_t*>(\n              out +")],
}
SHAPES = ((7, 3), (10, 3), (16, 2), (16, 3))
BATCH = 2048
OUT = ROOT / "chiprun_out" / "k4_sass"
# SASS opcodes by the pipe that runs them (compute capability 9.0; Nsight
# Compute's pipe names): multiplies on the FMA pipe, adds on either pipe,
# logic, shifts, compares, selects and byte permutes on the ALU pipe
FMA_OPS = {"IMAD", "IMUL", "IMADSP"}
ADD_OPS = {"IADD3", "IADD", "LEA", "VIADD"}
ALU_OPS = {"LOP3", "LOP", "SHF", "SEL", "ISETP", "PRMT", "IABS", "IMNMX",
           "FLO", "POPC", "BMSK", "SGXT", "PLOP3", "ICMP"}
MEM_OPS = {"LDS", "STS", "LDG", "STG", "LDGSTS", "LDGDEPBAR", "DEPBAR",
           "LDC", "ULDC", "BAR", "LD", "ST"}


def builds(others=()) -> dict:
    """build name -> shared library, all nvcc runs in parallel; ptxas's
    register report in <name>.log beside each."""
    src = _cuda.SOURCES["mxu_kernels"].read_text()
    out = _cuda.BUILD_DIR / "sweep4"
    out.mkdir(parents=True, exist_ok=True)
    todo = {"whole": src}
    for name, edits in {**VARIANTS, **SKIPS}.items():
        text = src
        for line, new in edits:
            if text.count(line) != 1:
                raise SystemExit(f"{name}: the source has {line!r} "
                                 f"{text.count(line)} times, not once")
            text = text.replace(line, new)
        todo[name] = text
    for path in others:
        todo[Path(path).stem] = Path(path).read_text()
    procs, libs = [], {}
    for name, text in todo.items():
        cu = out / f"mxu_{name}.cu"
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


def k4_functions(so: Path) -> dict[str, list[tuple[int, str, str]]]:
    """cuobjdump -sass of a library: each K4 function (rotdig64_kernel<BL,
    L, NSUB>, or the earlier kernel's rotdig_kernel<unsigned long>) as
    [(address, opcode without modifiers, the whole instruction)]."""
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            name = name if ("rotdig64_kernel" in name
                            or "rotdig_kernelIm" in name) else None
            if name:
                funcs[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                       r"([^;]*);", line)
        if name and ins:
            op = ins.group(3).split(".")[0]
            if op != "NOP":
                funcs[name].append((int(ins.group(1), 16), op,
                                    ins.group(0).strip()))
    return funcs


def pipe_of(op: str) -> str:
    for pipe, ops in (("mul", FMA_OPS), ("add", ADD_OPS), ("alu", ALU_OPS),
                      ("mem", MEM_OPS)):
        if op in ops:
            return pipe
    return "other"


def sass_counts(ins) -> dict[str, int]:
    return dict(Counter(pipe_of(op) for _, op, _ in ins))


def loops(ins) -> list[tuple[int, int]]:
    """(first, last) instruction indices of every backward branch's loop,
    innermost first (the branch-to-self at the end excluded)."""
    index = {addr: i for i, (addr, _, _) in enumerate(ins)}
    found = []
    for i, (addr, op, whole) in enumerate(ins):
        target = re.search(r"BRA\S*\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", whole)
        if op == "BRA" and target:
            to = int(target.group(1), 16)
            if to < addr and to in index:
                found.append((index[to], i))
    return sorted(found, key=lambda r: r[1] - r[0])


def issued_per_coefficient(ins, n: int, level: int, n_sub: int,
                           threads: int, rows: int) -> dict[str, float]:
    """Instructions a thread issues a coefficient, by pipe: each SASS
    instruction once per execution, i.e. times the trip counts of the
    loops around it, over the coefficients of a thread (rows x 4 x groups).
    The loops are told apart by what they hold: the row loop a barrier
    (rows a block); the async or staged row load a global load and a
    shared store or LDGSTS, not a global store (N/2 16-byte pieces over
    the threads); the loops around the digit stores, outermost first, the
    coefficient groups of a thread, then (the earlier kernel's run-time
    loops) the levels and the sub-digit chunks, two a trip (n_sub // 2;
    its odd last chunk follows the loop, counted at every level). Code
    that a forward branch skips is counted as run: an upper bound where
    it is skipped (the earlier kernel's rounding at non_rep = 0, its odd
    chunk at even n_sub)."""
    groups = max(1, n // 4 // threads)
    store_trips = [groups, level, n_sub // 2]
    weight = [1.0] * len(ins)
    store_loops = []
    for lo, hi in loops(ins):
        ops = {op for _, op, _ in ins[lo:hi + 1]}
        if "BAR" in ops:
            trips = rows
        elif "STG" in ops:
            store_loops.append((lo, hi))
            continue
        elif "LDGSTS" in ops or {"LDG", "STS"} <= ops:
            trips = -(-n // 2 // threads)
        else:
            trips = 1
        for i in range(lo, hi + 1):
            weight[i] *= trips
    for k, (lo, hi) in enumerate(sorted(store_loops,
                                        key=lambda r: r[0] - r[1])):
        for i in range(lo, hi + 1):
            weight[i] *= store_trips[k] if k < len(store_trips) else 1
    out = Counter()
    for w, (_, op, _) in zip(weight, ins):
        out[pipe_of(op)] += w / (rows * 4 * groups)
    out["total"] = sum(out.values())
    return dict(out)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k4_sweep: no CUDA device")
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    others = sys.argv[1:]
    libs = {}
    so_paths = builds(others)
    for name, so in so_paths.items():
        lib = ctypes.CDLL(str(so))
        lib.ctt_rotdig64.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
        libs[name] = lib
    rng = np.random.default_rng(0)
    n = chip_smoke.INT4["rlwe"].polynomial_size
    for bl, lv in SHAPES:
        plan = bsx.MxuPlan.from_config(chip_smoke._int4_config(bl, lv))
        ks1 = plan.glwe_size
        acc = torus.from_numpy(rng.integers(0, 1 << 64, size=(ks1, BATCH, n),
                                            dtype=np.uint64), dev)
        a_hat = torch.from_numpy(rng.integers(0, 2 * n + 1, size=BATCH)
                                 .astype(np.int32)).to(dev)
        want = bsx.rotdig64_plain(plan, acc, a_hat)
        out = torch.empty_like(want)
        label = f"int4 B={BATCH} bl={bl} l={lv} n_sub={plan.n_sub}"
        for name, lib in libs.items():
            def run(lib=lib, name=name):
                err = lib.ctt_rotdig64(acc.data_ptr(), a_hat.data_ptr(),
                                       out.data_ptr(), BATCH, ks1, n, bl, lv,
                                       plan.n_sub,
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
                              "us": time_ms(run) * 1e3, "card": card}), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = _cuda.SOURCES["mxu_kernels"].read_text()
    geometry = {"whole": tuple(int(re.search(rf"constexpr int {c} = (\d+);",
                                             src).group(1))
                               for c in ("kRd64Threads", "kRd64Rows"))}
    for name in ["whole", *(Path(p).stem for p in others)]:
        for func, ins in k4_functions(so_paths[name]).items():
            (OUT / f"{name}_{func[:80]}.sass").write_text(
                "\n".join(whole for _, _, whole in ins) + "\n")
            inst = re.search(r"rotdig64_kernelILi(\d+)ELi(\d+)ELi(\d+)E", func)
            per_coef = {}
            for bl, lv in SHAPES:
                n_sub = bsx.MxuPlan.from_config(
                    chip_smoke._int4_config(bl, lv)).n_sub
                if inst and tuple(map(int, inst.groups())) != (bl, lv, n_sub):
                    continue
                # the earlier kernel: one block of N/4 threads a row
                threads, rows = geometry.get(name, (n // 4, 1))
                per_coef[f"bl={bl} l={lv}"] = issued_per_coefficient(
                    ins, n, lv, n_sub, min(threads, n // 4), rows)
            print(json.dumps({"sass": name, "function": func,
                              "static": sass_counts(ins),
                              "loops": [(ins[lo][0], ins[hi][0], hi - lo + 1)
                                        for lo, hi in loops(ins)],
                              "issued_per_coef": per_coef, "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
