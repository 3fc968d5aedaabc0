"""Deployment diagnostics for the port: `python -m concrete_tpu_torch.diagnose`.

A serving process that cannot reach its GPU should fail fast and say why,
not hang or run on the CPU. This module probes each layer with a bounded
timeout and reports where initialisation stops (the port's counterpart of
concrete_tpu/diagnose.py, whose probe is for remote TPUs).

Checks, in order:
1. versions: this package, python, numpy, torch, CUDA (torch.version.cuda),
   `nvcc --version` and the card (`nvidia-smi --query-gpu=name,power.limit`);
2. device init (torch.cuda.init and a tensor on the card) under a timeout,
   in a thread;
3. the kernels: every .cu of csrc/ built and loaded (ops/_cuda.load_all),
   then one K1 launch (bootstrap_mxu.build_tables) held against its plain
   version, pulled back to the host.

Exit code 0 = the compute path is live; 1 = no CUDA device, or init, build
or the kernel check failed.

``python -m concrete_tpu_torch.diagnose wait [max_wait_s]`` polls instead
of reporting once: a probe in a fresh subprocess every 2 minutes until the
GPU answers or the budget runs out. A probe that finds no CUDA device (the
CPU build of torch, or no card visible) is not live unless allow_cpu.

Example:
    >>> _bounded(lambda: 7, 5.0)[0]
    'ok'
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time


def _bounded(fn, timeout_s: float):
    """Run fn() in a daemon thread; return (status, value_or_error).

    >>> _bounded(lambda: 1 / 0, 5.0)
    ('ERROR', 'ZeroDivisionError: division by zero')
    >>> import time
    >>> _bounded(lambda: time.sleep(60), 0.05)[0]
    'BLOCKED'
    """
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except Exception as e:  # noqa: BLE001 - diagnostic surface
            out["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    th.start()
    th.join(timeout_s)
    dt = time.perf_counter() - t0
    if th.is_alive():
        return "BLOCKED", f"still blocked after {timeout_s:.0f}s"
    if "error" in out:
        return "ERROR", out["error"]
    return "ok", (out["value"], dt)


def _tool_line(cmd: list[str]) -> str:
    """The last line a tool prints, or why it could not run."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    lines = (r.stdout or r.stderr).strip().splitlines()
    return lines[-1] if lines else f"no output (rc {r.returncode})"


def _nvcc() -> str:
    from .ops import _cuda

    try:
        return _cuda._nvcc()
    except RuntimeError:    # no CUDA_HOME: try the one on PATH
        return "nvcc"


def _device_init():
    import torch

    torch.cuda.init()
    x = torch.ones(4, device="cuda")
    return float(x.sum().item()), torch.cuda.get_device_name(0)


def _kernel_check():
    """Build and load every kernel library, then one K1 launch against its
    plain version, compared on the host."""
    import numpy as np
    import torch

    from .core import bootstrap_mxu as bsx
    from .ops import _cuda

    _cuda.load_all()
    rng = np.random.default_rng(0)
    rings = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=(4, 2, 2 * 64), dtype=np.int64).astype(
            np.int32))
    want = bsx.build_tables_plain(rings, 64)
    got = bsx.build_tables(rings.cuda(), 64).cpu()
    if not torch.equal(got, want):
        raise AssertionError("K1 build_tables differs from its plain version")
    return tuple(got.shape)


def main(timeout_s: float = 120.0) -> int:
    import numpy as np
    import torch

    import concrete_tpu_torch

    print(f"concrete_tpu_torch {concrete_tpu_torch.__version__}  "
          f"python {sys.version.split()[0]}  numpy {np.__version__}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"nvcc: {_tool_line([_nvcc(), '--version'])}")
    print("card: " + _tool_line(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"]))
    if not torch.cuda.is_available():
        print("device init: no CUDA device (torch.cuda.is_available() is "
              "False); the port's entry points need device=\"cpu\" here")
        return 1
    status, res = _bounded(_device_init, timeout_s)
    if status != "ok":
        print(f"device init: {status} - {res}")
        return 1
    (val, name), dt = res
    print(f"device init: ok ({dt:.1f}s) - {name}, {torch.cuda.device_count()}"
          f" device(s), round trip {val}")
    status, res = _bounded(_kernel_check, max(timeout_s, 600.0))
    if status != "ok":
        print(f"kernels: {status} - {res}")
        return 1
    shape, dt = res
    print(f"kernels: ok ({dt:.1f}s) - built and loaded, K1 build_tables "
          f"{shape} equal to its plain version")
    return 0


# a fresh process's verdict: LIVE (a tensor on the card and back), or NO_CUDA
PROBE_SRC = (
    "import torch;"
    "ok = torch.cuda.is_available();"
    "v = float(torch.ones(256, device='cuda').sum().cpu()) if ok else 0.0;"
    "name = torch.cuda.get_device_name(0) if ok else 'cpu';"
    "print('LIVE' if ok else 'NO_CUDA', v, name)"
)


def wait(max_wait_s: float = 3600.0, probe_timeout_s: float = 120.0,
         interval_s: float = 120.0, allow_cpu: bool = False) -> int:
    """Poll until the GPU answers; return 0 the moment it does.

    Every probe runs in a fresh subprocess (a CUDA context that failed or
    hung during init is not retried within one process). A probe that finds
    no CUDA device answers NO_CUDA: that is not the GPU answering, so the
    wait goes on, unless ``allow_cpu`` (for rigs where the CPU is the
    intended device)."""
    ok_tags = ("LIVE", "NO_CUDA") if allow_cpu else ("LIVE",)
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        try:
            r = subprocess.run(
                [sys.executable, "-c", PROBE_SRC], capture_output=True,
                text=True, timeout=probe_timeout_s)
            last = (r.stdout.strip().splitlines() or [""])[-1]
            first_word = last.split(" ")[0]
            if r.returncode == 0 and first_word in ok_tags:
                print(f"device LIVE (attempt {attempt}): {last}")
                return 0
            if r.returncode == 0 and first_word == "NO_CUDA":
                print(f"attempt {attempt}: no CUDA device - still down",
                      flush=True)
            else:
                tail = (r.stderr or r.stdout).strip().splitlines()
                print(f"attempt {attempt}: probe failed"
                      f" ({tail[-1][:120] if tail else 'no output'})",
                      flush=True)
        except subprocess.TimeoutExpired:
            print(f"attempt {attempt}: still blocked after"
                  f" {probe_timeout_s:.0f}s", flush=True)
        if time.monotonic() + interval_s > deadline:
            print(f"device still unavailable after {max_wait_s:.0f}s")
            return 1
        time.sleep(interval_s)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "wait":
        mw = float(sys.argv[2]) if len(sys.argv) > 2 else 3600.0
        sys.exit(wait(mw))
    t = float(sys.argv[1]) if len(sys.argv) > 1 else 120.0
    sys.exit(main(t))
