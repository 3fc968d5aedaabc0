"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` (``mxu_kernels.cu``: K1-K4, recombine_acc and
window_step; ``nuss_kernels.cu``: K5-K7; ``fused_kernels.cu``: K8;
``ntt_kernels.cu``: K9) is compiled by ``nvcc`` for Hopper (sm_90a) into
its own shared library with a plain C interface, loaded with ctypes. The
builds run at
first use, all sources at once (one ``nvcc`` each, in parallel), in
``concrete_tpu_torch/_build/``, and again whenever a source or the flags
change (a library's file name carries their hash). Nothing here runs at
import time: importing the port needs no CUDA.

Each C entry point launches one kernel on the stream it is given and
returns a CUDA error code; :func:`launch` raises when that is not 0.

    >>> sorted(SOURCES), len(_SIGNATURES)
    (['fused_kernels', 'mxu_kernels', 'ntt_kernels', 'nuss_kernels'], 14)
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("mxu_kernels", "nuss_kernels", "fused_kernels",
                        "ntt_kernels")}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# entry point -> (library, pointer arguments, int arguments); the stream
# comes last
_SIGNATURES = {
    "ctt_build_tables": ("mxu_kernels", 2, 7),
    "ctt_rotdig": ("mxu_kernels", 3, 6),
    "ctt_rotdig64": ("mxu_kernels", 3, 6),
    "ctt_rotdig_recombine": ("mxu_kernels", 5, 8),
    "ctt_recombine_acc": ("mxu_kernels", 3, 5),
    "ctt_recombine_acc64": ("mxu_kernels", 3, 5),
    "ctt_window_step": ("mxu_kernels", 3, 7),
    "ctt_recombine_inv": ("nuss_kernels", 2, 6),
    "ctt_recombine_inv64": ("nuss_kernels", 2, 6),
    "ctt_rotdig_fwd_nuss": ("nuss_kernels", 3, 7),
    "ctt_rotdig_fwd_nuss64": ("nuss_kernels", 3, 7),
    "ctt_fused_cmux": ("fused_kernels", 4, 6),
    "ctt_ntt_cmux": ("ntt_kernels", 6, 8),
    "ctt_ntt_cmux_warp": ("ntt_kernels", 6, 6),
}


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: `device` when given, else the GPU.
    There is no silent fallback: without CUDA, a call that names no device
    raises, and the CPU is used only when asked for (device="cpu").

    >>> resolve_device("cpu")
    device(type='cpu')
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build_log(name: str) -> Path:
    """nvcc's output for one source (ptxas's register report)."""
    return BUILD_DIR / f"{name}.build.log"


def build_all():
    """Compile every source that has no library yet, one nvcc each, all
    started together; raise if any fails."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_name(f"{_lib_path(name).name}."
                                        f"{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        build_log(name).write_text(output)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on "
                          f"{SOURCES[name]}:\n{output}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The kernel library built from csrc/<name>.cu (built first if needed)."""
    if not _lib_path(name).exists():
        build_all()
    lib = ctypes.CDLL(str(_lib_path(name)))
    for entry, (lib_name, n_ptr, n_int) in _SIGNATURES.items():
        if lib_name == name:
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.ctt_error_string.argtypes = [ctypes.c_int]
    lib.ctt_error_string.restype = ctypes.c_char_p
    return lib


def load_all():
    """Build (in parallel) and load every kernel library."""
    build_all()
    for name in SOURCES:
        library(name)


# every count that the accounting of captured graphs reads and adds to
# (ops/graphs.py), each mapped to the names of its total and of its {key:
# count}: the kernel wrappers given a counter ("launches", "shapes") and
# the plain counters of graphs.Counter ("total", "by_key")
COUNTED: dict = {}


def counter(kernel):
    """Give a kernel wrapper its launch counts: `launches`, the total, and
    `shapes`, {shape key: launches}, both zero. Returns the wrapper."""
    kernel.launches = 0
    kernel.shapes = {}
    COUNTED[kernel] = ("launches", "shapes")
    return kernel


def count_launch(kernel, **shape):
    """Count one launch of `kernel`'s CUDA kernel, in total and under its
    shape key ("B=256 L=32 ...", the fields in the order given).

    >>> def k(): pass
    >>> k = counter(k)
    >>> count_launch(k, B=2, N=8); count_launch(k, B=2, N=8)
    >>> k.launches, k.shapes
    (2, {'B=2 N=8': 2})
    """
    kernel.launches += 1
    key = " ".join(f"{f}={v}" for f, v in shape.items())
    kernel.shapes[key] = kernel.shapes.get(key, 0) + 1


def launch(name: str, *args):
    """Launch entry point `name` on the current stream of the first tensor's
    device: tensors pass as device pointers, the rest as C ints."""
    lib_name, n_ptr, n_int = _SIGNATURES[name]
    tensors, ints = args[:n_ptr], args[n_ptr:]
    if len(ints) != n_int or not all(isinstance(t, torch.Tensor)
                                     for t in tensors):
        raise TypeError(f"{name}: expected {n_ptr} tensors and {n_int} ints")
    lib = library(lib_name)
    device = tensors[0].device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(name, *args)
    err = getattr(lib, name)(*[t.data_ptr() for t in tensors],
                             *[int(i) for i in ints],
                             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.ctt_error_string(err).decode()}")
