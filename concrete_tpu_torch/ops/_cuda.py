"""Build, load and launch the port's hand-written CUDA kernels.

``csrc/mxu_kernels.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes. The build runs
at first use, in ``concrete_tpu_torch/_build/``, and again whenever the
source or the flags change (the library's file name carries their hash).
Nothing here runs at import time: importing the port needs no CUDA.

Each C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.

    >>> SOURCE.relative_to(_PKG).as_posix(), sorted(_SIGNATURES)
    ('csrc/mxu_kernels.cu', ['ctt_build_tables', 'ctt_rotdig', 'ctt_rotdig64', 'ctt_rotdig_recombine'])
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
SOURCE = _PKG / "csrc" / "mxu_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# entry point -> (pointer arguments, int arguments); the stream comes last
_SIGNATURES = {
    "ctt_build_tables": (2, 6),
    "ctt_rotdig": (3, 6),
    "ctt_rotdig64": (3, 6),
    "ctt_rotdig_recombine": (5, 8),
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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built first if this source has no build yet."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"mxu_kernels_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, check=False)
        (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (n_ptr, n_int) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.ctt_error_string.argtypes = [ctypes.c_int]
    lib.ctt_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args):
    """Launch entry point `name` on the current stream of the first tensor's
    device: tensors pass as device pointers, the rest as C ints."""
    n_ptr, n_int = _SIGNATURES[name]
    tensors, ints = args[:n_ptr], args[n_ptr:]
    if len(ints) != n_int or not all(isinstance(t, torch.Tensor)
                                     for t in tensors):
        raise TypeError(f"{name}: expected {n_ptr} tensors and {n_int} ints")
    lib = library()
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
