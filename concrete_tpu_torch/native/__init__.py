"""Native (C++) host code of the port: bulk AES-128-CTR for the CSPRNG.

``aes_ctr.cpp`` encrypts little-endian counter blocks with AES-NI where the
CPU has it (a portable table-based AES otherwise), bit for bit the numpy
AES of :mod:`concrete_tpu_torch.csprng.aes`. It is compiled with g++ at
first use into ``concrete_tpu_torch/_build/`` (a file name carrying the hash
of the source and the flags, so an edit rebuilds) and loaded through ctypes.
The build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library.

There is no silent fallback: :func:`load_aes` raises when the build or the
load fails, and the key, mask and noise streams never run on the numpy AES
unless a caller asks for it by name.

    >>> lib = load_aes()
    >>> lib.ctt_aes128_has_hw() in (0, 1)
    True
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "aes_ctr.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def lib_path() -> Path:
    """The library's path: the build directory, named by the hash of the
    source, the flags and the Python version."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
        + sys.version.encode()).hexdigest()[:16]
    return BUILD_DIR / f"aes_ctr_{digest}.so"


def _build(lib: Path) -> None:
    """Compile to a temporary path and rename it into place (atomic on
    POSIX). Raises with the compiler's output when g++ fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"native AES build failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


@functools.lru_cache(maxsize=1)
def load_aes() -> ctypes.CDLL:
    """Load the native AES library, building it first when it is missing.
    Raises RuntimeError or OSError when it cannot be built or loaded."""
    lib_file = lib_path()
    if not lib_file.exists():
        _build(lib_file)
    lib = ctypes.CDLL(str(lib_file))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ctt_aes128_key_schedule.argtypes = [u8p, u8p]
    lib.ctt_aes128_key_schedule.restype = None
    lib.ctt_aes128_encrypt_blocks.argtypes = [u8p, u8p, u8p, ctypes.c_size_t]
    lib.ctt_aes128_encrypt_blocks.restype = None
    lib.ctt_aes128_ctr_fill.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, ctypes.c_size_t]
    lib.ctt_aes128_ctr_fill.restype = None
    lib.ctt_aes128_ctr_fill_batch.argtypes = [
        u8p, u64p, u64p, u8p, ctypes.c_size_t, ctypes.c_size_t]
    lib.ctt_aes128_ctr_fill_batch.restype = None
    lib.ctt_aes128_has_hw.argtypes = []
    lib.ctt_aes128_has_hw.restype = ctypes.c_int
    return lib


def has_aesni() -> bool:
    """Does the native library run AES-NI on this CPU?"""
    return bool(load_aes().ctt_aes128_has_hw())
