"""Build and bind the secure-aggregation CUDA kernels.

``csrc/secure_agg.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` into a shared library under ``build/kernels/``
at the root of the checkout, named by a hash of the source and the
flags, and loaded with ctypes; a later process with the same source
loads the cached library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "secure_agg.cu",)
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "sa_mask_encrypt": (_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float,
                        ctypes.c_float, ctypes.c_int, ctypes.c_int, _P),
    "sa_unmask_decrypt": (_P, _P, _P, _P, _I64, _I64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, _P),
    "sa_vote_combine": (ctypes.POINTER(_P), ctypes.c_int, _P, _P, _I64, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # of this process's build, if any
build_log = ""     # nvcc's output of that build: ptxas registers and spills


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsecure_agg_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the cached one for these sources exists.
    The output is written to a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        build_log = proc.stdout + proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib
