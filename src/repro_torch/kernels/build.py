"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface.  At first use each source is
compiled by its own ``nvcc`` process (all started together), and one
more ``nvcc`` links the objects into a single shared library under
``build/kernels/`` at the root of the checkout, named by a hash of all
sources, the headers they include and the flags; it is loaded with
ctypes.  A later process with the same sources loads the cached library.
Nothing here runs at import time.
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

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))   # included by them
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "sa_mask_encrypt": (_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float,
                        ctypes.c_float, ctypes.c_int, ctypes.c_int, _P),
    "sa_unmask_decrypt": (_P, _P, _P, _P, _I64, _I64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, _P),
    "sa_vote_combine": (ctypes.POINTER(_P), ctypes.c_int, _P, _P, _I64, _P),
    "mm_mont_mul": (_P, _P, _P, ctypes.c_uint32, _P, _I64, ctypes.c_int, _P),
    # base, bits, n, n0inv, one, out, batch, L, nbits, stream
    "mm_mont_exp": (_P, _P, _P, ctypes.c_uint32, _P, _P, _I64, ctypes.c_int,
                    ctypes.c_int, _P),
    # q, k, v, o, lse (or null), B, H, K, Sq, Skv, hd, causal, window,
    # scale, is_bf16, stream
    "fa_flash_attention": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, _P),
    # q, k, v, o, do, lse, delta, dq, dk, dv, B, H, K, Sq, Skv, hd,
    # causal, window, scale, is_bf16, stream
    "fa_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float,
                               ctypes.c_int, _P),
    # x, dt, a, Bm, Cm, h0 (or null), y, state, scratch cum, cb, states,
    # BH, H, S, P, N, chunk, x strides (b, h, s), dt strides (b, h, s),
    # B/C strides (b, s), stream
    "ssd_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                 _I64, _P),
    # x, dt, a, Bm, Cm, h0, y, dy, dstate (h0, dstate null for zero); dx,
    # ddt, da, dB, dC, dinit (null without h0); scratch cum, cb, states,
    # hfin, gstates, mcb, dcum, xr; BH, H, S, P, N, chunk, the strides as
    # ssd_scan's, stream
    "ssd_bwd": (*([_P] * 23), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64, _I64, _I64,
                _I64, _I64, _I64, _I64, _I64, _P),
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the first failure's
    output, else return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(SOURCES, objs)])
        lib_tmp = str(Path(tmp) / out.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, out)
    build_log = log
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
