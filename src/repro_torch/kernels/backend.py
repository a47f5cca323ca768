"""Kernel dispatch by device.

Counterpart of ``repro/kernels/backend.py``.  Where the JAX package picks
an engine per process (``pallas`` / ``pallas_interpret`` / ``jnp``, with
an environment override), the port decides per call from the tensor:

  * a CPU tensor runs the plain torch version;
  * a CUDA tensor launches the hand-written kernel, or raises;
  * a meta tensor (the dry run's stand-in for the card's) takes the meta
    route inside ``meta_route()``, which the dry run's counter opens: no
    launch and no work, outputs of the kernel's shapes and dtypes with
    no data, and the kernel's bytes and operations (from
    ``roofline.counts``) recorded by ``record_meta``; outside it a meta
    tensor has no kernel and raises, as any other device's;
  * ``impl="torch"`` is an explicit caller choice of the plain version
    on any device (used to time and check the plain version on the card).

There is no environment override and no fallback from a failed kernel.

Every CUDA kernel of the port has one launch counter here
(:class:`Kernel`, listed in :data:`KERNELS`): its wrapper adds one where
it launches the kernel and nowhere else, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

IMPLS = (None, "cuda", "torch")


def check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"kernel_impl={impl!r} not in {IMPLS}")


_META_ROUTE = False


@contextlib.contextmanager
def meta_route():
    """Within: a meta tensor takes its kernel's meta route."""
    global _META_ROUTE
    prev, _META_ROUTE = _META_ROUTE, True
    try:
        yield
    finally:
        _META_ROUTE = prev


def resolve(impl: Optional[str], t: torch.Tensor) -> str:
    """``"cuda"``, ``"meta"`` or ``"torch"`` for an op on tensor ``t``."""
    check_impl(impl)
    if impl == "torch":
        return "torch"
    kind = t.device.type
    if kind == "cuda" or (kind == "meta" and _META_ROUTE):
        return kind
    if kind == "cpu" and impl is None:
        return "torch"
    raise ValueError(f"kernel_impl={impl!r} has no kernel for a tensor on "
                     f"{t.device}; CUDA kernels need CUDA tensors")


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` (or ``"cuda"``) means the card,
    and raises when there is none — nothing quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the "
            "caller asks for the CPU (device='cpu')")
    return dev


# ---------------------------------------------------------------------------
# Launch plumbing shared by the kernels' wrappers
# ---------------------------------------------------------------------------


def check_tensor(t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``ndim`` dimensions: what a kernel's C interface takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C launcher."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, name: str,
             refused: Optional[dict[int, str]] = None) -> None:
    """A C launcher's status: 0 is launched, anything else raises.
    ``refused`` names the launcher's own argument checks (1000 + k) by
    status: those raise ``ValueError``, so each limit lives in the
    launcher alone."""
    if refused and rc in refused:
        raise ValueError(f"CUDA kernel {name} refused its arguments: "
                         f"{refused[rc]} (status {rc})")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: status {rc}")


class Kernel:
    """Launch counter of one CUDA kernel.  ``replaces`` is the file:line of
    the TPU kernel it ports, or with ``pallas=False`` of the reference's
    jnp function it replaces where that has no Pallas kernel (the flash
    backward: a custom VJP; the SSD backward: JAX's autodiff of the jnp
    ``ssd_chunked``); ``row_form``, where the TPU kernel has a
    single-row form beside its batched one, that form's file:line (the
    port runs it as the batched kernel with B = 1); ``loop``, where the
    kernel also runs the reference's host-side loop around the TPU kernel,
    that loop's file:line."""

    def __init__(self, name: str, source: str, replaces: str,
                 row_form: Optional[str] = None,
                 loop: Optional[str] = None, pallas: bool = True):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.row_form = row_form
        self.loop = loop
        self.pallas = pallas
        self.launches = 0


_SA_SRC = "src/repro_torch/csrc/secure_agg.cu"
_SA_REF = "src/repro/kernels/secure_agg/secure_agg.py"
MASK = Kernel("mask_encrypt", _SA_SRC, f"{_SA_REF}:272", f"{_SA_REF}:152")
UNMASK = Kernel("unmask_decrypt", _SA_SRC, f"{_SA_REF}:324",
                f"{_SA_REF}:208")
VOTE = Kernel("vote_combine", _SA_SRC, f"{_SA_REF}:388")
_MM_SRC = "src/repro_torch/csrc/modmul.cu"
MONT_MUL = Kernel("mont_mul", _MM_SRC,
                  "src/repro/kernels/modmul/modmul.py:95")
MONT_EXP = Kernel("mont_exp", _MM_SRC,
                  "src/repro/kernels/modmul/modmul.py:95",
                  loop="src/repro/kernels/modmul/ops.py:23")
FLASH_ATTENTION = Kernel(
    "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
    "src/repro/kernels/flash_attention/flash_attention.py:69")
SSD = Kernel("ssd", "src/repro_torch/csrc/ssd.cu",
             "src/repro/kernels/ssd/ssd.py:74")
FLASH_ATTENTION_BWD = Kernel(
    "flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
    "src/repro/models/layers.py:172", pallas=False)
SSD_BWD = Kernel("ssd_bwd", "src/repro_torch/csrc/ssd_bwd.cu",
                 "src/repro/models/layers.py:709", pallas=False)
SECURE_AGG = (MASK, UNMASK, VOTE)     # the secure allreduce's kernels
# the model stack's
MODEL = (FLASH_ATTENTION, SSD, FLASH_ATTENTION_BWD, SSD_BWD)
MODMUL = (MONT_MUL, MONT_EXP)        # threshold decryption's kernels
KERNELS = (*SECURE_AGG, *MODMUL, *MODEL)


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# kernel name -> {"calls", "bytes", "flops", "int_ops"}: what the meta
# route would have launched
_META: dict = {}


def record_meta(kernel: Kernel, nbytes: int, flops: int = 0,
                int_ops: int = 0) -> None:
    """Count one call of ``kernel`` on the meta route and its work (its
    ``launches`` stay as they are: nothing launched)."""
    c = _META.setdefault(kernel.name, {"calls": 0, "bytes": 0, "flops": 0,
                                       "int_ops": 0})
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["flops"] += int(flops)
    c["int_ops"] += int(int_ops)


def meta_counts() -> dict:
    return {k: dict(v) for k, v in _META.items()}


def reset_meta_counts() -> None:
    _META.clear()
