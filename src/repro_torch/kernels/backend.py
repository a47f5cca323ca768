"""Kernel dispatch by device.

Counterpart of ``repro/kernels/backend.py``.  Where the JAX package picks
an engine per process (``pallas`` / ``pallas_interpret`` / ``jnp``, with
an environment override), the port decides per call from the tensor:

  * a CPU tensor runs the plain torch version;
  * a CUDA tensor launches the hand-written kernel, or raises;
  * ``impl="torch"`` is an explicit caller choice of the plain version
    on any device (used to time and check the plain version on the card).

There is no environment override and no fallback from a failed kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

IMPLS = (None, "cuda", "torch")


def check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"kernel_impl={impl!r} not in {IMPLS}")


def resolve(impl: Optional[str], t: torch.Tensor) -> str:
    """``"cuda"`` or ``"torch"`` for an op on tensor ``t``."""
    check_impl(impl)
    if impl == "torch":
        return "torch"
    kind = t.device.type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu" and impl is None:
        return "torch"
    raise ValueError(f"kernel_impl={impl!r} has no kernel for a tensor on "
                     f"{t.device}; CUDA kernels need CUDA tensors")


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` means the card, and raises when
    there is none — nothing quietly runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the "
                "caller asks for the CPU (device='cpu')")
        device = "cuda"
    return torch.device(device)
