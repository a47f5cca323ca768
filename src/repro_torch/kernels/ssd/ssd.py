"""Mamba2 SSD chunked scan: the public wrappers.

Counterpart of ``repro/kernels/ssd/ssd.py`` (the Pallas kernel and its
``ops.ssd_op``) and of the model's ``layers.ssd_chunked``.  A CUDA tensor
launches the hand-written kernel (``csrc/ssd.cu``); a CPU tensor, or an
explicit ``impl="torch"``, runs the plain chunked version
(``ref.ssd_chunked_ref``).  Both forms start from a zero state, as the
Pallas kernel and the model's prefill do, and take any S: the kernel
masks the ragged tail, the plain version pads it with dt = 0 steps.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ssd.ops import ssd_cuda_heads
from repro_torch.kernels.ssd.ref import ssd_chunked_ref


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
        impl: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's signature: x (BH, S, P), dt (BH, S), a (BH,),
    Bm/Cm (BH, S, N), all float32 -> y (BH, S, P), final state (BH, P, N).
    ``chunk`` sets the plain version's chunking; the CUDA kernel scans in
    chunks of its own (256 rows), the same function up to rounding."""
    if backend.resolve(impl, x) == "cuda":
        y, st = ssd_cuda_heads(x[:, :, None], dt[:, :, None], a, Bm, Cm)
        return y[:, :, 0], st
    y, st = ssd_chunked_ref(x[:, :, None], dt[:, :, None], a[:, None], Bm,
                            Cm, min(chunk, x.shape[1]))
    return y[:, :, 0], st[:, 0]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, *,
                impl: Optional[str] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's form: x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm
    (B, S, N) shared across heads, float32 -> y (B, S, H, P) and the final
    state (B, H, P, N).  On the card B and C go to the kernel as they are,
    with no copy across the heads."""
    if backend.resolve(impl, x) == "cuda":
        Bsz, _, H, P = x.shape
        a = A.reshape(1, H).expand(Bsz, H).reshape(Bsz * H).contiguous()
        y, st = ssd_cuda_heads(x, dt, a, Bm, Cm)
        return y, st.reshape(Bsz, H, P, Bm.shape[-1])
    return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
