"""Flash attention: the public wrapper.

Counterpart of ``repro/kernels/flash_attention/flash_attention.py`` (the
Pallas kernel and its ``ops.flash_attention_op``), with its public
layout: q ``(B, Sq, H, hd)``, k and v ``(B, Skv, K, hd)``, query head h
reading kv head ``h // (H // K)``.  A CUDA tensor launches a
hand-written kernel (``csrc/flash_attention.cu``: bf16 on the tensor
cores, float32 on the CUDA cores); a CPU tensor, or an explicit
``impl="torch"``, runs the plain version (``ref.attention_ref``).
Unlike the Pallas wrapper, any Sq and Skv are taken: the kernel masks the
ragged edge of its tiles itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Attention with the scale 1/sqrt(hd) applied to q in float32 inside,
    causal and chunked-window (``qpos // window == kpos // window``)
    masks; returns (B, Sq, H, hd) in q's dtype."""
    if backend.resolve(impl, q) == "cuda":
        return flash_attention_cuda(q, k, v, causal, window)
    return attention_ref(q, k, v, causal=causal, window=window)
