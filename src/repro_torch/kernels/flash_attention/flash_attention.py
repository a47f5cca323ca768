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

Where an input requires grad (training), the call is a
``torch.autograd.Function``, the counterpart of the reference's custom
VJP (``repro/models/layers.py:228``): the forward also keeps the row
log-sum-exp L, and the backward is ``csrc/flash_attention_bwd.cu`` on a
CUDA tensor (``ref.attention_bwd_ref`` on a CPU tensor or under
``impl="torch"``).  Under activation checkpointing the forward runs
again in the backward pass and saves a fresh L.  A meta tensor takes the
meta route both ways (``backend.record_meta``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.roofline import counts
from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)


def _meta_fwd(q, k, v, causal: bool, window: int, lse: bool = False):
    """The meta route of the forward: o (and L) with no data."""
    B, Sq, H, hd = q.shape
    nbytes, flops = counts.flash_fwd_work(B, Sq, k.shape[1], H, k.shape[2],
                                          hd, causal, window,
                                          q.element_size(), lse)
    backend.record_meta(backend.FLASH_ATTENTION, nbytes, flops)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not lse:
        return o
    return o, torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)


def _meta_bwd(q, k, v, causal: bool, window: int):
    """The meta route of the backward: dq, dk, dv with no data."""
    B, Sq, H, hd = q.shape
    nbytes, flops = counts.flash_bwd_work(B, Sq, k.shape[1], H, k.shape[2],
                                          hd, causal, window,
                                          q.element_size())
    backend.record_meta(backend.FLASH_ATTENTION_BWD, nbytes, flops)
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


class _FlashAttention(torch.autograd.Function):
    """Attention with a FlashAttention-2 backward from (q, k, v, o, L)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                impl: Optional[str]):
        route = backend.resolve(impl, q)
        if route == "cuda":
            o, lse = flash_attention_cuda(q, k, v, causal, window, lse=True)
        elif route == "meta":
            o, lse = _meta_fwd(q, k, v, causal, window, lse=True)
        else:
            o, lse = attention_fwd_ref(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        route = backend.resolve(ctx.impl, q)
        if route == "cuda":
            grads = flash_attention_bwd_cuda(q, k, v, o, do, lse, ctx.causal,
                                             ctx.window)
        elif route == "meta":
            grads = _meta_bwd(q, k, v, ctx.causal, ctx.window)
        else:
            grads = attention_bwd_ref(q, k, v, o, do, lse, causal=ctx.causal,
                                      window=ctx.window)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Attention with the scale 1/sqrt(hd) applied to q in float32 inside,
    causal and chunked-window (``qpos // window == kpos // window``)
    masks; returns (B, Sq, H, hd) in q's dtype.  Differentiable in q, k
    and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, impl)
    route = backend.resolve(impl, q)
    if route == "cuda":
        return flash_attention_cuda(q, k, v, causal, window)
    if route == "meta":
        return _meta_fwd(q, k, v, causal, window)
    return attention_ref(q, k, v, causal=causal, window=window)
