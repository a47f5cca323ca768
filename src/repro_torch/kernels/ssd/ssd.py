"""Mamba2 SSD chunked scan: the public wrappers.

Counterpart of ``repro/kernels/ssd/ssd.py`` (the Pallas kernel and its
``ops.ssd_op``) and of the model's ``layers.ssd_chunked``.  A CUDA tensor
launches the hand-written kernel (``csrc/ssd.cu``); a CPU tensor, or an
explicit ``impl="torch"``, runs the plain chunked version
(``ref.ssd_chunked_ref``).  The model's form starts from a zero state or
from a carried one (``init_state``), as the reference's prefill does;
both forms take any S: the kernel masks the ragged tail, the plain
version pads it with dt = 0 steps.

Both forms are a ``torch.autograd.Function``, ``_SSDChunked``: it
differentiates x, dt, A, B, C and the initial state, and takes the final
state's gradient (None is zero).  The reference has no custom VJP (JAX
differentiates its jnp ``ssd_chunked``); the backward here is
``csrc/ssd_bwd.cu`` on a CUDA tensor and ``ref.ssd_chunked_bwd_ref`` on
a CPU tensor or under ``impl="torch"``.  It keeps the forward's inputs
and y; the backward runs the forward's state passes again rather than
keeping the chunk states (under activation checkpointing the forward
runs again anyway).  A meta tensor takes the meta route both ways
(``backend.record_meta``, the work of the kernel's own chunking).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.roofline import counts
from repro_torch.kernels.ssd.ops import ssd_bwd_cuda_heads, ssd_cuda_heads
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref, ssd_chunked_ref


def _by_row(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A state (B, H, P, N) as the kernels take it, (B * H, P, N)."""
    return None if t is None else t.flatten(0, 1).contiguous()


class _SSDChunked(torch.autograd.Function):
    """x (B, S, H, P), dt (B, S, H), a (B * H,), Bm/Cm (B, S, N) shared by
    the H heads, h0 (B, H, P, N) or None -> y (B, S, H, P) and the final
    state (B, H, P, N)."""

    @staticmethod
    def forward(ctx, x, dt, a, Bm, Cm, h0, chunk: int, impl: Optional[str]):
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        route = backend.resolve(impl, x)
        if route == "cuda":
            y, st = ssd_cuda_heads(x, dt, a, Bm, Cm, _by_row(h0))
            st = st.reshape(Bsz, H, P, N)
        elif route == "meta":
            backend.record_meta(backend.SSD, counts.ssd_bytes(Bsz, S, H, P, N),
                                counts.ssd_flops_at(Bsz, S, H, P, N,
                                                    counts.SSD_KERNEL_CHUNK))
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            st = torch.empty((Bsz, H, P, N), dtype=x.dtype, device=x.device)
        else:
            y, st = ssd_chunked_ref(x, dt, a, Bm, Cm, chunk, h0)
        ctx.save_for_backward(x, dt, a, Bm, Cm, h0, y)
        ctx.chunk, ctx.impl = chunk, impl
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, Bm, Cm, h0, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        route = backend.resolve(ctx.impl, x)
        if route == "meta":
            Bsz, S, H, P = x.shape
            N = Bm.shape[-1]
            backend.record_meta(
                backend.SSD_BWD, counts.ssd_bwd_bytes(Bsz, S, H, P, N),
                counts.ssd_bwd_flops_at(Bsz, S, H, P, N,
                                        counts.SSD_KERNEL_CHUNK))
            dx, ddt, da, dB, dC = (torch.empty(t.shape, dtype=t.dtype,
                                               device=t.device)
                                   for t in (x, dt, a, Bm, Cm))
            dinit = None if h0 is None else torch.empty(
                h0.shape, dtype=h0.dtype, device=h0.device)
        elif route == "cuda":
            dx, ddt, da, dB, dC, dinit = ssd_bwd_cuda_heads(
                x, dt, a, Bm, Cm, _by_row(h0), y, dy.contiguous(),
                _by_row(dstate))
            if dinit is not None:
                dinit = dinit.reshape(h0.shape)
        else:
            dx, ddt, da, dB, dC, dinit = ssd_chunked_bwd_ref(
                x, dt, a, Bm, Cm, ctx.chunk, h0, dy, dstate)
        return dx, ddt, da, dB, dC, dinit, None, None


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
        impl: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's signature: x (BH, S, P), dt (BH, S), a (BH,),
    Bm/Cm (BH, S, N), all float32 -> y (BH, S, P), final state (BH, P, N).
    ``chunk`` sets the plain version's chunking; the CUDA kernel scans in
    chunks of its own (256 rows), the same function up to rounding.  The
    model's form with one head a batch row."""
    y, st = _SSDChunked.apply(x[:, :, None], dt[:, :, None], a, Bm, Cm, None,
                              min(chunk, x.shape[1]), impl)
    return y[:, :, 0], st[:, 0]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None, *,
                impl: Optional[str] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's form: x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm
    (B, S, N) shared across heads, init_state (B, H, P, N) or None for a
    zero state, float32 -> y (B, S, H, P) and the final state (B, H, P,
    N).  On the card B and C go to the kernel as they are, with no copy
    across the heads; A goes as one rate a row b * H + h, and autograd
    sums its gradient back over the batch."""
    Bsz, _, H, _ = x.shape
    a = A.reshape(1, H).expand(Bsz, H).reshape(Bsz * H)
    return _SSDChunked.apply(x, dt, a, Bm, Cm, init_state, chunk, impl)
