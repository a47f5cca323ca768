"""Distribution context read by the model layers: the part of the
reference's ``repro/runtime/context.py`` the MoE MLP needs.

``DistCtx`` says whether a mesh exists (no mesh: every layer runs on its
own device), which of its axes carry data parallelism and which one the
experts are split over.  Every rank of the port is a process of its own
that holds only its tokens and its experts: the reference's manual mode
(inside a ``shard_map``) is the only one, so the reference's
``manual_dp`` flag and its partial-manual ``shard_map`` over GSPMD have
no counterpart.

The expert axis's collectives (``all_to_all``, ``all_reduce_sum``) run
on the axis's process group; a CUDA tensor over gloo is staged through
pinned host memory, as ``core.engine.ManualTransport``'s wires are.  Both
are ``torch.autograd.Function``s, so a training step's gradient flows
back through the expert exchange: the backward of ``all_to_all`` is the
same exchange run back (row j of the gradient goes to the rank it came
from), and the backward of ``all_reduce_sum`` is ``all_reduce_sum`` of
the gradient, which is what ``jax.grad`` gives for the reference's
``psum`` inside its ``shard_map(..., check_vma=False)``: each rank's
gradient is that of the sum of every rank's loss.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.schedules import ConfigError
from repro_torch.runtime.compat import subgroup


@dataclasses.dataclass(frozen=True)
class DistCtx:
    mesh: Optional[object] = None       # a compat.NodeMesh
    dp_axes: tuple[str, ...] = ()       # data-parallel axes
    ep_axis: Optional[str] = None       # expert-parallel axis
    # True in the baseline train step, the reference's GSPMD step: a
    # rank's batch is its shard of the global batch, and the reference's
    # replicated-token test reads the global batch, which always splits
    sharded_batch: bool = False


_CURRENT = DistCtx()


def get_ctx() -> DistCtx:
    return _CURRENT


@contextlib.contextmanager
def use_ctx(ctx: DistCtx):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev


def ep_group(ctx: DistCtx) -> tuple:
    """(group, this rank's index on the expert axis, the axis's size): the
    ranks that share this rank's coordinates off the expert axis, in
    their order on it.  Built once a mesh (``dist.new_group`` is
    collective: every rank builds every slice's group)."""
    mesh, ax = ctx.mesh, ctx.ep_axis
    n = mesh.shape[ax]
    group, _ = subgroup(mesh, (ax,), [tuple(range(n))])
    return group, mesh.coord(ax), n


def _stage(t: torch.Tensor, mesh) -> torch.Tensor:
    """The host tensor gloo takes for ``t`` (a pinned copy of a CUDA
    tensor after the stream's work; a CPU tensor as it is)."""
    if t.device.type != "cuda":
        return t.contiguous()
    if mesh.backend != "gloo":
        raise ConfigError(f"CUDA tensors over a {mesh.backend!r} group: only "
                          "gloo (staged through host memory) is supported")
    torch.cuda.current_stream(t.device).synchronize()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _wire_view(t: torch.Tensor) -> torch.Tensor:
    """Bytes of ``t`` (gloo has no float8 or bfloat16 type of its own)."""
    return t.reshape(-1).view(torch.uint8)


def _exchange(ctx: DistCtx, send: torch.Tensor) -> torch.Tensor:
    group, _, n = ep_group(ctx)
    if send.shape[0] != n:
        raise ValueError(f"send has {send.shape[0]} rows, the expert axis "
                         f"{n} ranks")
    h = _stage(send, ctx.mesh)
    out = torch.empty_like(h)
    dist.all_to_all_single(_wire_view(out), _wire_view(h), group=group)
    return out.to(send.device)


def _sum(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    group, _, _ = ep_group(ctx)
    h = _stage(t, ctx.mesh)
    if h is t:
        h = t.clone()
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    return h.to(t.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, send, ctx):
        fctx.ctx = ctx
        return _exchange(ctx, send)

    @staticmethod
    def backward(fctx, grad):
        return _exchange(fctx.ctx, grad.contiguous()), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        fctx.ctx = ctx
        return _sum(ctx, t)

    @staticmethod
    def backward(fctx, grad):
        return _sum(fctx.ctx, grad.contiguous()), None


def all_to_all(ctx: DistCtx, send: torch.Tensor) -> torch.Tensor:
    """``send`` (n_ep, ...) -> recv (n_ep, ...): row j goes to the rank at
    index j of the expert axis, and recv's row j comes from it (the
    reference's ``all_to_all(split_axis=0, concat_axis=0)``)."""
    return _AllToAll.apply(send, ctx)


def all_reduce_sum(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the expert axis, on every rank of it."""
    return _AllReduceSum.apply(t, ctx)
