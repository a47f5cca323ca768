"""Distribution context read by the model layers: the counterpart of
the reference's ``repro/runtime/context.py``.

``DistCtx`` says whether a mesh exists (no mesh: every layer runs on its
own device), which of its axes carry data parallelism, which one the
experts are split over and which one the tensor-parallel (TP) weights
are split over.  Every rank of the port is a process of its own that
holds only its tokens, its experts and its TP slice of the weights:
every axis is manual, all the time.  So the reference's ``manual_dp``
flag, its ``manual_axes``, its partial-manual ``shard_map`` over GSPMD
and its ``constrain`` (a GSPMD sharding hint) have no counterpart: where
the reference lets XLA insert the collectives that its hints imply, the
model layers here call them, Megatron-style, on the TP axis's group:

  * ``tp_copy``: identity forward, sum over the axis backward (where a
    replicated tensor enters a rank's slice of the work);
  * ``tp_reduce``: sum over the axis forward, identity backward (a
    row-parallel product's partial sums, whose result is replicated);
  * ``tp_gather``: the ranks' pieces concatenated along the last dim
    forward, this rank's piece of the gradient backward (the
    vocab-parallel head's logits).

Fully sharded data parallelism (FSDP) over ``fsdp_axis``: a rank holds
a slice of each FSDP leaf (``launch.sharding``), and ``fsdp_gather``
joins the slices where a unit runs (all-gather forward, reduce-scatter
of the gradient backward, so the slice's gradient comes back summed over
the axis).  It gathers the compute-dtype copy: a cast commutes with a
gather, so a bfloat16 gather sends half the bytes for the same result;
the gradient is summed in float32 and returned in the master's dtype.

Every collective here, and the step's gradient sums
(``launch.steps.axes_sum_``), adds its call and the bytes of its operand
(what this rank hands the collective: the shard of a gather, the whole
tensor of a sum or a reduce-scatter) to one tally by kind
(``collective_counts``), which the dry run reads.

Gloo has no bfloat16 sum: a bfloat16 (or float16) partial sum goes over
the wire as float32 and is cast back once, after the sum, so the port
sums TP partials more finely than the reference's XLA all-reduce does
in the activation dtype.

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
    tp_axis: Optional[str] = None       # tensor-parallel axis
    # True in the baseline train step, the reference's GSPMD step: a
    # rank's batch is its shard of the global batch, and the reference's
    # replicated-token test reads the global batch, which always splits
    sharded_batch: bool = False
    fsdp_axis: Optional[str] = None     # the axis FSDP slices lie on


_CURRENT = DistCtx()

# kind -> {"calls", "bytes"}: every collective this process has made
_COLLECTIVES: dict = {}


def tally(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose operand is ``nbytes``."""
    c = _COLLECTIVES.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += int(nbytes)


def collective_counts() -> dict:
    return {k: dict(v) for k, v in _COLLECTIVES.items()}


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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


def axis_group(mesh, ax: str) -> tuple:
    """(group, this rank's index on ``ax``, the axis's size): the ranks
    that share this rank's coordinates off ``ax``, in their order on it.
    Built once a mesh (``dist.new_group`` is collective: every rank
    builds every slice's group)."""
    n = mesh.shape[ax]
    group, _ = subgroup(mesh, (ax,), [tuple(range(n))])
    return group, mesh.coord(ax), n


def ep_group(ctx: DistCtx) -> tuple:
    """``axis_group`` of the expert axis."""
    return axis_group(ctx.mesh, ctx.ep_axis)


def tp_size(ctx: DistCtx) -> int:
    """The TP axis's extent (1: no TP; every collective is the
    identity)."""
    if ctx.mesh is None or ctx.tp_axis is None:
        return 1
    return ctx.mesh.shape[ctx.tp_axis]


def tp_index(ctx: DistCtx) -> int:
    """This rank's index on the TP axis (0 without one)."""
    return ctx.mesh.coord(ctx.tp_axis) if tp_size(ctx) > 1 else 0


def tp_group(ctx: DistCtx, span: int = 0) -> tuple:
    """(group, this rank's index in it, its size): the ranks that share
    this rank's coordinates off the TP axis and, where ``span`` is given,
    its block of ``span`` consecutive TP indices (the ranks that hold one
    replicated KV head).  Built once a mesh, as ``ep_group``."""
    mesh, ax = ctx.mesh, ctx.tp_axis
    n = mesh.shape[ax]
    span = span or n
    blocks = [tuple(range(b, b + span)) for b in range(0, n, span)]
    group, _ = subgroup(mesh, (ax,), blocks)
    return group, mesh.coord(ax) % span, span


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
    tally("ep_exchange", _nbytes(h))
    dist.all_to_all_single(_wire_view(out), _wire_view(h), group=group)
    return out.to(send.device)


def _sum(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    group, _, _ = ep_group(ctx)
    h = _stage(t, ctx.mesh)
    if h is t:
        h = t.clone()
    tally("ep_sum", _nbytes(h))
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


# ---------------------------------------------------------------------------
# Tensor parallelism over ctx.tp_axis
# ---------------------------------------------------------------------------


def _tp_sum(ctx: DistCtx, t: torch.Tensor, span: int) -> torch.Tensor:
    """The sum of ``t`` over the TP group, in float32 on the wire where
    ``t`` is a narrower float (gloo sums no bfloat16), cast back after."""
    group, _, _ = tp_group(ctx, span)
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    h = _stage(wide, ctx.mesh)
    if h is t:
        h = t.clone()
    tally("tp_sum", _nbytes(h))
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    return h.to(device=t.device, dtype=t.dtype)


def _tp_cat(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The TP ranks' ``t`` concatenated along the last dim, in rank
    order (the bytes gathered: any dtype)."""
    group, _, n = tp_group(ctx)
    h = _stage(t, ctx.mesh)
    parts = [torch.empty_like(h) for _ in range(n)]
    tally("tp_cat", _nbytes(h))
    dist.all_gather([_wire_view(p) for p in parts], _wire_view(h),
                    group=group)
    return torch.cat(parts, dim=-1).to(t.device)


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, span):
        fctx.ctx, fctx.span = ctx, span
        return t.view_as(t)

    @staticmethod
    def backward(fctx, grad):
        return _tp_sum(fctx.ctx, grad.contiguous(), fctx.span), None, None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        return _tp_sum(ctx, t.contiguous(), 0)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


class _TPGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        fctx.ctx, fctx.width = ctx, t.shape[-1]
        return _tp_cat(ctx, t.contiguous())

    @staticmethod
    def backward(fctx, grad):
        w = fctx.width
        i = tp_index(fctx.ctx)
        return grad[..., i * w:(i + 1) * w].contiguous(), None


def tp_copy(ctx: DistCtx, t: torch.Tensor, span: int = 0) -> torch.Tensor:
    """``t`` as it is; its gradient summed over the TP axis (over this
    rank's block of ``span`` TP ranks where given).  Marks a replicated
    tensor (an activation, or a replicated weight) where it enters work
    that each rank does on its own slice."""
    if tp_size(ctx) == 1:
        return t
    return _TPCopy.apply(t, ctx, span)


def tp_reduce(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``t`` over the TP axis, the same on
    every rank; its gradient passes as it is."""
    if tp_size(ctx) == 1:
        return t
    return _TPReduce.apply(t, ctx)


def tp_gather(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The TP ranks' ``t`` (..., n) concatenated to (..., tp * n); the
    gradient of this rank's columns comes back."""
    if tp_size(ctx) == 1:
        return t
    return _TPGather.apply(t, ctx)


# ---------------------------------------------------------------------------
# FSDP over ctx.fsdp_axis
# ---------------------------------------------------------------------------


def fsdp_size(ctx: DistCtx) -> int:
    """The FSDP axis's extent (1: no FSDP; nothing is gathered)."""
    if ctx.mesh is None or ctx.fsdp_axis is None:
        return 1
    return ctx.mesh.shape[ctx.fsdp_axis]


def _fsdp_cat(ctx: DistCtx, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The axis's slices of ``t`` joined along ``dim``, in rank order."""
    group, _, n = axis_group(ctx.mesh, ctx.fsdp_axis)
    h = _stage(t, ctx.mesh)
    parts = [torch.empty_like(h) for _ in range(n)]
    tally("fsdp_gather", _nbytes(h))
    dist.all_gather([_wire_view(p) for p in parts], _wire_view(h),
                    group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _fsdp_scatter(ctx: DistCtx, g: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``g`` over the axis,
    in float32 (gloo sums no bfloat16)."""
    group, _, n = axis_group(ctx.mesh, ctx.fsdp_axis)
    wide = g.float()
    blocks = [_stage(b.contiguous(), ctx.mesh) for b in wide.chunk(n, dim)]
    out = torch.empty_like(blocks[0])
    tally("fsdp_scatter", _nbytes(wide))
    dist.reduce_scatter(out, blocks, op=dist.ReduceOp.SUM, group=group)
    return out.to(g.device)


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, w, ctx, dim, dtype):
        fctx.ctx, fctx.dim, fctx.dtype = ctx, dim, w.dtype
        return _fsdp_cat(ctx, w.to(dtype).contiguous(), dim)

    @staticmethod
    def backward(fctx, grad):
        g = _fsdp_scatter(fctx.ctx, grad, fctx.dim)
        return g.to(fctx.dtype), None, None, None


def fsdp_gather(ctx: DistCtx, w: torch.Tensor, dim: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The whole leaf in ``dtype`` from this rank's FSDP slice ``w`` (cut
    on ``dim``); the gradient of ``w`` is the whole gradient summed over
    the FSDP axis, this rank's block of it."""
    if fsdp_size(ctx) == 1:
        return w.to(dtype)
    return _FSDPGather.apply(w, ctx, dim, dtype)
