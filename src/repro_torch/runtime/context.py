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
    vocab-parallel head's last-position logits, which serving reads).

Each mixer and MLP takes the residual stream in through ``tp_enter`` and
hands its row-parallel partial sums out through ``tp_exit``; everything
between works on the rank's slice, so every gradient there is this
rank's part, and a replicated weight read there enters through
``tp_copy`` (its gradient summed, whole on every rank).  Without
sequence parallelism ``tp_enter`` is ``tp_copy`` and ``tp_exit`` is
``tp_reduce``.  With it (``DistCtx.seq_parallel``, the reference's
``seq_parallel``: its residual stream constrained to ``P(dp, "model",
None)`` between the units) a rank holds its block of ``S / tp``
positions of the residual stream: ``tp_enter`` all-gathers the sequence
(its backward a reduce-scatter of the gradient) and ``tp_exit``
reduce-scatters the partial sums onto the rank's positions (its backward
an all-gather), the same sums as the all-reduce, split.

``vocab_ce`` is the cross-entropy of logits cut on the vocabulary over
the TP axis (the reference's loss over its logits left on ``"model"``):
one all-reduce of the row max, one of the sum of exponentials and one of
the label's logit, each a float32 (B, S); its backward is the rank's
columns of ``softmax - onehot``, with no collective.

In the reference's GSPMD step the expert exchange is a ``shard_map``
manual over ``"data"`` alone (``in_specs`` ``P("data")``), while the batch
lies over ``("pod", "data")``, pod-major: on a mesh of ``P`` pods and
``D`` data ranks, rank (p, d) holds block ``j = p D + d`` of the global
batch's ``P D`` blocks, and the body on data coordinate ``d`` (every
pod's rank alike) dispatches rows ``[d B / D, (d + 1) B / D)``, blocks
``d P .. d P + P - 1``, with the capacity of that many tokens: on the
(2, 2, 1) mesh ranks (0, 0) and (1, 0) both dispatch blocks 0 and 1,
those of ranks (0, 0) and (0, 1), and (0, 1) and (1, 1) blocks 2 and 3.
Which of a block's pairs drop depends only on the expert ids of the
whole set of blocks and on their count, so ``pool_ids`` all-gathers the
(T, k) ids over the ``P`` ranks that hold a set (no activation moves, no
backward): each rank ranks the pooled pairs with the set's capacity and
dispatches its own rows at their slots, and each pod works only its own
rows where the reference's pods repeat each other's.

Fully sharded data parallelism (FSDP) over ``fsdp_axis``: a rank holds
a slice of each FSDP leaf (``launch.sharding``), and ``fsdp_gather``
joins the slices where a unit runs (all-gather forward, reduce-scatter
of the gradient backward, so the slice's gradient comes back summed over
the axis).  It gathers the compute-dtype copy: a cast commutes with a
gather, so a bfloat16 gather sends half the bytes for the same result;
the gradient is summed in float32 and returned in the master's dtype.

A served KV cache lies as the reference's ``cache_specs`` put it: each
K / V leaf holds every KV head, its positions cut into ``n`` equal
blocks over ``cache_axes`` (``"model"`` where the batch splits over the
dp axes, ``("data", "model")`` where it does not; ``cache_cut`` gives
``n`` and the rank's block).  The prefill hands each TP rank its block
of positions of every head with one all-to-all over the TP group
(``cache_exchange``); a decode step gathers the token's q, k and v
heads over the TP group (``tp_heads``), each rank attends over its
block of positions, and the partial softmaxes are gathered over the
cut (``cut_gather``) and combined on every rank: in float32 each row's
max, its exponentials' sum and their product with V in one gather; in
a narrower cache dtype the rows' maxes and sums first, then each
block's normalized p, rounded to that dtype as the reference rounds it,
times V (``models.layers.decode_attention_cut``).

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
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.schedules import ConfigError
from repro_torch.runtime.compat import flat_node_id, subgroup


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
    # the residual stream cut on the sequence over the TP axis (a config's
    # seq_parallel, where the sequence splits; never in a decode step)
    seq_parallel: bool = False
    # the axes a KV cache's positions are cut over, major to minor (the
    # reference's cache_specs: "model" where the batch splits over the dp
    # axes, ("data", "model") where it does not); an axis the mesh lacks,
    # or of one rank, drops out
    cache_axes: tuple[str, ...] = ("model",)


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


def _tp_sum(ctx: DistCtx, t: torch.Tensor, span: int, op=dist.ReduceOp.SUM,
            kind: str = "tp_sum") -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over the TP group, in float32 on the
    wire where ``t`` is a narrower float (gloo sums no bfloat16), cast
    back after."""
    group, _, _ = tp_group(ctx, span)
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    h = _stage(wide, ctx.mesh)
    if h is t:
        h = t.clone()
    tally(kind, _nbytes(h))
    dist.all_reduce(h, op=op, group=group)
    return h.to(device=t.device, dtype=t.dtype)


def _gather(mesh, group, n: int, t: torch.Tensor, dim: int,
            kind: str) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` joined along ``dim``, in rank
    order (the bytes gathered: any dtype)."""
    h = _stage(t, mesh)
    parts = [torch.empty_like(h) for _ in range(n)]
    tally(kind, _nbytes(h))
    dist.all_gather([_wire_view(p) for p in parts], _wire_view(h),
                    group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _sum_block(mesh, group, n: int, t: torch.Tensor, dim: int,
               kind: str) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over the ``n``
    ranks of ``group``, in float32 (gloo sums no bfloat16)."""
    wide = t.float()
    blocks = [_stage(b.contiguous(), mesh) for b in wide.chunk(n, dim)]
    out = torch.empty_like(blocks[0])
    tally(kind, _nbytes(wide))
    dist.reduce_scatter(out, blocks, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def _tp_cat(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The TP ranks' ``t`` concatenated along the last dim."""
    group, _, n = tp_group(ctx)
    return _gather(ctx.mesh, group, n, t, -1, "tp_cat")


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


def seq_cut(ctx: DistCtx) -> bool:
    """Is the residual stream cut on the sequence over the TP axis?"""
    return ctx.seq_parallel and tp_size(ctx) > 1


def _seq_cat(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The TP ranks' blocks of positions (B, S / tp, ...) joined into
    (B, S, ...), in rank order."""
    group, _, n = tp_group(ctx)
    return _gather(ctx.mesh, group, n, t, 1, "tp_seq_gather")


def _seq_sum_block(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of positions of the sum of ``t`` (B, S, ...)
    over the TP axis, in ``t``'s dtype."""
    group, _, n = tp_group(ctx)
    return _sum_block(ctx.mesh, group, n, t, 1,
                      "tp_seq_scatter").to(t.dtype)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        fctx.ctx = ctx
        return _seq_cat(ctx, t.contiguous())

    @staticmethod
    def backward(fctx, grad):
        return _seq_sum_block(fctx.ctx, grad.contiguous()), None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        fctx.ctx = ctx
        return _seq_sum_block(ctx, t.contiguous())

    @staticmethod
    def backward(fctx, grad):
        return _seq_cat(fctx.ctx, grad.contiguous()), None


def tp_enter(ctx: DistCtx, x: torch.Tensor) -> torch.Tensor:
    """The residual stream (B, S, D) where a mixer or an MLP takes it:
    ``tp_copy`` of it, or under ``seq_cut`` the whole sequence gathered
    from the ranks' blocks (the gradient reduce-scattered back)."""
    if tp_size(ctx) == 1:
        return x
    if seq_cut(ctx):
        return _SeqGather.apply(x, ctx)
    return _TPCopy.apply(x, ctx, 0)


def tp_exit(ctx: DistCtx, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel output's partial sums (B, S, D) back into the
    residual stream: ``tp_reduce``, or under ``seq_cut`` the sum's block
    of this rank's positions (the gradient all-gathered)."""
    if tp_size(ctx) == 1:
        return y
    if seq_cut(ctx):
        return _SeqScatter.apply(y, ctx)
    return _TPReduce.apply(y, ctx)


def seq_block(ctx: DistCtx, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of positions of a replicated (B, S, ...) input
    under ``seq_cut`` (an audio model's frames), else ``x``."""
    if not seq_cut(ctx):
        return x
    n, i = tp_size(ctx), tp_index(ctx)
    return x.chunk(n, 1)[i]


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels, ctx):
        v_loc = logits.shape[-1]
        local = labels.long() - tp_index(ctx) * v_loc
        mine = (local >= 0) & (local < v_loc)
        local = torch.where(mine, local, torch.zeros_like(local))
        m = _tp_sum(ctx, logits.amax(-1), 0, dist.ReduceOp.MAX, "tp_loss")
        sumexp = _tp_sum(ctx, torch.exp(logits - m[..., None]).sum(-1), 0,
                         kind="tp_loss")
        lse = m + torch.log(sumexp)
        picked = logits.gather(-1, local[..., None])[..., 0] * mine
        picked = _tp_sum(ctx, picked, 0, kind="tp_loss")
        fctx.save_for_backward(logits, lse, local, mine)
        return lse - picked

    @staticmethod
    def backward(fctx, grad):
        logits, lse, local, mine = fctx.saved_tensors
        g = torch.exp(logits - lse[..., None])
        g.scatter_add_(-1, local[..., None], -mine[..., None].to(g.dtype))
        return g * grad[..., None], None, None


def vocab_ce(ctx: DistCtx, logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
    """Per position ``logsumexp(z) - z[label]`` of the float32 logits z
    (B, S, V) whose columns ``[i V / tp, (i+1) V / tp)`` are this rank's
    ``logits`` (the padded columns already at -1e30); ``labels`` (B, S)
    are global column indices in ``[0, V)``."""
    return _VocabCE.apply(logits, labels, ctx)


# ---------------------------------------------------------------------------
# The KV cache cut on its positions over ctx.cache_axes (serving only: no
# gradient flows through these)
# ---------------------------------------------------------------------------


def _cut_axes(ctx: DistCtx) -> tuple:
    if ctx.mesh is None:
        return ()
    return tuple(a for a in ctx.cache_axes
                 if a in ctx.mesh.axis_names and ctx.mesh.shape[a] > 1)


def cache_cut(ctx: DistCtx) -> tuple[int, int]:
    """(n, j): the blocks a KV cache's positions are cut into, and this
    rank's block, its index row-major over the cut's axes in the spec's
    order (``data_coord * tp + model_coord`` over ("data", "model"));
    (1, 0) where nothing cuts."""
    axes = _cut_axes(ctx)
    if not axes:
        return 1, 0
    return (math.prod(ctx.mesh.shape[a] for a in axes),
            flat_node_id(ctx.mesh, axes))


def cut_gather(ctx: DistCtx, t: torch.Tensor,
               kind: str = "tp_decode_combine") -> torch.Tensor:
    """The cut's ranks' ``t`` stacked on a new first dimension, in block
    order (a decode step's partial softmaxes: their row statistics under
    ``kind="tp_decode_stats"``, their products with V under the
    default), tallied under ``kind``."""
    axes = _cut_axes(ctx)
    n = math.prod(ctx.mesh.shape[a] for a in axes)
    # the mesh's own group where the cut spans it: a second gloo group of
    # the same ranks can abort its process at exit
    group = ctx.mesh.group if n == ctx.mesh.size else subgroup(
        ctx.mesh, axes, [tuple(range(n))])[0]
    return _gather(ctx.mesh, group, n, t[None], 0, kind)


def tp_heads(ctx: DistCtx, t: torch.Tensor) -> torch.Tensor:
    """The TP ranks' ``t`` stacked on a new first dimension, in rank
    order (a decode step's q, k, v heads; any dtype, as bytes)."""
    group, _, n = tp_group(ctx)
    return _gather(ctx.mesh, group, n, t[None], 0, "tp_decode_qkv")


def cache_exchange(ctx: DistCtx, sends: list, recv_bytes: list) -> list:
    """One all-to-all over the TP group: ``sends[p]`` (any dtype) goes to
    TP rank p, and the bytes from rank p come back as a uint8 tensor of
    ``recv_bytes[p]`` (a prefill's cache blocks; a part may be empty)."""
    group, _, _ = tp_group(ctx)
    send = torch.cat([_wire_view(s.contiguous()) for s in sends])
    h = _stage(send, ctx.mesh)
    out = torch.empty(sum(recv_bytes), dtype=torch.uint8, device=h.device)
    tally("tp_cache_a2a", _nbytes(h))
    dist.all_to_all_single(out, h, list(recv_bytes),
                           [_nbytes(s) for s in sends], group=group)
    return list(out.to(send.device).split(list(recv_bytes)))


# ---------------------------------------------------------------------------
# The GSPMD step's expert dispatch over the dp axes' blocks of rows
# ---------------------------------------------------------------------------


def pooled(ctx: DistCtx) -> bool:
    """Does the expert dispatch rank a set of blocks pooled from several
    ranks (the GSPMD step, ``sharded_batch``, on a mesh whose dp axes
    other than the expert axis have more than one rank)?"""
    if not ctx.sharded_batch or ctx.mesh is None or ctx.ep_axis is None:
        return False
    return _pool_shape(ctx)[0] > 1


def _pool_shape(ctx: DistCtx) -> tuple:
    """(P, D, j): the dp extent off the expert axis, the expert axis's
    extent, and this rank's block (its node id over the dp axes, the
    expert axis minor)."""
    mesh = ctx.mesh
    if ctx.dp_axes[-1] != ctx.ep_axis:
        raise ConfigError(f"the expert axis {ctx.ep_axis!r} must be the last "
                          f"dp axis of {ctx.dp_axes}")
    D = mesh.shape[ctx.ep_axis]
    n = 1
    j = 0
    for a in ctx.dp_axes:
        n *= mesh.shape[a]
        j = j * mesh.shape[a] + mesh.coord(a)
    return n // D, D, j


def pool_ids(ctx: DistCtx, idx: torch.Tensor) -> tuple:
    """(the expert ids (P T, k) of this rank's set of blocks ``s P .. s P
    + P - 1``, ``s = j // P``, in block order; this rank's place ``j % P``
    in it) from this rank's ids ``idx`` (T, k)."""
    P, D, j = _pool_shape(ctx)
    group, _ = subgroup(ctx.mesh, ctx.dp_axes,
                        [tuple(range(s * P, (s + 1) * P)) for s in range(D)])
    return _gather(ctx.mesh, group, P, idx, 0, "dp_pool"), j % P


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
    return _gather(ctx.mesh, group, n, t, dim, "fsdp_gather")


def _fsdp_scatter(ctx: DistCtx, g: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``g`` over the axis,
    in float32."""
    group, _, n = axis_group(ctx.mesh, ctx.fsdp_axis)
    return _sum_block(ctx.mesh, group, n, g, dim, "fsdp_scatter")


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
