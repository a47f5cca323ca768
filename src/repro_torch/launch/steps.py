"""Step builders: train (the baseline and the secure paper path),
prefill and decode, and the shape-only stand-ins of every input.

Counterpart of ``repro/launch/steps.py``.  In the reference the secure
step is a ``shard_map`` manual over the data-parallel axes; here every
rank of a ``NodeMesh`` runs the step on its own shard of the batch (the
per-rank body, ``dp_body``):

  1. local loss and gradients (``loss_fn`` normalized by the *global*
     token count, so the sum over ranks is the global mean);
  2. ``tree_allreduce`` of the gradients by the paper's voted cluster
     schedule, one call a group of leaves that sync over the same dp
     axes, each with its committee ``agg.derive``'d to those axes'
     extent;
  3. the loss summed over the ranks;
  4. the global grad norm of the synced gradients;
  5. ``apply_updates`` with that norm.

An MoE config runs both steps under ``DistCtx(mesh, dp_axes,
ep_axis="data")``, as the reference does: each rank holds its ``E /
n_ep`` slice of every expert stack (``sharding.shard_tree``), the tokens
reach the experts through ``runtime.context.all_to_all``, and the
gradient comes back through it; in the baseline step on a ``"pod"``
axis of more than one rank the dispatch drops the pairs that the
reference's GSPMD step drops, ranking the expert ids of a data block
pooled over the pods (``runtime.context.pool_ids``).  A ``dp_mode="fsdp"`` config's baseline
and serving steps also run under ``fsdp_axis="data"``: a rank's FSDP
leaves are slices (``shard_tree(..., fsdp="data")``), gathered where
their unit runs, and their gradients come back reduce-scattered, summed
over ``"data"``.  Each leaf's gradient is then summed over the dp axes
its slice is not cut on (``leaf_sync_axes``, the reference's
``_dp_leaf_axes``): an expert stack or an FSDP slice over the dp axes
other than ``"data"`` (``"pod"``), every other leaf over every dp axis;
and the grad norm sums each leaf's squares over the axes it is cut on.
The baseline step sums its gradients with a plain ``all_reduce`` (the
reference's GSPMD psum) where the mesh has more than one dp rank; the
secure step runs ``tree_allreduce`` once a group of leaves with the same
sync axes, and like the reference's takes its weights replicated over
the dp axes (``dp_mode="replicated"``).  Gloo takes host memory, so a
CUDA tensor's plain sum is staged through the host.

On a mesh with a ``"model"`` axis of more than one rank every step runs
tensor-parallel (TP), as the reference's run with ``tp_axis="model"``:
a rank's parameters are its slice (``launch.sharding.shard_tree``), the
model layers call the TP collectives (``runtime.context``), and every
rank of a model slice computes the same loss.  A leaf's gradient is
then the gradient of the rank's slice (whole on every rank for a
replicated leaf; a zero pad head's dropped, ``local_grads``), so the
gradient sync runs each model slice's own ranks over the dp axes (the
sums, and the secure sync's transport, on the ranks that share this
rank's ``"model"`` coordinate), and the grad
norm sums each leaf's squares over the axes it is cut on (counting a KV
head that ``tp / K`` ranks hold once).

``input_specs`` / ``abstract_params`` / ``abstract_opt_state`` /
``abstract_cache`` give meta tensors of the shapes and dtypes the
reference's ``eval_shape`` gives (the unit leaves one a unit, in a
list).  ``build_prefill_step`` / ``build_decode_step`` return a
callable on this rank's shards and its specs; a rank's KV cache is its
block of positions of every KV head (``sharding.cache_specs``), whose
length ``cache_len`` rounds up to split.
"""
from __future__ import annotations

from typing import Optional

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.engine import tree_allreduce, tree_flatten
from repro_torch.core.plan import AggConfig
from repro_torch.core.schedules import ConfigError
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.compat import subgroup
from repro_torch.runtime.context import DistCtx, get_ctx, tally, use_ctx

EP_AXIS = "data"        # the axis an MoE config splits its experts over
TP_AXIS = SH.TP_AXIS    # the axis TP splits the weights over
META = torch.device("meta")


def _check_mesh(cfg: ModelConfig, mesh) -> None:
    if mesh is None:
        return
    dp = dp_axes_of(mesh)
    for ax in mesh.axis_names:
        if ax not in dp and ax != TP_AXIS and mesh.shape[ax] != 1:
            raise ConfigError(f"mesh axis {ax!r} of size {mesh.shape[ax]}: "
                              "the port shards the batch over the dp axes "
                              f"and the weights over {TP_AXIS!r} only")
    SH.check_tp(cfg, SH.tp_extent(mesh))
    if cfg.moe is None:
        return
    n_ep = expert_slices(cfg, mesh)
    if cfg.moe.n_experts % n_ep:
        raise ConfigError(f"{cfg.moe.n_experts} experts do not split over "
                          f"the {n_ep} ranks of the {EP_AXIS!r} axis")


def expert_slices(cfg: ModelConfig, mesh) -> int:
    """The expert axis's extent (1: every rank holds every expert)."""
    if mesh is None or cfg.moe is None or EP_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[EP_AXIS]


def dist_ctx(cfg: ModelConfig, mesh, sharded_batch: bool = False
             ) -> DistCtx:
    """The context a step's forward runs under: none without a mesh, the
    mesh's dp axes, for an MoE config the expert axis, and the TP axis
    where the mesh has one, with the residual stream cut on the sequence
    over it where ``cfg.seq_parallel`` asks (``models.model.seq_layout``
    leaves a decode step, or a sequence that does not split, whole).
    ``sharded_batch`` marks the reference's GSPMD steps (the baseline
    train step, and serving where the batch splits): there the expert
    dispatch pools a data block's rows over the pods
    (``models.layers.moe_forward``)."""
    if mesh is None:
        return DistCtx()
    ep = EP_AXIS if cfg.moe is not None and EP_AXIS in mesh.axis_names \
        else None
    tp = TP_AXIS if TP_AXIS in mesh.axis_names else None
    return DistCtx(mesh=mesh, dp_axes=dp_axes_of(mesh), ep_axis=ep,
                   tp_axis=tp, sharded_batch=sharded_batch,
                   fsdp_axis=fsdp_axis(cfg, mesh),
                   seq_parallel=cfg.seq_parallel and SH.tp_extent(mesh) > 1)


def fsdp_axis(cfg: ModelConfig, mesh):
    """The axis ``shard_tree`` cuts ``cfg``'s FSDP leaves over on
    ``mesh`` (``"data"`` for a ``dp_mode="fsdp"`` config), or None."""
    return SH.FSDP_AXIS if SH.fsdp_extent(cfg, mesh) > 1 else None


def leaf_sync_axes(cfg: ModelConfig, tree, mesh) -> list[tuple]:
    """For each leaf of a rank's tree (in ``tree_flatten``'s order): the
    dp axes its gradient is summed over, those its slice is not cut on
    (the reference's ``_dp_leaf_axes``, which reads the axis names of the
    leaf's spec: an expert stack names ``"data"`` on any mesh)."""
    dp = dp_axes_of(mesh)
    out = []
    for path, leaf in SH._leaves_with_paths(tree):
        spec = SH._spec_of(cfg, path, leaf.dim(), tuple(leaf.shape), mesh,
                           None)
        used = {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        if SH.fsdp_dim(cfg, path, leaf) is not None:
            used.add(SH.FSDP_AXIS)
        out.append(tuple(a for a in dp if a not in used))
    return out


def expert_leaves(cfg: ModelConfig, tree) -> list[bool]:
    """For each leaf in ``tree_flatten``'s order: is it an expert stack
    (an (E, ...) leaf of an MoE MLP, the reference's ``"mlp"`` leaves of
    three dims, which it splits over ``"data"``)?"""
    if cfg.moe is None:
        return [False] * len(tree_flatten(tree)[0])
    return [("mlp" in path and leaf.dim() == 3)
            for path, leaf in SH._leaves_with_paths(tree)]


def axes_group(mesh, axes: tuple):
    """The group of the ranks that differ from this one only on ``axes``
    (the whole mesh's group where they are all its ranks)."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if n == mesh.size:
        return mesh.group
    return subgroup(mesh, axes, [tuple(range(n))])[0]


def axes_sum_(tensors: list, mesh, axes: tuple) -> None:
    """Sum each tensor over the ranks that differ from this one only on
    ``axes``, in place (one flat ``all_reduce``; staged through the host
    for CUDA tensors on gloo)."""
    if mesh is None or not tensors:
        return
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    wire = flat.cpu() if flat.is_cuda and mesh.backend == "gloo" else flat
    tally("dp_sum", 4 * flat.numel())
    dist.all_reduce(wire, op=dist.ReduceOp.SUM,
                    group=axes_group(mesh, axes))
    flat.copy_(wire)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].reshape(t.shape))
        off += n


def dp_sum_(tensors: list, mesh) -> None:
    """Sum each tensor over the mesh's dp ranks of this rank's model
    slice, in place."""
    if mesh is None:
        return
    axes_sum_(tensors, mesh, dp_axes_of(mesh))


def sync_grads_(cfg: ModelConfig, loss: torch.Tensor, grads, mesh) -> None:
    """The baseline step's sync, in place: each gradient summed over its
    ``leaf_sync_axes`` (one flat ``all_reduce`` a group of leaves with
    the same axes), the loss over every dp axis."""
    if mesh is None:
        return
    groups: dict = {dp_axes_of(mesh): [loss]}
    for g, axes in zip(tree_flatten(grads)[0],
                       leaf_sync_axes(cfg, grads, mesh)):
        groups.setdefault(axes, []).append(g)
    for axes, tensors in groups.items():
        axes_sum_(tensors, mesh, axes)


def grad_norm(cfg: ModelConfig, grads, mesh) -> torch.Tensor:
    """``adamw.global_norm`` of the synced gradients, each leaf's sum of
    squares summed over the axes its slice is cut on (``sharding.
    cut_axes``): an expert stack's and an FSDP slice's over ``"data"``,
    a TP-cut leaf's over ``"model"`` (a KV head held by ``tp / K`` ranks
    counted once); a replicated leaf's once."""
    sq = adamw.leaf_squares(grads)
    if mesh is None:
        return adamw.norm_of_squares(sq)
    tp = SH.tp_extent(mesh)
    kv_share = tp // cfg.n_kv_heads if cfg.n_kv_heads < tp else 1
    groups: dict = {}
    for i, (path, leaf) in enumerate(SH._leaves_with_paths(grads)):
        axes = SH.cut_axes(cfg, path, leaf, mesh)
        if kv_share > 1 and path[-1] in SH.KV_LEAVES and TP_AXIS in axes:
            sq[i] = sq[i] / kv_share
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        part = torch.stack([sq[i] for i in idx])
        axes_sum_([part], mesh, axes)
        for j, i in enumerate(idx):
            sq[i] = part[j]
    return adamw.norm_of_squares(sq)


def local_grads(cfg: ModelConfig, params, batch: dict, total_tokens: int):
    """(loss, gradient tree) of this rank's batch; a zero pad head's
    gradient (``sharding.pad_heads``) is dropped, so no update moves
    it."""
    leaves, rebuild = tree_flatten(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss = M.loss_fn(cfg, params, batch, total_tokens=total_tokens)
        grads = torch.autograd.grad(loss, leaves)
    grads = rebuild(list(grads))
    ctx = get_ctx()
    if ctx.mesh is not None:
        SH.zero_pad_heads_(cfg, grads, ctx.mesh)
    return loss.detach(), grads


def build_train_step(cfg: ModelConfig,
                     opt_cfg: Optional[adamw.OptConfig] = None,
                     shape: Optional[ShapeConfig] = None, mesh=None):
    """Returns (step, opt_cfg); ``step(params, opt_state, batch)`` ->
    (params, opt_state, metrics), the parameters and moments updated in
    place.  On a mesh, ``params`` are this rank's slice
    (``sharding.shard_tree``, for a ``dp_mode="fsdp"`` config with
    ``fsdp=fsdp_axis(cfg, mesh)``; whole FSDP leaves run too)."""
    opt_cfg = opt_cfg or adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
    shape = shape or SHAPES["train_4k"]
    total_tokens = shape.global_batch * shape.seq_len
    _check_mesh(cfg, mesh)
    ctx = dist_ctx(cfg, mesh, sharded_batch=True)

    def step(params, opt_state, batch):
        with use_ctx(ctx):
            loss, grads = local_grads(cfg, params, batch, total_tokens)
        sync_grads_(cfg, loss, grads, mesh)
        gnorm = grad_norm(cfg, grads, mesh)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, grad_norm=gnorm)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step, opt_cfg


def build_secure_train_step(cfg: ModelConfig, mesh, agg: AggConfig,
                            opt_cfg: Optional[adamw.OptConfig] = None,
                            shape: Optional[ShapeConfig] = None):
    """The paper's aggregation as the gradient sync: every rank of
    ``mesh`` calls the returned step on its own shard of the batch (and,
    for an MoE config, its expert slice: ``sharding.shard_tree``);
    ``agg.kernel_impl`` picks the sync's kernels.  The weights are
    replicated over the dp axes whatever ``cfg.dp_mode`` says, as the
    reference's secure step takes them.  Returns (step, opt_cfg)."""
    cfg = dataclasses.replace(cfg, dp_mode="replicated")
    opt_cfg = opt_cfg or adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
    shape = shape or SHAPES["train_4k"]
    total_tokens = shape.global_batch * shape.seq_len
    _check_mesh(cfg, mesh)
    ctx = dist_ctx(cfg, mesh)

    def step(params, opt_state, batch):
        with use_ctx(ctx):
            loss, grads = local_grads(cfg, params, batch, total_tokens)
        leaves, rebuild = tree_flatten(grads)
        # one protocol run a group of leaves with the same sync axes, its
        # committee derived to their extent; an expert stack's gradient
        # is complete on its rank's "data" coordinate
        groups: dict = {}
        for i, axes in enumerate(leaf_sync_axes(cfg, grads, mesh)):
            if axes:
                groups.setdefault(axes, []).append(i)
        with record_function("secure_sync"):
            for axes, idx in groups.items():
                n = math.prod(mesh.shape[a] for a in axes)
                summed = tree_allreduce([leaves[i] for i in idx],
                                        agg.derive(n_nodes=n), mesh, axes)
                for i, t in zip(idx, summed):
                    leaves[i] = t
        grads = rebuild(leaves)
        # per-rank loss is local CE / global tokens: the mean is the sum
        dp_sum_([loss], mesh)
        gnorm = grad_norm(cfg, grads, mesh)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, grad_norm=gnorm)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step, opt_cfg


# ---------------------------------------------------------------------------
# Shape-only stand-ins (the reference's ShapeDtypeStructs)
# ---------------------------------------------------------------------------


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors of every model input of a ``shape`` cell."""
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if shape.kind == "decode":
        out["tokens"] = _meta((B, 1), torch.int32)
    elif cfg.frontend == "audio_frames":
        out["frames"] = _meta((B, S, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        out["media"] = _meta((B, cfg.n_media_tokens, cfg.d_model),
                             torch.float32)
    return out


def abstract_params(cfg: ModelConfig):
    """The full parameter tree as meta tensors: no draw, no memory."""
    return M.init_params(cfg, META)


def abstract_opt_state(cfg: ModelConfig, opt_cfg: adamw.OptConfig):
    return adamw.init_opt_state(opt_cfg, abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    """The full (one-rank) cache of a ``shape`` cell as meta tensors."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, META,
                        media_len=cfg.n_media_tokens)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def serve_ctx(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """(context, the mesh the specs read): the batch split over the dp
    ranks where it splits (``sharding.batch_specs``), else every dp rank
    holding it all, as the reference's GSPMD serve tests it; the KV
    cache cut on its positions over ``sharding.cache_axes``."""
    _check_mesh(cfg, mesh)
    spec_mesh = mesh if mesh is not None else SH.AbstractMesh(
        (1, 1), ("data", TP_AXIS))
    split = SH.batch_splits(shape.global_batch, spec_mesh)
    ctx = dataclasses.replace(
        dist_ctx(cfg, mesh, sharded_batch=split),
        cache_axes=SH.cache_axes(shape.global_batch, spec_mesh))
    return ctx, spec_mesh


def cache_len(max_seq: int, global_batch: int, mesh) -> int:
    """``max_seq`` rounded up to a multiple of the blocks the KV cache is
    cut into on ``mesh`` at ``global_batch`` (the extra positions are
    never valid, so never read)."""
    if mesh is None:
        return max_seq
    n = math.prod(mesh.shape[a] for a in SH.cache_axes(global_batch, mesh)
                  if a in mesh.axis_names)
    return -(-max_seq // n) * n


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       max_seq: int = 0, impl: Optional[str] = None):
    """Returns (step, (param specs, batch specs, cache specs)):
    ``step(params, batch)`` on this rank's parameter slice and batch rows
    -> (last-position logits (B_loc, 1, Vp), this rank's block of the
    cache of ``max_seq`` positions, default the prompt's; a length the
    cut does not divide raises ``ConfigError``); an encoder-only model's
    step is its inference forward -> logits (B_loc, S, Vp), and its
    cache specs are None.  The logits are whole (gathered over
    ``"model"``) on every rank."""
    ctx, spec_mesh = serve_ctx(cfg, mesh, shape)
    pspecs = SH.param_specs(cfg, abstract_params(cfg), spec_mesh)
    bspecs = SH.batch_specs(cfg, shape, spec_mesh)
    if not cfg.decoder:
        def encode(params, batch):
            with use_ctx(ctx):
                return M.forward(cfg, params, batch, impl=impl)
        return encode, (pspecs, bspecs, None)
    max_seq = max_seq or shape.seq_len
    cspecs = SH.cache_specs(cfg, abstract_cache(cfg, shape), shape,
                            spec_mesh)

    def prefill(params, batch):
        with use_ctx(ctx):
            return M.prefill(cfg, params, batch, max_seq, impl=impl)

    return prefill, (pspecs, bspecs, cspecs)


def build_decode_step(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """Returns (step, (param specs, cache specs, token spec)):
    ``step(params, cache, tokens, t)`` -> (logits (B_loc, 1, Vp), cache)
    for one new token a sequence at position ``t`` against this rank's
    block of the cache of ``shape.seq_len`` positions (written in place
    by the rank that holds ``t``'s slot)."""
    ctx, spec_mesh = serve_ctx(cfg, mesh, shape)
    pspecs = SH.param_specs(cfg, abstract_params(cfg), spec_mesh)
    cspecs = SH.cache_specs(cfg, abstract_cache(cfg, shape), shape,
                            spec_mesh)
    tok_spec = SH.batch_specs(cfg, shape, spec_mesh)["tokens"]

    def decode(params, cache, tokens, t):
        with use_ctx(ctx):
            return M.decode_step(cfg, params, cache, tokens, t)

    return decode, (pspecs, cspecs, tok_spec)
