"""Train steps: the baseline and the secure paper path.

Counterpart of ``repro/launch/steps.py``'s ``build_train_step`` and
``build_secure_train_step``.  In the reference the secure step is a
``shard_map`` manual over the data-parallel axes; here every rank of a
``NodeMesh`` runs the step on its own shard of the batch (the per-rank
body, ``dp_body``):

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
n_ep`` slice of every expert stack (``shard_experts``), the tokens
reach the experts through ``runtime.context.all_to_all``, and the
gradient comes back through it.  An expert stack's gradient is then
complete on its rank, so it is not synced (the reference's
``_dp_leaf_axes`` gives it the dp axes other than ``"data"``, and the
port takes an MoE config only on meshes whose other dp axes have one
rank), and the grad norm sums its squares over the dp ranks.  Every
other leaf syncs over every dp axis.  The baseline step sums its
gradients with a plain ``all_reduce`` (the reference's GSPMD psum) where
the mesh has more than one dp rank.  Gloo takes host memory, so a CUDA
tensor's plain sum is staged through the host.  The reference's
``input_specs`` / ``abstract_*`` and the prefill / decode builders are
left out: the serve has its own (``launch/serve.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.engine import tree_allreduce, tree_flatten
from repro_torch.core.plan import AggConfig
from repro_torch.core.schedules import ConfigError
from repro_torch.launch.mesh import dp_axes_of, dp_size
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.context import DistCtx, use_ctx

EP_AXIS = "data"        # the axis an MoE config splits its experts over


def _check_mesh(cfg: ModelConfig, mesh) -> None:
    if mesh is None:
        return
    dp = dp_axes_of(mesh)
    for ax in mesh.axis_names:
        if ax not in dp and mesh.shape[ax] != 1:
            raise ConfigError(f"mesh axis {ax!r} of size {mesh.shape[ax]}: "
                              "the port shards nothing but the batch")
    if cfg.moe is None:
        return
    for ax in dp:
        if ax != EP_AXIS and mesh.shape[ax] != 1:
            raise ConfigError(f"MoE training on dp axis {ax!r} of size "
                              f"{mesh.shape[ax]} is not ported: the experts "
                              f"split over {EP_AXIS!r}, and every other dp "
                              "axis must have one rank")
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
    mesh's dp axes, and for an MoE config the expert axis."""
    if mesh is None:
        return DistCtx()
    ep = EP_AXIS if cfg.moe is not None and EP_AXIS in mesh.axis_names \
        else None
    return DistCtx(mesh=mesh, dp_axes=dp_axes_of(mesh), ep_axis=ep,
                   sharded_batch=sharded_batch)


def _leaf_paths(tree, path: tuple = ()) -> list:
    """Each leaf's key path, in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, path + (i,))]
    return [path]


def expert_leaves(cfg: ModelConfig, tree) -> list[bool]:
    """For each leaf in ``tree_flatten``'s order: is it an expert stack
    (an (E, ...) leaf of an MoE MLP, the reference's ``"mlp"`` leaves of
    three dims, which it splits over ``"data"``)?"""
    if cfg.moe is None:
        return [False] * len(tree_flatten(tree)[0])
    return [("mlp" in path and leaf.dim() == 3)
            for path, leaf in zip(_leaf_paths(tree), tree_flatten(tree)[0])]


def shard_experts(cfg: ModelConfig, tree, mesh):
    """``tree`` (parameters, or moments of the same structure) with each
    full (E, ...) expert stack cut to this rank's ``E / n_ep`` experts
    along the expert axis, as contiguous copies; every other leaf as it
    is.  On one rank, or with no expert axis, the tree itself."""
    n_ep = expert_slices(cfg, mesh)
    if n_ep == 1:
        return tree
    E = cfg.moe.n_experts
    e_loc = E // n_ep
    lo = mesh.coord(EP_AXIS) * e_loc
    leaves, rebuild = tree_flatten(tree)
    return rebuild([t.narrow(0, lo, e_loc).clone()
                    if ex and t.shape[0] == E else t
                    for t, ex in zip(leaves, expert_leaves(cfg, tree))])


def dp_sum_(tensors: list, mesh) -> None:
    """Sum each tensor over the mesh's dp ranks in place (one flat
    ``all_reduce``; staged through the host for CUDA tensors on gloo)."""
    if mesh is None or dp_size(mesh) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    wire = flat.cpu() if flat.is_cuda and mesh.backend == "gloo" else flat
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
    flat.copy_(wire)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].reshape(t.shape))
        off += n


def grad_norm(cfg: ModelConfig, grads, mesh) -> torch.Tensor:
    """``adamw.global_norm`` of the synced gradients, with each expert
    stack's sum of squares also summed over the dp ranks (each holds its
    own slice)."""
    sq = adamw.leaf_squares(grads)
    experts = [i for i, ex in enumerate(expert_leaves(cfg, grads)) if ex]
    if experts:
        part = torch.stack([sq[i] for i in experts])
        dp_sum_([part], mesh)
        for j, i in enumerate(experts):
            sq[i] = part[j]
    return adamw.norm_of_squares(sq)


def local_grads(cfg: ModelConfig, params, batch: dict, total_tokens: int):
    """(loss, gradient tree) of this rank's batch."""
    leaves, rebuild = tree_flatten(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss = M.loss_fn(cfg, params, batch, total_tokens=total_tokens)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), rebuild(list(grads))


def build_train_step(cfg: ModelConfig,
                     opt_cfg: Optional[adamw.OptConfig] = None,
                     shape: Optional[ShapeConfig] = None, mesh=None):
    """Returns (step, opt_cfg); ``step(params, opt_state, batch)`` ->
    (params, opt_state, metrics), the parameters and moments updated in
    place.  On a mesh, an MoE config's ``params`` hold this rank's expert
    slice (``shard_experts``)."""
    opt_cfg = opt_cfg or adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
    shape = shape or SHAPES["train_4k"]
    total_tokens = shape.global_batch * shape.seq_len
    _check_mesh(cfg, mesh)
    ctx = dist_ctx(cfg, mesh, sharded_batch=True)

    def step(params, opt_state, batch):
        with use_ctx(ctx):
            loss, grads = local_grads(cfg, params, batch, total_tokens)
        # an expert stack's gradient is complete on its rank
        dp_sum_([loss] + [g for g, ex in zip(tree_flatten(grads)[0],
                                             expert_leaves(cfg, grads))
                          if not ex], mesh)
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
    for an MoE config, its expert slice: ``shard_experts``);
    ``agg.kernel_impl`` picks the sync's kernels.  Returns (step,
    opt_cfg)."""
    opt_cfg = opt_cfg or adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
    shape = shape or SHAPES["train_4k"]
    total_tokens = shape.global_batch * shape.seq_len
    _check_mesh(cfg, mesh)
    ctx = dist_ctx(cfg, mesh)
    dp_axes = dp_axes_of(mesh)
    sync_cfg = agg.derive(n_nodes=dp_size(mesh))

    def step(params, opt_state, batch):
        with use_ctx(ctx):
            loss, grads = local_grads(cfg, params, batch, total_tokens)
        leaves, rebuild = tree_flatten(grads)
        # an expert stack's gradient is complete on its rank
        synced = [i for i, ex in enumerate(expert_leaves(cfg, grads))
                  if not ex]
        with record_function("secure_sync"):
            summed = tree_allreduce([leaves[i] for i in synced], sync_cfg,
                                    mesh, dp_axes)
        for i, t in zip(synced, summed):
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
