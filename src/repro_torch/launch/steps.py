"""Train steps: the baseline and the secure paper path.

Counterpart of ``repro/launch/steps.py``'s ``build_train_step`` and
``build_secure_train_step``.  In the reference the secure step is a
``shard_map`` manual over the data-parallel axes; here every rank of a
``NodeMesh`` runs the step on its own shard of the batch (the per-rank
body, ``dp_body``):

  1. local loss and gradients (``loss_fn`` normalized by the *global*
     token count, so the sum over ranks is the global mean);
  2. ``tree_allreduce`` of the gradients by the paper's voted cluster
     schedule over the dp axes, with the committee ``agg.derive``'d to
     the dp extent;
  3. the loss summed over the ranks;
  4. the global grad norm of the synced gradients;
  5. ``apply_updates`` with that norm.

Dense configs have no expert-sharded leaves, so every leaf syncs over
every dp axis (the reference's ``_dp_leaf_axes`` reduces to that case;
MoE training, with its expert-sharded leaves and the expert-parallel
backward, waits for its slice: ``ROADMAP.md`` Queue 1; so does the
training of the frontend models, hubert-xlarge and llama-3.2-vision-90b,
refused on any mesh).  The baseline step sums its gradients with a
plain ``all_reduce`` (the reference's GSPMD psum) where the mesh has more
than one dp rank.  Gloo takes host memory, so a CUDA tensor's plain sum
is staged through the host.  The reference's ``input_specs`` /
``abstract_*`` and the prefill / decode builders are left out: the serve
has its own (``launch/serve.py``).
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


def _check_mesh(cfg: ModelConfig, mesh) -> None:
    if cfg.frontend != "none":
        # hubert's head dim of 80 has no flash backward kernel yet
        raise ConfigError(f"training a {cfg.frontend} model ({cfg.name}) is "
                          "not ported yet: it comes with the slice that "
                          "trains the frontend models, with the flash "
                          "backward at head dim 80")
    if mesh is None:
        return
    for ax in mesh.axis_names:
        if ax not in dp_axes_of(mesh) and mesh.shape[ax] != 1:
            raise ConfigError(f"mesh axis {ax!r} of size {mesh.shape[ax]}: "
                              "the port shards nothing but the batch")
    if cfg.moe is not None:
        raise ConfigError("MoE training (expert-sharded leaves) is not "
                          "ported yet")


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
    place."""
    opt_cfg = opt_cfg or adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
    shape = shape or SHAPES["train_4k"]
    total_tokens = shape.global_batch * shape.seq_len
    _check_mesh(cfg, mesh)

    def step(params, opt_state, batch):
        loss, grads = local_grads(cfg, params, batch, total_tokens)
        dp_sum_([loss, *tree_flatten(grads)[0]], mesh)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step, opt_cfg


def build_secure_train_step(cfg: ModelConfig, mesh, agg: AggConfig,
                            opt_cfg: Optional[adamw.OptConfig] = None,
                            shape: Optional[ShapeConfig] = None):
    """The paper's aggregation as the gradient sync: every rank of
    ``mesh`` calls the returned step on its own shard of the batch;
    ``agg.kernel_impl`` picks the sync's kernels.  Returns (step,
    opt_cfg)."""
    opt_cfg = opt_cfg or adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
    shape = shape or SHAPES["train_4k"]
    total_tokens = shape.global_batch * shape.seq_len
    _check_mesh(cfg, mesh)
    dp_axes = dp_axes_of(mesh)
    sync_cfg = agg.derive(n_nodes=dp_size(mesh))

    def step(params, opt_state, batch):
        loss, grads = local_grads(cfg, params, batch, total_tokens)
        with record_function("secure_sync"):
            grads = tree_allreduce(grads, sync_cfg, mesh, dp_axes)
        # per-rank loss is local CE / global tokens: the mean is the sum
        dp_sum_([loss], mesh)
        gnorm = adamw.global_norm(grads)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, grad_norm=gnorm)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step, opt_cfg
