"""End-to-end training driver: data pipeline -> train step (baseline, or
the paper's secure aggregation as the gradient sync) -> checkpoint and
restart.

Counterpart of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 50 --secure --ckpt-dir CKPT [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 8 --secure --ranks 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --steps 8 --secure --ranks 4 --model 2 --device cpu

Saves every ``ckpt_every`` steps, resumes from the latest complete
checkpoint, and survives injected crashes (``runtime.fault``).  With a
mesh of more than one data-parallel rank (``--ranks N``: N gloo ranks of
``runtime.compat.spawn_nodes``, every rank on the same device) each rank
trains on its rows of the global batch, as the reference shards its
batch over the dp axes, and syncs its gradients; with ``--model M`` the
N ranks form a (N / M, M) ("data", "model") mesh and each holds its
tensor-parallel slice of the weights.  Runs on the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.engine import flat_node_id, tree_flatten
from repro_torch.core.plan import AggConfig
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.kernels import backend
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (dp_axes_of, dp_size, make_host_mesh,
                                     single_rank_mesh)
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import compat
from repro_torch.runtime.fault import FailurePlan, StepGuard

# the default secure sync's chunk: 2^22 float32 elements (16 MiB), so
# qwen3-1.7b's 1.72 B gradient elements make ~411 chunks, each a handful
# of launches, where the reference's default 2^16 would make ~26,000
SYNC_CHUNK_ELEMS = 1 << 22


def default_agg(dp_n: int) -> AggConfig:
    """The secure sync's committee when the caller gives none: derive()
    reclamps cluster_size=4 / r=3 to whatever the dp extent supports
    (divisor, odd r <= c), in chunks of SYNC_CHUNK_ELEMS (the pad stream
    runs on across chunks, so the sum is the same for any chunking)."""
    return AggConfig(n_nodes=4, clip=8.0,
                     chunk_elems=SYNC_CHUNK_ELEMS).derive(n_nodes=dp_n)


def _clone(tree):
    leaves, rebuild = tree_flatten(tree)
    return rebuild([t.detach().clone() for t in leaves])


def train_loop(cfg, mesh=None, *, steps: int, shape: ShapeConfig,
               secure: bool = False, agg: Optional[AggConfig] = None,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
               failure_plan: Optional[FailurePlan] = None,
               opt_cfg: Optional[adamw.OptConfig] = None,
               log_every: int = 10, seed: int = 0, device="cuda",
               params=None) -> dict:
    """Returns {"losses", "step_s", "resumed_from", "params",
    "opt_state"}: ``step_s`` is each step's seconds on the host clock,
    from its batch's load to its loss read back (which waits for the
    step's work on the device).

    ``mesh=None`` is one process: the baseline needs no group, the
    secure path runs on a one-rank mesh (``single_rank_mesh``), which
    keeps the mask / quantize / unmask dataflow active.  ``params``
    (copied, not consumed) replaces the seeded init, so a run can start
    from given weights (the reference's, carried across).  The sync's
    kernels follow ``agg.kernel_impl``.  On a mesh each rank keeps its
    slice of the seeded draw (or of ``params``: ``sharding.shard_tree``)
    and its AdamW moments: with an expert axis (an MoE config on more
    than one ``"data"`` rank) its ``E / n_ep`` experts, for a baseline
    run of a ``dp_mode="fsdp"`` config on more than one ``"data"`` rank
    its FSDP slices, with a ``"model"`` axis of more than one rank its
    tensor-parallel slice.  Each distinct slice is checkpointed under
    ``ckpt_dir/ep<i>`` (the expert slice i, with its FSDP slices),
    ``ckpt_dir/fsdp<i>`` (a dense config's FSDP slice i),
    ``ckpt_dir/tp<j>`` (the TP slice j) or both (``ckpt_dir/ep<i>/tp<j>``),
    by the ranks at coordinate 0 of the dp axes other than ``"data"``: a
    restart restores every rank's slice from its own directory, so it
    needs the same split."""
    if secure and mesh is None:
        with single_rank_mesh() as one:
            return train_loop(cfg, one, steps=steps, shape=shape,
                              secure=True, agg=agg, ckpt_dir=ckpt_dir,
                              ckpt_every=ckpt_every,
                              failure_plan=failure_plan, opt_cfg=opt_cfg,
                              log_every=log_every, seed=seed, device=device,
                              params=params)
    dev = backend.resolve_device(device)
    dp_n = dp_size(mesh) if mesh is not None else 1
    dp_rank = flat_node_id(mesh, dp_axes_of(mesh)) if mesh is not None \
        else 0
    if shape.global_batch % dp_n:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {dp_n} dp ranks")

    if secure:
        cfg = dataclasses.replace(cfg, dp_mode="replicated")
        step_fn, opt_cfg = ST.build_secure_train_step(
            cfg, mesh, agg or default_agg(dp_n), opt_cfg=opt_cfg,
            shape=shape)
    else:
        step_fn, opt_cfg = ST.build_train_step(
            cfg, opt_cfg=opt_cfg, shape=shape, mesh=mesh)

    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = M.init_params(cfg, gen)
    else:
        params = _clone(params)
    # on an expert, FSDP or TP axis, this rank's slice of the global
    # draw, and the moments of that slice
    if mesh is not None:
        params = SH.shard_tree(cfg, params, mesh,
                               fsdp=ST.fsdp_axis(cfg, mesh))
    opt_state = adamw.init_opt_state(opt_cfg, params)

    # each data rank holding a slice of its own (experts, FSDP slices)
    # writes a checkpoint of its own tree, once over the other dp axes;
    # where every dp rank holds the same, dp rank 0 writes it
    saver = dp_rank == 0
    sliced = ("ep" if ST.expert_slices(cfg, mesh) > 1 else
              "fsdp" if ST.fsdp_axis(cfg, mesh) else None)
    if ckpt_dir and sliced:
        ckpt_dir = os.path.join(ckpt_dir,
                                f"{sliced}{mesh.coord(ST.EP_AXIS)}")
        saver = all(mesh.coord(a) == 0 for a in dp_axes_of(mesh)
                    if a != ST.EP_AXIS)
    if ckpt_dir and SH.tp_extent(mesh) > 1:
        ckpt_dir = os.path.join(ckpt_dir, f"tp{mesh.coord(ST.TP_AXIS)}")
    start_step = 0
    resumed_from = None
    if ckpt_dir:
        last = CK.latest_step(ckpt_dir)
        if last is not None:
            params = CK.restore(ckpt_dir, last, params)
            opt_state = CK.restore(ckpt_dir + "/opt", last, opt_state)
            start_step = last
            resumed_from = last

    stream = SyntheticStream(
        DataConfig(seq_len=shape.seq_len, global_batch=shape.global_batch,
                   seed=seed), cfg)
    rows = shape.global_batch // dp_n
    losses, step_s = [], []
    for step in range(start_step, steps):
        if failure_plan:
            failure_plan.maybe_crash(step)
        t0 = time.perf_counter()
        # this rank's rows of the global batch (the reference's dp shard)
        batch = {k: torch.from_numpy(
            v[dp_rank * rows:(dp_rank + 1) * rows].copy()).to(dev)
            for k, v in stream.global_batch(step).items()}
        with StepGuard(deadline_s=3600), record_function("train_step"):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if ckpt_dir and (step + 1) % ckpt_every == 0 and saver:
            CK.save(ckpt_dir, step + 1, params)
            CK.save(ckpt_dir + "/opt", step + 1, opt_state)
    return {"losses": losses, "step_s": step_s,
            "resumed_from": resumed_from,
            "params": params, "opt_state": opt_state}


def _rank_main(rank: int, n: int, model: int, runs: list, common: dict,
               out_path: str) -> None:
    mesh = make_host_mesh(data=n // model, model=model)
    results = []
    for run in runs:
        backend.reset_launch_counts()
        out = train_loop(mesh=mesh, **common, **run)
        results.append({"losses": out["losses"],
                        "launches": backend.launch_counts()})
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def run_ranks(n: int, runs: list, timeout_s: float = 600.0,
              model: int = 1, **common) -> list:
    """Spawn ``n`` gloo ranks (``compat.spawn_nodes``) that each run
    ``train_loop(mesh=<the (n / model, model) ("data", "model") mesh>,
    **common, **run)`` for every ``run`` of ``runs`` in turn, and return
    rank 0's ``{"losses", "launches"}`` of each (the launches counted in
    rank 0 during that run)."""
    if n % model:
        raise ValueError(f"{n} ranks do not form a mesh with a 'model' "
                         f"axis of {model}")
    with tempfile.TemporaryDirectory(prefix="repro-train-") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        compat.spawn_nodes(_rank_main, n, n, model, runs, common, out_path,
                           timeout_s=timeout_s)
        with open(out_path) as f:
            return json.load(f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--secure", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo ranks (spawned)")
    ap.add_argument("--model", type=int, default=1,
                    help="of which the 'model' (tensor-parallel) axis")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    t0 = time.time()
    if args.ranks > 1:
        (out,) = run_ranks(args.ranks, [{}], model=args.model, cfg=cfg,
                           steps=args.steps, shape=shape,
                           secure=args.secure, ckpt_dir=args.ckpt_dir,
                           device=args.device)
    else:
        out = train_loop(cfg, steps=args.steps, shape=shape,
                         secure=args.secure, ckpt_dir=args.ckpt_dir,
                         device=args.device)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
