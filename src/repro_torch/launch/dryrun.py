"""Dry run of the production cells: trace one rank's step of every
(architecture x input shape x mesh) cell on meta tensors, count its work
(``roofline.analysis``) and write the roofline terms into
``reports/torch/dryrun/*.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --subprocess

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 forced host devices; here one process
is rank 0 of a fake process group of the mesh's size
(``compat.init_fake_group``: its collectives return at once and move
nothing), holds rank 0's slices of the weights and of the batch as meta
tensors (shapes and dtypes, no data) and runs the port's own step on
them: every rank's shapes are the same.  No kernel launches (each takes
its meta route) and the card is never touched.

A record keeps the reference record's keys: ``t_lower_s`` is the time to
trace, ``t_compile_s`` is None (nothing compiles), ``cost_analysis`` holds
the counter's FLOPs and bytes, ``counted`` (the counter's dict) takes the
place of ``hlo_parsed`` and ``hlo_bytes``, and ``fits_hbm_est`` holds the
rank's arguments plus its peak of temporaries against the card's 80 GB.
Its terms are estimates from datasheet constants (``roofline.hw``), not
measurements.  A secure cell's sync makes host decisions that depend on
the data, so it is not traced: its wire bytes are the plan's ``cost()``
(``schedules.schedule_cost``, the engine's executed account) over the
chunks of the gradient, added to the traced collectives as
``secure_sync``.  Every cell of the ten configs traces on both
production meshes (llama4-maverick's 40 query heads at TP 16 on the
padded split, 48 heads, 3 a rank; a training cell's loss on the logits
cut on the vocabulary).  A cell the port refuses (a ``ConfigError``) is
reported ``refused`` with the error's text; it never runs in another
layout.  Only the CLI and
``run_cell`` start the fake group; importing this module touches no
process group, no environment variable and no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, list_archs, \
    supported_shapes
from repro_torch.core.engine import tree_flatten
from repro_torch.core.plan import AggConfig
from repro_torch.core.schedules import ConfigError, schedule_cost
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import dp_axes_of, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import hw
from repro_torch.runtime import compat
from repro_torch.runtime.context import use_ctx

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "torch", "dryrun")


def ensure_fake_group(world: int) -> None:
    """A fake group of ``world`` ranks with this process as rank 0: the
    one started already, or a new one in place of a fake group of another
    size.  A real group is never replaced."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ConfigError("the dry run needs a fake process group; this "
                              f"process runs a {dist.get_backend()!r} one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    compat.init_fake_group(0, world)


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _rows(tree: dict, shape, mesh) -> dict:
    """This rank's rows of the global batch (every row where the batch
    does not split over the dp ranks)."""
    if not SH.batch_splits(shape.global_batch, mesh):
        return tree
    n = shape.global_batch // SH.dp_extent(mesh)
    i = compat.flat_node_id(mesh, dp_axes_of(mesh))
    return {k: v[i * n:(i + 1) * n] for k, v in tree.items()}


def sync_cost(cfg, grads, mesh, agg: AggConfig) -> dict:
    """The secure sync's wire bytes on this rank's slice of the mesh: per
    group of leaves with the same sync axes, the plan's account
    (``schedule_cost``, as the facade's ``cost()``) of each chunk of
    ``agg.chunk_elems`` elements the engine packs them into."""
    groups: dict = {}
    for g, axes in zip(tree_flatten(grads)[0],
                       ST.leaf_sync_axes(cfg, grads, mesh)):
        if axes:
            groups[axes] = groups.get(axes, 0) + g.numel()
    out = {"bytes_total": 0, "bytes_per_node": 0.0, "groups": []}
    for axes, elems in groups.items():
        n = math.prod(mesh.shape[a] for a in axes)
        a = agg.derive(n_nodes=n)
        chunk = min(a.chunk_elems, elems)
        n_chunks = -(-elems // chunk)
        c = schedule_cost(a.schedule, a.n_clusters, a.cluster_size,
                          a.redundancy, payload_bytes=4 * chunk,
                          digest=a.transport == "digest",
                          digest_bytes=4 * a.digest_words,
                          digest_backup=a.digest_backup)
        total = c["bytes_total"] * n_chunks
        out["groups"].append({"axes": list(axes), "elems": elems,
                              "n_nodes": n, "chunk_elems": chunk,
                              "chunks": n_chunks, "bytes_total": total})
        out["bytes_total"] += total
        out["bytes_per_node"] += total / n
    return out


def build_cell(cfg, shape, mesh, secure: bool = False,
               agg: Optional[AggConfig] = None):
    """(step, args, extra): rank 0's step of the cell and its meta
    arguments; ``extra`` holds the secure sync's cost, or a decode
    cell's cache bytes (the rank's block of the KV cache and its Mamba2
    states).  Raises
    ``ConfigError`` where the port refuses the cell."""
    extra: dict = {}
    if shape.kind == "train":
        if secure:
            cfg = dataclasses.replace(cfg, dp_mode="replicated")
        opt_cfg = adamw.OptConfig(state_dtype=cfg.opt_state_dtype)
        ST._check_mesh(cfg, mesh)
        params = SH.shard_tree(cfg, ST.abstract_params(cfg), mesh,
                               fsdp=ST.fsdp_axis(cfg, mesh))
        state = adamw.init_opt_state(opt_cfg, params)
        batch = _rows(ST.input_specs(cfg, shape), shape, mesh)
        if not secure:
            step, _ = ST.build_train_step(cfg, opt_cfg, shape, mesh)
            return step, (params, state, batch), extra
        extra["secure_sync"] = sync_cost(cfg, params, mesh, agg)
        total = shape.global_batch * shape.seq_len
        ctx = ST.dist_ctx(cfg, mesh)

        def secure_step(params, state, batch):
            # the secure step without its sync (priced by sync_cost)
            with use_ctx(ctx):
                loss, grads = ST.local_grads(cfg, params, batch, total)
            ST.dp_sum_([loss], mesh)
            gnorm = ST.grad_norm(cfg, grads, mesh)
            params, state, metrics = adamw.apply_updates(
                opt_cfg, params, grads, state, grad_norm=gnorm)
            metrics["loss"] = loss
            return params, state, metrics

        return secure_step, (params, state, batch), extra
    if shape.kind == "prefill":
        step, _ = ST.build_prefill_step(cfg, mesh, shape)
        params = SH.shard_tree(cfg, ST.abstract_params(cfg), mesh,
                               fsdp=ST.fsdp_axis(cfg, mesh))
        batch = _rows(ST.input_specs(cfg, shape), shape, mesh)
        return step, (params, batch), extra
    step, _ = ST.build_decode_step(cfg, mesh, shape)
    params = SH.shard_tree(cfg, ST.abstract_params(cfg), mesh,
                           fsdp=ST.fsdp_axis(cfg, mesh))
    tokens = _rows(ST.input_specs(cfg, shape), shape, mesh)["tokens"]
    with use_ctx(ST.serve_ctx(cfg, mesh, shape)[0]):
        cache = M.init_cache(cfg, tokens.shape[0], shape.seq_len,
                             ST.META, media_len=cfg.n_media_tokens)
    extra["cache_bytes"] = _bytes(cache)
    return step, (params, cache, tokens, shape.seq_len - 1), extra


def trace(cfg, shape, mesh, secure: bool = False,
          agg: Optional[AggConfig] = None) -> dict:
    """Build and trace rank 0's step of a cell: the counted work, the
    memory and the seconds."""
    t0 = time.time()
    step, args, extra = build_cell(cfg, shape, mesh, secure, agg)
    arg_bytes = _bytes(list(args))
    arg_storages = {t.untyped_storage()._cdata for t in _tensors(list(args))}
    out, counted = RA.count(step, *args)
    if "secure_sync" in extra:
        sync = extra["secure_sync"]
        counted["secure_sync"] = sync
        counted["collective_bytes"]["secure_sync"] = sync["bytes_per_node"]
        counted["collective_bytes_total"] += sync["bytes_per_node"]
    outs = _tensors(list(out) if isinstance(out, tuple) else out)
    alias = sum(t.numel() * t.element_size() for t in outs
                if t.untyped_storage()._cdata in arg_storages)
    out_bytes = sum(t.numel() * t.element_size() for t in outs) - alias
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": counted["peak_live_bytes"], "alias_bytes": alias,
              "fits_hbm_est": (arg_bytes + counted["peak_live_bytes"])
              < hw.HBM_BYTES}
    if "cache_bytes" in extra:
        memory["cache_bytes"] = extra["cache_bytes"]
    return {"counted": counted, "t_trace_s": time.time() - t0,
            "memory": memory}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             secure: bool = False, agg_overrides: Optional[dict] = None,
             quiet: bool = False) -> dict:
    """The record of one cell on the production mesh, over a fake group
    of its size.  A refused cell's record has ``refused``: the
    ``ConfigError`` text."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ensure_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    agg_kw = {}
    if secure:
        dp_n = math.prod(mesh.shape[a] for a in dp_axes_of(mesh))
        agg_kw = dict(n_nodes=dp_n, cluster_size=4, redundancy=3)
        agg_kw.update(agg_overrides or {})
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
           "secure": secure,
           "agg": agg_overrides or ({} if not secure else
                                    {"cluster_size": 4, "redundancy": 3}),
           "n_chips": n_chips}
    try:
        t = trace(cfg, shape, mesh, secure,
                  AggConfig(**agg_kw) if secure else None)
    except ConfigError as e:
        rec["refused"] = str(e)
        return rec
    counted = t["counted"]
    terms = RA.roofline_terms(counted)
    model_fl = RA.model_flops_per_step(cfg, shape)
    model_fl_dev = model_fl / n_chips
    rec.update({
        "t_lower_s": round(t["t_trace_s"], 1), "t_compile_s": None,
        "memory": t["memory"],
        "cost_analysis": {"flops": counted["flops"],
                          "bytes_accessed": counted["hbm_bytes"]},
        "counted": counted,
        "model_flops_global": model_fl,
        "model_flops_per_device": model_fl_dev,
        "useful_flops_ratio": (model_fl_dev / counted["flops"]
                               if counted["flops"] else None),
        "terms": terms,
    })
    if not quiet:
        print({"flops": counted["flops"], "hbm_bytes": counted["hbm_bytes"],
               "collective_bytes": counted["collective_bytes"],
               "peak_live_bytes": counted["peak_live_bytes"]})
    return rec


def cell_list() -> list[tuple[str, str]]:
    return [(arch, s) for arch in list_archs()
            for s in supported_shapes(get_config(arch))]


def summary(name: str, rec: dict) -> str:
    if "refused" in rec:
        return f"[refused] {name}: {rec['refused']}"
    t = rec["terms"]
    return (f"[OK] {name}: dominant={t['dominant']} "
            f"compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
            f"collective={t['collective_s']:.4f}s "
            f"useful={rec['useful_flops_ratio']} "
            f"trace={rec['t_lower_s']}s (estimates: datasheet constants)")


def _write(out_dir: str, name: str, rec: dict) -> None:
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--secure", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh process")
    ap.add_argument("--out-dir", default=REPORT_DIR)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    if not args.all:
        assert args.arch and args.shape
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.secure)
        name = f"{args.arch}_{args.shape}_{rec['mesh']}" + \
            ("_secure" if args.secure else "")
        _write(args.out_dir, name, rec)
        print(summary(name, rec))
        print(f"torch.cuda.is_initialized() = {torch.cuda.is_initialized()}")
        return

    failures = []
    for arch, shape in cell_list():
        for mp in (False, True):
            name = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
            out = os.path.join(args.out_dir, name + ".json")
            if os.path.exists(out):
                print(f"[skip] {name} (cached)")
                continue
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--out-dir", args.out_dir]
                if mp:
                    cmd.append("--multi-pod")
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=3600)
                ok = r.returncode == 0 and os.path.exists(out)
                print(r.stdout.strip().splitlines()[-1] if ok
                      else f"[FAIL] {name}")
                if not ok:
                    failures.append(name)
                    print(r.stdout[-2000:])
                    print(r.stderr[-3000:])
                continue
            try:
                rec = run_cell(arch, shape, mp, quiet=True)
                _write(args.out_dir, name, rec)
                print(summary(name, rec), flush=True)
            except Exception:
                failures.append(name)
                print(f"[FAIL] {name}")
                traceback.print_exc()
    print(f"\n{len(failures)} failures: {failures}")
    print(f"torch.cuda.is_initialized() = {torch.cuda.is_initialized()}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
