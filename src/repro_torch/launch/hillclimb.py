"""Hillclimb: trace and count named variants of the three chosen
cells on the production mesh and write their records into
``reports/torch/perf/``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell secure_olmo
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe_train

Counterpart of ``repro/launch/hillclimb.py``: the same three ``CELLS``,
the same variant tags and config edits, each variant's rank 0 step traced
on meta tensors and counted by ``roofline.analysis`` (``analyze_custom``)
in place of the reference's lowering and HLO parse.  The reference's
``force_host_devices`` has no counterpart: the dry run's fake process
group (``dryrun.ensure_fake_group``, started by ``main`` and the cells,
never at import) stands for the mesh's devices.  ``PERF_DIR`` is the
port's own, so its records never overwrite the reference's under
``reports/perf/``.  llama4-maverick's v0-v3 run its 40 query heads at
TP 16 on the padded split (48 heads, the zero ones dropped), v3 with
the residual stream cut on the sequence (``seq_parallel``); v4 sets 48
real heads.  A variant the port refuses is recorded ``refused`` with the
``ConfigError`` text.  The terms are estimates from the H100's datasheet
constants, not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.plan import AggConfig
from repro_torch.core.schedules import ConfigError
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis as RA

PERF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "reports", "torch", "perf")


def analyze_custom(cfg, shape, mesh, build_fn, tag):
    """Trace what ``build_fn()`` returns (``(step, args, extra)``, as
    ``dryrun.build_cell``) and write its record."""
    t0 = time.time()
    rec = {"tag": tag, "arch": cfg.name, "shape": shape.name}
    try:
        step, args, extra = build_fn()
    except ConfigError as e:
        rec["refused"] = str(e)
        print(f"[{tag}] refused: {e}")
        return _save(rec)
    arg_bytes = DR._bytes(list(args))
    _, counted = RA.count(step, *args)
    if "secure_sync" in extra:
        sync = extra["secure_sync"]
        counted["secure_sync"] = sync
        counted["collective_bytes"]["secure_sync"] = sync["bytes_per_node"]
        counted["collective_bytes_total"] += sync["bytes_per_node"]
    terms = RA.roofline_terms(counted)
    mf = RA.model_flops_per_step(cfg, shape) / mesh.size
    rec.update({
        "terms": terms, "counted": counted,
        "useful_flops_ratio": mf / counted["flops"]
        if counted["flops"] else None,
        "temp_bytes": counted["peak_live_bytes"],
        "argument_bytes": arg_bytes,
        "t_total_s": round(time.time() - t0, 1),
    })
    t = terms
    print(f"[{tag}] dom={t['dominant']} comp={t['compute_s']:.4f} "
          f"mem={t['memory_s']:.4f} coll={t['collective_s']:.4f} "
          f"coll_bytes={counted['collective_bytes_total']:.3e} "
          f"temp={counted['peak_live_bytes'] / 2 ** 30:.1f}GiB "
          "(estimates)")
    return _save(rec)


def _save(rec: dict) -> dict:
    os.makedirs(PERF_DIR, exist_ok=True)
    with open(os.path.join(PERF_DIR, rec["tag"] + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _mesh():
    DR.ensure_fake_group(256)
    return make_production_mesh(multi_pod=False)


def cell_secure_olmo():
    """Paper-representative cell: olmo-1b train_4k under the secure
    aggregation step; iterate schedule/transport/masking/cluster shape."""
    mesh = _mesh()
    cfg = dataclasses.replace(get_config("olmo-1b"), dp_mode="replicated")
    shape = SHAPES["train_4k"]

    variants = [
        # (tag, agg kwargs) — v0 is the paper-faithful ring/full/global
        ("secure_olmo_v0_ring_full_global",
         dict(schedule="ring", transport="full", masking="global")),
        ("secure_olmo_v1_tree_full_global",
         dict(schedule="tree", transport="full", masking="global")),
        ("secure_olmo_v2_butterfly_full_global",
         dict(schedule="butterfly", transport="full", masking="global")),
        ("secure_olmo_v3_butterfly_digest_global",
         dict(schedule="butterfly", transport="digest", masking="global")),
        ("secure_olmo_v4_butterfly_digest_pairwise",
         dict(schedule="butterfly", transport="digest", masking="pairwise")),
        ("secure_olmo_v5_ring_digest_pairwise",
         dict(schedule="ring", transport="digest", masking="pairwise")),
        ("secure_olmo_v6_c8_butterfly_digest_pairwise",
         dict(schedule="butterfly", transport="digest", masking="pairwise",
              cluster_size=8)),
    ]
    for tag, kw in variants:
        kw.setdefault("cluster_size", 4)
        agg = AggConfig(n_nodes=16, redundancy=3, clip=8.0, **kw)

        def build(agg=agg):
            return DR.build_cell(cfg, shape, mesh, secure=True, agg=agg)

        analyze_custom(cfg, shape, mesh, build, tag)


def cell_moe_train():
    """Worst memory cell: qwen3-moe train_4k; iterate MoE dispatch knobs."""
    mesh = _mesh()
    shape = SHAPES["train_4k"]
    base = get_config("qwen3-moe-235b-a22b")

    variants = [
        ("moe_train_v0_baseline", base),
        ("moe_train_v1_cf1.0",
         dataclasses.replace(base, moe=dataclasses.replace(
             base.moe, capacity_factor=1.0))),
        ("moe_train_v2_cf1.0_seqchunk",
         dataclasses.replace(base, moe=dataclasses.replace(
             base.moe, capacity_factor=1.0), moe_seq_chunks=4)),
        ("moe_train_v3_cf1.0_fp8",
         dataclasses.replace(base, moe=dataclasses.replace(
             base.moe, capacity_factor=1.0,
             dispatch_dtype="float8_e4m3fn"))),
        ("moe_train_v4_cf1.0_fp8_seqchunk2",
         dataclasses.replace(base, moe=dataclasses.replace(
             base.moe, capacity_factor=1.0,
             dispatch_dtype="float8_e4m3fn"), moe_seq_chunks=2)),
    ]
    for tag, cfg in variants:
        def build(cfg=cfg):
            return DR.build_cell(cfg, shape, mesh)
        analyze_custom(cfg, shape, mesh, build, tag)


def cell_llama4_prefill():
    """Most collective-bound cell: llama4 prefill_32k; iterate EP knobs."""
    mesh = _mesh()
    shape = SHAPES["prefill_32k"]
    base = get_config("llama4-maverick-400b-a17b")
    variants = [
        ("llama4_prefill_v0_baseline", base),
        ("llama4_prefill_v1_cf1.0",
         dataclasses.replace(base, moe=dataclasses.replace(
             base.moe, capacity_factor=1.0))),
        ("llama4_prefill_v2_fp8_dispatch",
         dataclasses.replace(base, moe=dataclasses.replace(
             base.moe, capacity_factor=1.0,
             dispatch_dtype="float8_e4m3fn"))),
        ("llama4_prefill_v3_seq_parallel",
         dataclasses.replace(base, seq_parallel=True,
                             moe=dataclasses.replace(
                                 base.moe, capacity_factor=1.0))),
        # 40 q-heads don't divide TP=16: v0-v3 pad each KV group with
        # zero heads; here 48 real heads (+20% attention flops, 3 a rank).
        ("llama4_prefill_v4_headpad48",
         dataclasses.replace(base, n_heads=48,
                             moe=dataclasses.replace(
                                 base.moe, capacity_factor=1.0))),
    ]
    for tag, cfg in variants:
        def build(cfg=cfg):
            return DR.build_cell(cfg, shape, mesh)
        analyze_custom(cfg, shape, mesh, build, tag)


CELLS = {
    "secure_olmo": cell_secure_olmo,
    "moe_train": cell_moe_train,
    "llama4_prefill": cell_llama4_prefill,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    args = ap.parse_args()
    CELLS[args.cell]()


if __name__ == "__main__":
    main()
