"""The port's dry run (``repro_torch.launch.dryrun``), its hillclimb and
its report, on fake process groups in a subprocess (one process is rank
0 of the group; nothing runs on a device).

  * ``make_production_mesh`` gives the reference's (16, 16) ("data",
    "model") and (2, 16, 16) ("pod", "data", "model") meshes over fake
    groups of 256 and 512 ranks.
  * On (2, 2) and (2, 2, 2) meshes, for every smoke config's training
    cell (16 positions, global batch 8): the rank's argument bytes
    (parameters, AdamW moments and batch rows) equal the bytes the
    reference's ``param_specs`` / ``opt_specs`` / ``batch_specs`` imply
    for one device (where the KV heads split evenly, as the port and
    GSPMD then cut alike); for every smoke decoder's decode cell (16
    positions) at global batch 8 and at batch 1 the rank's cache bytes
    equal what the reference's ``cache_specs`` imply (the sequence over
    ``"model"``, at batch 1 over ``("data", "model")``; Mamba2's
    ``conv_B`` / ``conv_C``, which the reference replicates whole, a
    rank's rows), and its decode step runs on the meta tensors.
  * A tensor-parallel prefill's collective bytes equal the analytic
    count: one float32 sum of the (B, S, D) activations for the
    embedding and for each layer's attention and MLP, one gather of the
    last position's vocabulary slice, one all-to-all of the K / V
    cache's blocks a layer.
  * A secure cell's sync bytes equal the plan's executed account
    (``AggPlan.wire_bytes`` over the gradient's chunks).
  * llama4-maverick's prefill at TP 16 traces (its 40 query heads padded
    to 48, 3 a rank) and its record has its terms; the hillclimb's cells
    and tags are the reference's; ``roofline.report`` renders the
    records written, none refused.
  * Importing ``dryrun``, ``hillclimb`` and the ``roofline`` modules
    starts no process group, sets no environment variable and
    initializes no CUDA (the counterpart of
    ``tests/test_tune.py::test_launch_imports_do_not_mutate_xla_flags``).
"""
import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh as JMesh

from repro.configs import get_smoke_config, list_archs
from repro.configs.base import ShapeConfig as JShape
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.optim import adamw as JA
from repro_torch.core.plan import AggConfig, compile_plan
from repro_torch.roofline import report

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCHS = list(list_archs())
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
S, GB = 16, 8
PREFILL = ("qwen3-1.7b", 4, 24)         # arch, batch, prompt on (1, 2)

SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import AggConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime import compat

out_dir, S, GB, prefill = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    json.loads(sys.argv[4])
res = {"meshes": {}, "train": {}, "decode": {}}
for world, mp in ((256, False), (512, True)):
    DR.ensure_fake_group(world)
    m = make_production_mesh(multi_pod=mp)
    res["meshes"][str(world)] = [list(m.axis_names), list(m.shape.values()),
                                 m.rank, list(m.coords(world - 1))]
rec = DR.run_cell("llama4-maverick-400b-a17b", "prefill_32k", False)
res["llama4"] = rec
DR._write(out_dir, "llama4_prefill_32k_16x16", rec)
shape = ShapeConfig("t", S, GB, "train")
for name, (dims, axes) in {"2x2": ((2, 2), ("data", "model")),
                           "2x2x2": ((2, 2, 2),
                                     ("pod", "data", "model"))}.items():
    DR.ensure_fake_group(2 ** len(dims))
    mesh = compat.make_mesh(dims, axes)
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        t = DR.trace(cfg, shape, mesh)
        res["train"][f"{arch}/{name}"] = t["memory"]["argument_bytes"]
        DR._write(out_dir, f"{arch}_t_{name}", {
            "arch": arch, "shape": "t", "mesh": name,
            "t_lower_s": round(t["t_trace_s"], 1), "memory": t["memory"],
            "counted": t["counted"], "useful_flops_ratio": None,
            "terms": DR.RA.roofline_terms(t["counted"])})
        if not cfg.decoder:
            continue
        for gb in (GB, 1):
            # a decode step at a batch that splits and at batch 1: the
            # rank's cache bytes, and the step run on the meta tensors
            step, args, _ = DR.build_cell(
                cfg, ShapeConfig("d", S, gb, "decode"), mesh, False, None)
            res["decode"][f"{arch}/{name}/{gb}"] = DR._bytes([args[1]])
            logits, _ = step(*args)
            assert logits.shape[-1] % 256 == 0
DR.ensure_fake_group(4)
mesh = compat.make_mesh((2, 2), ("data", "model"))
agg = AggConfig(n_nodes=2, cluster_size=1, redundancy=1, chunk_elems=4096)
t = DR.trace(get_smoke_config("olmo-1b"), shape, mesh, secure=True, agg=agg)
res["secure"] = {"sync": t["counted"]["secure_sync"],
                 "collective_bytes": t["counted"]["collective_bytes"]}
DR.ensure_fake_group(2)
mesh = compat.make_mesh((1, 2), ("data", "model"))
arch, B, PL = prefill
t = DR.trace(get_smoke_config(arch), ShapeConfig("p", PL, B, "prefill"), mesh)
res["prefill"] = {"calls": t["counted"]["collective_calls"],
                  "bytes": t["counted"]["collective_bytes"],
                  "kernels": t["counted"]["kernels"]}
res["cuda"] = torch.cuda.is_initialized()
print(json.dumps(res))
"""

IMPORTS = r"""
import os, sys
before = dict(os.environ)
import repro_torch.launch.dryrun
import repro_torch.launch.hillclimb
import repro_torch.roofline.analysis, repro_torch.roofline.counts
import repro_torch.roofline.hw, repro_torch.roofline.report
import torch, torch.distributed as dist
assert dict(os.environ) == before
assert not dist.is_initialized()
assert not torch.cuda.is_initialized()
print("clean")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "dryrun").mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "dryrun"), str(S), str(GB),
         json.dumps(PREFILL)], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), tmp


def test_production_meshes(run):
    res, _ = run
    assert res["meshes"]["256"] == [["data", "model"], [16, 16], 0,
                                    [15, 15]]
    assert res["meshes"]["512"] == [["pod", "data", "model"], [2, 16, 16], 0,
                                    [1, 15, 15]]
    assert res["cuda"] is False


def _implied(abstract, specs, mesh_shape) -> int:
    """Bytes one device holds of a tree under the reference's specs."""
    total = 0
    leaves = jax.tree.leaves(abstract)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        for e in spec:
            for a in (() if e is None else
                      (e if isinstance(e, tuple) else (e,))):
                n //= mesh_shape[a]
        total += n
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_specs(run, arch, mesh):
    res, _ = run
    cfg = get_smoke_config(arch)
    dims, axes = MESHES[mesh]
    if cfg.n_kv_heads % 2:
        pytest.fail(f"{arch}: odd KV heads; the port cuts by whole heads")
    jmesh = JMesh(dims, axes)
    params = JST.abstract_params(cfg)
    opt_cfg = JA.OptConfig(state_dtype=cfg.opt_state_dtype)
    opt = JST.abstract_opt_state(cfg, opt_cfg)
    shape = JShape("t", S, GB, "train")
    pspecs = JSH.param_specs(cfg, params, jmesh)
    mshape = dict(zip(axes, dims))
    want = (_implied(params, pspecs, mshape)
            + _implied(opt, JSH.opt_specs(cfg, opt, pspecs, jmesh), mshape)
            + _implied(JST.input_specs(cfg, shape),
                       JSH.batch_specs(cfg, shape, jmesh), mshape))
    assert res["train"][f"{arch}/{mesh}"] == want
    if not cfg.decoder:
        return
    for gb in (GB, 1):
        dshape = JShape("d", S, gb, "decode")
        cache = JST.abstract_cache(cfg, dshape)
        specs = JSH.cache_specs(cfg, cache, dshape, jmesh)
        # the reference replicates Mamba2's small conv_B / conv_C states
        # whole, over the batch too; a rank of the port holds its rows
        rows = JSH.batch_specs(cfg, dshape, jmesh)["tokens"][0]
        specs = jax.tree_util.tree_map_with_path(
            lambda kp, sp: jax.sharding.PartitionSpec(None, rows, None, None)
            if kp[-1].key in ("conv_B", "conv_C") else sp, specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert res["decode"][f"{arch}/{mesh}/{gb}"] == _implied(
            cache, specs, mshape), gb


def test_tp_prefill_collectives_are_the_analytic_count(run):
    from repro_torch.configs import get_smoke_config as p_smoke
    from repro_torch.models.model import padded_vocab
    res, _ = run
    arch, B, PL = PREFILL
    cfg = p_smoke(arch)
    layers = cfg.n_units * len(cfg.pattern)
    es = 2 if cfg.dtype == "bfloat16" else 4
    assert res["prefill"]["calls"] == {"tp_sum": 1 + 2 * layers,
                                       "tp_cat": 1, "tp_cache_a2a": layers}
    # the relayout: each rank sends its K / 2 heads' K and V, a block of
    # PL / 2 positions to each of the 2 ranks
    assert res["prefill"]["bytes"] == {
        "tp_sum": (1 + 2 * layers) * 4 * B * PL * cfg.d_model,
        "tp_cat": B * (padded_vocab(cfg) // 2) * es,
        "tp_cache_a2a": layers * 2 * B * PL * (cfg.n_kv_heads // 2)
        * cfg.hd * es}
    assert res["prefill"]["kernels"]["flash_attention"]["calls"] == layers


def test_secure_sync_bytes_equal_the_plan(run):
    from repro_torch.configs import get_smoke_config as p_smoke
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    res, _ = run
    cfg = dataclasses.replace(p_smoke("olmo-1b"), dp_mode="replicated")
    mesh = SH.AbstractMesh((2, 2), ("data", "model"))
    elems = sum(t.numel() for t in ST.tree_flatten(SH.shard_tree(
        cfg, ST.abstract_params(cfg), mesh, rank=0))[0])
    agg = AggConfig(n_nodes=2, cluster_size=1, redundancy=1,
                    chunk_elems=4096).derive(n_nodes=2)
    chunks = -(-elems // 4096)
    want = compile_plan(agg).wire_bytes(4096, S=chunks)
    (group,) = res["secure"]["sync"]["groups"]
    assert group["elems"] == elems and group["chunks"] == chunks
    assert res["secure"]["sync"]["bytes_total"] == want > 0
    assert res["secure"]["collective_bytes"]["secure_sync"] == want / 2


def test_llama4_at_tp16_is_refused(run):
    """No longer: llama4-maverick's cell at TP 16 traces on the padded
    split, with its attention's flash calls at 3 heads a rank."""
    res, _ = run
    rec = res["llama4"]
    assert "refused" not in rec
    assert rec["terms"]["dominant"] in ("compute_s", "memory_s",
                                        "collective_s")
    assert rec["counted"]["kernels"]["flash_attention"]["calls"] == 48


def test_hillclimb_cells_and_tags_are_the_reference(run):
    def tags(path):
        text = (ROOT / path).read_text()
        cells = re.findall(r'^\s+"(\w+)": cell_\w+,', text, re.M)
        return cells, re.findall(
            r'"((?:secure_olmo|moe_train|llama4_prefill)_v\d[\w.]*)"', text)
    assert tags("src/repro_torch/launch/hillclimb.py") == \
        tags("src/repro/launch/hillclimb.py")


def test_report_renders_the_records(run):
    _, tmp = run
    text = report.render(str(tmp))
    assert "Estimates:" in text and "no time of the card" in text
    assert "| llama4-maverick-400b-a17b | prefill_32k | 16x16 " in text
    assert "refused" not in text
    for arch in ARCHS:
        assert f"| {arch} | t | 2x2x2 |" in text


def test_imports_touch_nothing():
    proc = subprocess.run([sys.executable, "-c", IMPORTS], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "clean"
