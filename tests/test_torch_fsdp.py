"""Fully sharded data parallelism (FSDP) over ``"data"``: the port's cut
of a ``dp_mode="fsdp"`` config against the reference's specs, and its
training and serving steps against the reference's GSPMD steps.

  * ``shard_tree(..., fsdp="data")`` on meta tensors: every leaf of every
    full config (one unit) has, on the first and the last rank of both
    production meshes, the local shape the reference's
    ``param_specs`` implies (each dimension divided by the extents of
    the axes its spec names; the KV leaves by whole KV heads, the port's
    cut; the query-head leaves by the rank's heads of the padded split:
    llama4-maverick's 40 heads at TP 16 padded to 48, so its ``wq`` is
    320 x 384 a rank, its ``wk`` one KV head).
  * ``unshard_tree(shard_tree(x, fsdp="data"))`` is ``x`` for every smoke
    config on (2, 2) and (2, 2, 2) meshes, and an FSDP leaf is a slice on
    its ``d_model`` side.
  * 2 ``train_loop`` steps of command-r-35b and qwen3-moe-235b-a22b at
    their smoke widths in float32 on a (2, 2) ("data", "model") mesh, and
    of qwen3-moe on a (2, 2, 1) ("pod", "data", "model") mesh (its
    experts split over "data", synced over "pod") at capacity factor 16,
    where no token drops, and at 1.25, where tokens drop: the
    reference's GSPMD step dispatches the rows of a "data" block, pooled
    from two ranks, with the capacity of their tokens (its EP
    ``shard_map`` is manual over "data" alone), and the port ranks those
    rows' expert ids pooled so (``runtime.context.pool_ids``); a dispatch
    that ranks each rank's own rows alone keeps other tokens at 1.25,
    against the
    reference's ``build_train_step`` (GSPMD, FSDP on "data") on 4 host
    devices from the same weights: losses within 1e-5 relative, every
    parameter joined from the ranks' slices within 1e-5 (of its leaf's
    largest |entry| where that is above 1); command-r crashed at its last
    step and restarted from each slice's checkpoint
    (``ckpt_dir/fsdp<i>/tp<j>``) ends on the uninterrupted run's slices
    bit for bit.
  * An FSDP prefill and 4 teacher-forced decode steps of command-r on a
    (2, 1) mesh (each data rank its rows and its FSDP slices) within 1e-5
    of one rank's ``prefill`` / ``decode_step`` on the whole tree, and
    ``serve(mesh=...)``'s greedy tokens equal to one rank's; hubert-xlarge
    (its smoke config with ``dp_mode="fsdp"``) through the encoder's
    step on the same mesh within 1e-5 of one rank's forward.

One spawn of 4 gloo ranks (``tests/torch_mesh_workers.py`` kinds
``tp_train`` and ``tp_serve``) beside two reference subprocesses, one a
config.
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config, list_archs
from repro.launch import sharding as JSH
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

ARCHS = list(list_archs())
PROD = {"16x16": ((16, 16), ("data", "model")),
        "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ROUND = {"2x2": ((2, 2), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN = [("command-r-35b", "2x2"), ("qwen3-moe-235b-a22b", "2x2"),
         ("qwen3-moe-235b-a22b", "pod"), ("qwen3-moe-235b-a22b", "pod125")]
TRAIN_MESH = {"2x2": ((2, 2), ("data", "model")),
              "pod": ((2, 2, 1), ("pod", "data", "model")),
              "pod125": ((2, 2, 1), ("pod", "data", "model"))}
RESTART = {("command-r-35b", "2x2")}
# the pod cases' capacity factors: none drops at 16, pairs drop at 1.25
CAPACITY = {"pod": 16.0, "pod125": 1.25}
S, GB, STEPS = 16, 4, 2
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=5, total_steps=100,
           grad_clip=1.0)
TOL = 1e-5
SERVE_ARCH, B, PL, DEC = "command-r-35b", 4, 12, 4
ENCODE_ARCH = "hubert-xlarge"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as ST
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw

arch, meshes, S, gb, steps, opt, out, in_path = json.loads(sys.argv[1])
with open(in_path, "rb") as f:
    weights = pickle.load(f)[arch]
base = dataclasses.replace(get_smoke_config(arch), dtype="float32")
assert base.dp_mode == "fsdp"
opt = adamw.OptConfig(**opt)
shape = ShapeConfig("t", S, gb, "train")
res = {}
for name, kw, cf in meshes:
    cfg = base if cf is None else dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    mesh = make_host_mesh(**kw)
    step, (p_sh, o_sh, b_sh), opt_cfg = ST.build_train_step(
        cfg, mesh, opt_cfg=opt, shape=shape, donate=False)
    params = jax.device_put(jax.tree.map(jnp.asarray, weights), p_sh)
    state = jax.device_put(adamw.init_opt_state(opt_cfg, params), o_sh)
    stream = SyntheticStream(DataConfig(seq_len=S, global_batch=gb, seed=0),
                             cfg)
    losses = []
    for t in range(steps):
        batch = jax.device_put(stream.global_batch(t), b_sh)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    res[name] = (losses, jax.tree.map(np.asarray, params))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _cfg(arch: str, mesh: str = ""):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              dp_mode="fsdp")
    if mesh in CAPACITY:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY[mesh]))
    return model_config_from_fields(dataclasses.asdict(cfg))


def _name(arch: str, mesh: str) -> str:
    return f"{arch}_{mesh}"


def _ref_local_shape(spec, shape, mesh_shape) -> tuple:
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // math.prod(mesh_shape[a] for a in axes))
    return tuple(out)


@pytest.fixture(scope="module")
def ref_units():
    """The reference's abstract params of every full config at one unit
    (its rules read shapes and paths only)."""
    import jax

    from repro.launch import steps as JST
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_units=1)
        out[arch] = JST.abstract_params(cfg)
    return out


@pytest.mark.parametrize("mesh", list(PROD))
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_slices_have_the_reference_shapes(ref_units, arch, mesh):
    import jax
    from jax.sharding import AbstractMesh as JMesh
    shape, axes = PROD[mesh]
    pmesh = SH.AbstractMesh(shape, axes)
    cfg = dataclasses.replace(p_config(arch), n_units=1)
    full = ST.abstract_params(cfg)
    jspecs = JSH.param_specs(get_config(arch), ref_units[arch],
                             JMesh(shape, axes))
    want = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                 PartitionSpec)):
        keys = tuple(k.key for k in path)
        want[keys] = tuple(spec)[1:] if keys[0] == "units" else tuple(spec)
    n_fsdp = 0
    for rank in (0, pmesh.size - 1):
        mine = SH.shard_tree(cfg, full, pmesh, rank=rank, fsdp="data")
        for path, leaf in SH._leaves_with_paths(mine):
            keys = ("units",) + path[2:] if path[0] == "units" else path
            full_leaf = full
            for k in path:
                full_leaf = full_leaf[k]
            spec = want[keys]
            local = _ref_local_shape(spec, tuple(full_leaf.shape),
                                     pmesh.shape)
            if path[-1] in SH.KV_LEAVES:
                _, n_kv = PM.L.kv_block(cfg, 16, pmesh.coord("model", rank))
                d = len(spec) - 1
                local = local[:d] + (n_kv * cfg.hd,)
            if path[-1] in SH.Q_LEAVES and "mixer" in path:
                n_q = len(PM.L.q_heads(cfg, 16, pmesh.coord("model", rank)))
                d = SH.Q_LEAVES[path[-1]] % leaf.dim()
                local = local[:d] + (n_q * cfg.hd,) + local[d + 1:]
            assert tuple(leaf.shape) == local, (path, leaf.shape, local)
            if arch == "llama4-maverick-400b-a17b" and path[-1] == "wq":
                assert tuple(leaf.shape) == (5120 // 16, 384)
            if arch == "llama4-maverick-400b-a17b" and path[-1] == "wk":
                assert leaf.shape[-1] == cfg.hd
            if SH.fsdp_dim(cfg, path, leaf) is not None:
                n_fsdp += 1
    assert (n_fsdp > 0) == (cfg.dp_mode == "fsdp"), n_fsdp


@pytest.mark.parametrize("mesh", list(ROUND))
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_cut_round_trips(arch, mesh):
    shape, axes = ROUND[mesh]
    am = SH.AbstractMesh(shape, axes)
    cfg = p_smoke(arch)
    full = PM.init_params(cfg, torch.Generator().manual_seed(0))
    slices = [SH.shard_tree(cfg, full, am, rank=r, fsdp="data")
              for r in range(am.size)]
    back = SH.unshard_tree(cfg, slices, am)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(full)[0]):
        assert torch.equal(a, b)
    for r, sl in enumerate(slices):
        for path, leaf in SH._leaves_with_paths(sl):
            d = SH.fsdp_dim(cfg, path, leaf)
            if d is None:
                continue
            assert cfg.dp_mode == "fsdp"
            assert leaf.shape[d] == cfg.d_model // 2, (path, leaf.shape)
            assert "data" in SH.cut_axes(cfg, path, leaf, am)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    inputs, weights, cases = {}, {}, []
    for arch in sorted({a for a, _ in TRAIN}):
        cfg = _cfg(arch)
        params = PM.init_params(cfg, torch.Generator().manual_seed(0))
        for i, t in enumerate(tree_flatten(params)[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
        weights[arch] = W.to_reference(params)
    for arch, mesh in TRAIN:
        cases.append(dict(
            kind="tp_train", name=_name(arch, mesh),
            cfg=dataclasses.asdict(_cfg(arch, mesh)), params=f"p/{arch}",
            opt=OPT, seq_len=S, global_batch=GB, steps=STEPS, secure=False,
            restart=(arch, mesh) in RESTART,
            ckpt_dir=str(tmp / f"ckpt-{_name(arch, mesh)}"),
            mesh=TRAIN_MESH[mesh]))
    batch = SyntheticStream(DataConfig(seq_len=PL + DEC, global_batch=B,
                                       seed=0), _cfg(SERVE_ARCH)
                            ).global_batch(0)
    inputs["prompts/tokens"] = batch["tokens"][:, :PL]
    inputs["forced"] = batch["tokens"][:, PL:]
    cases.append(dict(
        kind="tp_serve", name="serve", cfg=dataclasses.asdict(
            _cfg(SERVE_ARCH)), params=f"p/{SERVE_ARCH}", prompts="prompts",
        forced="forced", batch=B, prompt_len=PL, steps=DEC, serve=True,
        fsdp="data", mesh=((2, 1), ("data", "model"))))
    cfg = _cfg(ENCODE_ARCH)
    for i, t in enumerate(tree_flatten(PM.init_params(
            cfg, torch.Generator().manual_seed(1)))[0]):
        inputs[f"p/{ENCODE_ARCH}/{i}"] = t.numpy()
    inputs["frames/frames"] = SyntheticStream(DataConfig(
        seq_len=PL, global_batch=B, seed=0), cfg).global_batch(0)["frames"]
    cases.append(dict(
        kind="tp_serve", name="encode", cfg=dataclasses.asdict(cfg),
        params=f"p/{ENCODE_ARCH}", prompts="frames", batch=B,
        prompt_len=PL, steps=0, serve=False, fsdp="data",
        mesh=((2, 1), ("data", "model"))))
    in_path = str(tmp / "weights.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(weights, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    kw = {"2x2": dict(data=2, model=2), "pod": dict(pod=2, data=2, model=1),
          "pod125": dict(pod=2, data=2, model=1)}
    refs = []
    for arch in sorted({a for a, _ in TRAIN}):
        meshes = [(m, kw[m], CAPACITY.get(m)) for a, m in TRAIN
                  if a == arch]
        out = str(tmp / f"reference-{arch}.pkl")
        arg = json.dumps([arch, meshes, S, GB, STEPS, OPT, out, in_path])
        refs.append((arch, out, subprocess.Popen(
            [sys.executable, "-c", REFERENCE, arg], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    want = {}
    try:
        outs = W.run_job(str(tmp), cases, inputs, 4, timeout_s=240)
        for arch, out, ref in refs:
            stdout, stderr = ref.communicate(timeout=240)
            assert ref.returncode == 0, stdout[-4000:] + stderr[-4000:]
            with open(out, "rb") as f:
                for mesh, v in pickle.load(f).items():
                    want[(arch, mesh)] = v
    finally:
        for _, _, ref in refs:
            ref.kill()
    return outs, want, inputs


@pytest.mark.parametrize("arch,mesh", TRAIN,
                         ids=[_name(a, m) for a, m in TRAIN])
def test_fsdp_steps_match_reference(run, arch, mesh):
    outs, want, _ = run
    name = _name(arch, mesh)
    losses, jparams = want[(arch, mesh)]
    cfg = _cfg(arch, mesh)
    full = model_params_from_numpy(cfg, jparams, "cpu")
    _, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    n = len(tree_flatten(full)[0])
    slices = []
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/losses"], losses, rtol=TOL,
                                   err_msg=f"rank {r}")
        slices.append(rebuild([torch.from_numpy(out[f"{name}/p{i}"])
                               for i in range(n)]))
    am = SH.AbstractMesh(*TRAIN_MESH[mesh])
    # the ranks hold FSDP slices
    cut = [SH.fsdp_dim(cfg, p, leaf) for p, leaf in
           SH._leaves_with_paths(slices[0])]
    assert any(d is not None for d in cut)
    got = tree_flatten(SH.unshard_tree(cfg, slices, am))[0]
    for i, (g, w) in enumerate(zip(got, tree_flatten(full)[0])):
        w = w.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * max(1.0,
                                                  float(np.abs(w).max())),
                                   err_msg=f"{name} leaf {i}")
    if (arch, mesh) in RESTART:
        for out in outs:
            assert int(out[f"{name}/resumed_from"]) == STEPS - 1
            assert bool(out[f"{name}/restart_equal"])


def _by_mesh_rank(outs, name: str, field: str) -> list:
    """A (2, 1) case's field on its mesh ranks 0 and 1 (whichever block
    of the spawn ran it)."""
    got = {}
    for out in outs:
        for r in range(2):
            key = f"{name}/r{r}/{field}"
            if key in out:
                got[r] = out[key]
    return [got[0], got[1]]


def _full(cfg, inputs, arch):
    leaves, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    return rebuild([torch.from_numpy(inputs[f"p/{arch}/{i}"])
                    for i in range(len(leaves))])


def test_fsdp_serve_matches_one_rank(run):
    from repro_torch.launch import serve as SV
    outs, _, inputs = run
    cfg = _cfg(SERVE_ARCH)
    full = _full(cfg, inputs, SERVE_ARCH)
    with torch.no_grad():
        logits, cache = PM.prefill(
            cfg, full, {"tokens": torch.from_numpy(inputs["prompts/tokens"])},
            PL + DEC)
        want = [logits]
        forced = torch.from_numpy(inputs["forced"])
        for i in range(DEC):
            logits, cache = PM.decode_step(cfg, full, cache,
                                           forced[:, i:i + 1], PL + i)
            want.append(logits)
    want = torch.cat(want, dim=1).numpy()
    rows = B // 2
    for r, got in enumerate(_by_mesh_rank(outs, "serve", "logits")):
        np.testing.assert_allclose(got, want[r * rows:(r + 1) * rows],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")
    one = SV.serve(cfg, batch=B, prompt_len=PL, gen=DEC + 1, params=full,
                   device="cpu")
    for got in _by_mesh_rank(outs, "serve", "tokens"):
        np.testing.assert_array_equal(got, one["tokens"])


def test_fsdp_encode_matches_one_rank(run):
    outs, _, inputs = run
    cfg = _cfg(ENCODE_ARCH)
    full = _full(cfg, inputs, ENCODE_ARCH)
    with torch.no_grad():
        want = PM.forward(cfg, full, {"frames": torch.from_numpy(
            inputs["frames/frames"])}).numpy()
    rows = B // 2
    for r, got in enumerate(_by_mesh_rank(outs, "encode", "logits")):
        np.testing.assert_allclose(got, want[r * rows:(r + 1) * rows],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")
