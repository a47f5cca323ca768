"""Training on a (2, 2) ("data", "model") mesh: tensor parallelism over
``"model"`` beside data parallelism, against the reference's steps on a
4-device host mesh.

qwen3-1.7b, mamba2-370m and qwen3-moe-235b (its experts split over
``"data"`` too) at their smoke widths in float32 (``dp_mode``
replicated, as the reference's secure step needs), AdamW as
``tests/test_torch_train_moe_mesh.py`` sets it (eps 1e-3, clipping at
1.0), 2 steps of the synthetic stream's global batches of 4 sequences
of 16 tokens, plain and secure.  The weights are the port's seed-0 draw,
handed to the reference in its layout.  The reference runs its
``build_train_step`` (GSPMD, ``tp_axis="model"``) and
``build_secure_train_step`` (the ``shard_map`` manual over ``"data"``,
auto over ``"model"``) in three subprocesses with
``--xla_force_host_platform_device_count=4``, one a config, beside the
port's one spawn of 4 gloo ranks (``tests/torch_mesh_workers.py``, kind
``tp_train``: ``train_loop`` on the mesh, which cuts each rank's slice
with ``sharding.shard_tree``).  Held: the losses within 1e-5 relative;
every parameter after 2 steps, joined from the 4 ranks' slices by
``sharding.unshard_tree``, within 1e-5 of the reference's (times its
leaf's largest |entry| where that is above 1: a leaf that starts at zero,
as ``dt_bias``, holds entries near 1e-4 after two steps, where one
quantum of the secure sync's fixed-point grid, crossed by float32 noise
between the two packages' gradients, moves an entry by ~2e-9); and for
the secure qwen3 run and the plain qwen3-moe run, a crash at the last
step and a restart from each slice's checkpoint (``ckpt_dir/tp<j>``,
``ckpt_dir/ep<i>/tp<j>``) ending on the uninterrupted run's slices bit
for bit.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.launch import sharding as SH
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = 4
ARCHS = ["qwen3-1.7b", "mamba2-370m", "qwen3-moe-235b-a22b"]
S, GB, STEPS = 16, 4, 2
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=5, total_steps=100,
           grad_clip=1.0)
TOL = 1e-5
RESTART = {("qwen3-1.7b", True), ("qwen3-moe-235b-a22b", False)}
CASES = [(a, sec) for a in ARCHS for sec in (False, True)]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = SH.AbstractMesh((2, 2), ("data", "model"))

REFERENCE = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.plan import AggConfig
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as ST
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw

arch, S, gb, steps, opt, out, in_path = json.loads(sys.argv[1])
with open(in_path, "rb") as f:
    weights = pickle.load(f)[arch]
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                          dp_mode="replicated")
mesh = make_host_mesh(data=2, model=2)
opt = adamw.OptConfig(**opt)
shape = ShapeConfig("t", S, gb, "train")
res = {}
for secure in (False, True):
    if secure:
        agg = AggConfig(n_nodes=4, clip=8.0).derive(n_nodes=2)
        step, (p_sh, o_sh, b_sh), opt_cfg = ST.build_secure_train_step(
            cfg, mesh, agg, opt_cfg=opt, shape=shape, donate=False)
    else:
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
    res[secure] = (losses, jax.tree.map(np.asarray, params))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _cfg(arch: str):
    return model_config_from_fields(dataclasses.asdict(dataclasses.replace(
        get_smoke_config(arch), dtype="float32", dp_mode="replicated")))


def _name(arch: str, secure: bool) -> str:
    return f"{arch}_{'secure' if secure else 'plain'}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    inputs, weights, cases = {}, {}, []
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = PM.init_params(cfg, torch.Generator().manual_seed(0))
        for i, t in enumerate(tree_flatten(params)[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
        weights[arch] = W.to_reference(params)
    for arch, secure in CASES:
        cases.append(dict(
            kind="tp_train", name=_name(arch, secure),
            cfg=dataclasses.asdict(_cfg(arch)), params=f"p/{arch}",
            opt=OPT, seq_len=S, global_batch=GB, steps=STEPS, secure=secure,
            restart=(arch, secure) in RESTART,
            ckpt_dir=str(tmp / f"ckpt-{_name(arch, secure)}"),
            mesh=((2, 2), ("data", "model"))))
    in_path = str(tmp / "weights.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(weights, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    refs = []
    for arch in ARCHS:
        out = str(tmp / f"reference-{arch}.pkl")
        arg = json.dumps([arch, S, GB, STEPS, OPT, out, in_path])
        refs.append((arch, out, subprocess.Popen(
            [sys.executable, "-c", REFERENCE, arg], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    want = {}
    try:
        outs = W.run_job(str(tmp), cases, inputs, RANKS, timeout_s=240)
        for arch, out, ref in refs:
            stdout, stderr = ref.communicate(timeout=240)
            assert ref.returncode == 0, stdout[-4000:] + stderr[-4000:]
            with open(out, "rb") as f:
                for secure, v in pickle.load(f).items():
                    want[(arch, secure)] = v
    finally:
        for _, _, ref in refs:
            ref.kill()
    return outs, want


@pytest.mark.parametrize("arch,secure", CASES,
                         ids=[_name(a, s) for a, s in CASES])
def test_tp_steps_match_reference(run, arch, secure):
    outs, want = run
    name = _name(arch, secure)
    losses, jparams = want[(arch, secure)]
    cfg = _cfg(arch)
    full = model_params_from_numpy(cfg, jparams, "cpu")
    _, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    n = len(tree_flatten(full)[0])
    slices = []
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/losses"], losses, rtol=TOL,
                                   err_msg=f"rank {r}")
        slices.append(rebuild([torch.from_numpy(out[f"{name}/p{i}"])
                               for i in range(n)]))
    got = tree_flatten(SH.unshard_tree(cfg, slices, MESH))[0]
    for i, (g, w) in enumerate(zip(got, tree_flatten(full)[0])):
        w = w.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * max(1.0,
                                                  float(np.abs(w).max())),
                                   err_msg=f"{name} leaf {i}")
    if (arch, secure) in RESTART:
        for out in outs:
            assert int(out[f"{name}/resumed_from"]) == STEPS - 1
            assert bool(out[f"{name}/restart_equal"])
