"""The padded query-head split: where the ``H`` query heads do not split
over the TP ranks but the KV heads do (``K < tp``), each KV group is
padded with zero heads (``models.layers.q_group``), as the reference
lets GSPMD cut mid-head and pad.

Smoke configs with 6 query and 2 KV heads at TP 4 (groups of 3 padded to
4: 8 heads, 2 a rank, each rank's inside one KV group): qwen3-1.7b's
(qk-norm, tied embeddings) and qwen1.5-110b's (QKV biases, so ``bq``
is padded too; an untied head), float32, on a (1, 4) ("data", "model")
mesh, from the port's seed-0 weights handed to the reference in its
layout.  Held against the reference's GSPMD steps on 4 host devices:

  * 2 baseline ``train_loop`` steps (AdamW as
    ``tests/test_torch_tp_train.py`` sets it): the losses within 1e-5
    relative, every parameter joined from the ranks' slices
    (``unshard_tree``, which returns the unpadded shapes) within 1e-5 of
    its leaf's largest |entry| where that is above 1; and on every rank
    the pad heads' ``wq`` / ``bq`` columns and ``wo`` rows exactly zero
    after the two AdamW steps (their gradient is dropped);
  * the prefill of 8 tokens and 4 teacher-forced decode steps of a batch
    of 2: every logit within 1e-5 (atol = rtol).

Also, on meta tensors, where the padding lies: each rank's heads and the
KV head they read, and the pad counts of the full configs (llama4-
maverick's 8 at TP 16; none where the heads split).
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
from repro.data.pipeline import DataConfig, SyntheticStream
from repro_torch.configs import get_config as p_config
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.launch import sharding as SH
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = TP = 4
ARCHS = ["qwen3-1.7b", "qwen1.5-110b"]
S, GB, STEPS = 16, 4, 2
B, PL, DEC = 2, 8, 4
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=5, total_steps=100,
           grad_clip=1.0)
TOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = SH.AbstractMesh((1, TP), ("data", "model"))

REFERENCE = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import sharding as SH
from repro.launch import steps as ST
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.optim import adamw

arch, S, gb, steps, opt, (B, PL, DEC), out, in_path = json.loads(sys.argv[1])
with open(in_path, "rb") as f:
    weights, tokens = pickle.load(f)
weights, tokens = weights[arch], tokens[arch]
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                          dp_mode="replicated", n_heads=6, n_kv_heads=2)
mesh = make_host_mesh(data=1, model=4)
opt = adamw.OptConfig(**opt)
step, (p_sh, o_sh, b_sh), opt_cfg = ST.build_train_step(
    cfg, mesh, opt_cfg=opt, shape=ShapeConfig("t", S, gb, "train"),
    donate=False)
params = jax.device_put(jax.tree.map(jnp.asarray, weights), p_sh)
state = jax.device_put(adamw.init_opt_state(opt_cfg, params), o_sh)
stream = SyntheticStream(DataConfig(seq_len=S, global_batch=gb, seed=0), cfg)
losses = []
for t in range(steps):
    batch = jax.device_put(stream.global_batch(t), b_sh)
    params, state, m = step(params, state, batch)
    losses.append(float(m["loss"]))
res = {"train": (losses, jax.tree.map(np.asarray, params))}


def graft(big, small):
    if big.shape == small.shape:
        return small.astype(big.dtype)
    sl = tuple(slice(0, s) for s in small.shape)
    return jnp.zeros_like(big).at[sl].set(small.astype(big.dtype))


params = jax.tree.map(jnp.asarray, weights)
pre, _ = ST.build_prefill_step(cfg, mesh, ShapeConfig("p", PL, B, "prefill"))
logits0, cache = pre(params, {"tokens": jnp.asarray(tokens[:, :PL])})
dec, (_, cspecs, _) = ST.build_decode_step(
    cfg, mesh, ShapeConfig("d", PL + DEC, B, "decode"), donate=False)
cache = jax.device_put(
    jax.tree.map(graft, M.init_cache(cfg, B, PL + DEC), cache),
    SH.to_shardings(cspecs, mesh))
got = [np.asarray(logits0)[:, -1:]]
for i in range(DEC):
    tok = jnp.asarray(tokens[:, PL + i:PL + i + 1])
    logits, cache = dec(params, cache, tok, jnp.int32(PL + i))
    got.append(np.asarray(logits))
res["serve"] = np.concatenate(got, axis=1)
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _jcfg(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               dp_mode="replicated", n_heads=6, n_kv_heads=2)


def _cfg(arch: str):
    return model_config_from_fields(dataclasses.asdict(_jcfg(arch)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("head_pad")
    inputs, weights, tokens, cases = {}, {}, {}, []
    mesh = ((1, TP), ("data", "model"))
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = PM.init_params(cfg, torch.Generator().manual_seed(0))
        for i, t in enumerate(tree_flatten(params)[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
        weights[arch] = W.to_reference(params)
        tokens[arch] = SyntheticStream(
            DataConfig(seq_len=PL + DEC, global_batch=B, seed=0),
            _jcfg(arch)).global_batch(0)["tokens"]
        inputs[f"prompts/{arch}/tokens"] = tokens[arch][:, :PL]
        inputs[f"forced/{arch}"] = tokens[arch][:, PL:]
        cases.append(dict(
            kind="tp_train", name=f"train_{arch}",
            cfg=dataclasses.asdict(cfg), params=f"p/{arch}", opt=OPT,
            seq_len=S, global_batch=GB, steps=STEPS, secure=False,
            restart=False, ckpt_dir="", mesh=mesh))
        cases.append(dict(
            kind="tp_serve", name=f"serve_{arch}",
            cfg=dataclasses.asdict(cfg), params=f"p/{arch}",
            prompts=f"prompts/{arch}", forced=f"forced/{arch}", batch=B,
            prompt_len=PL, steps=DEC, serve=False, mesh=mesh))
    in_path = str(tmp / "reference.in")
    with open(in_path, "wb") as f:
        pickle.dump((weights, tokens), f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    refs = []
    for arch in ARCHS:
        out = str(tmp / f"reference-{arch}.pkl")
        arg = json.dumps([arch, S, GB, STEPS, OPT, (B, PL, DEC), out,
                          in_path])
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
                want[arch] = pickle.load(f)
    finally:
        for _, _, ref in refs:
            ref.kill()
    return outs, want


def test_padding_layout():
    cfg = _cfg("qwen3-1.7b")
    assert PM.L.q_group(cfg, TP) == 4 and SH.pad_heads(cfg, TP) == 2
    assert [PM.L.q_heads(cfg, TP, r) for r in range(TP)] == \
        [[0, 1], [2, None], [3, 4], [5, None]]
    assert [PM.L.kv_block(cfg, TP, r) for r in range(TP)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]
    assert SH.pad_heads(p_config("llama4-maverick-400b-a17b"), 16) == 8
    assert SH.pad_heads(p_config("qwen3-moe-235b-a22b"), 16) == 0
    assert SH.pad_heads(p_config("command-r-35b"), 16) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_train_matches_reference(run, arch):
    outs, want = run
    name = f"train_{arch}"
    losses, jparams = want[arch]["train"]
    cfg = _cfg(arch)
    full = model_params_from_numpy(cfg, jparams, "cpu")
    _, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    n = len(tree_flatten(full)[0])
    slices = []
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/losses"], losses, rtol=TOL,
                                   err_msg=f"rank {r}")
        sl = rebuild([torch.from_numpy(out[f"{name}/p{i}"])
                      for i in range(n)])
        heads = PM.L.q_heads(cfg, TP, r)
        for path, leaf in SH._leaves_with_paths(sl):
            d = SH.Q_LEAVES.get(path[-1])
            if d is None:
                continue
            assert leaf.shape[d] == 2 * cfg.hd, (path, leaf.shape)
            for i, h in enumerate(heads):
                if h is None:       # a pad head: exactly zero
                    assert not leaf.narrow(d, i * cfg.hd, cfg.hd).any()
        slices.append(sl)
    got = tree_flatten(SH.unshard_tree(cfg, slices, MESH))[0]
    for i, (g, w) in enumerate(zip(got, tree_flatten(full)[0])):
        w = w.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * max(1.0,
                                                  float(np.abs(w).max())),
                                   err_msg=f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_serve_matches_reference(run, arch):
    outs, want = run
    ref = want[arch]["serve"]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"serve_{arch}/logits"], ref,
                                   atol=TOL, rtol=TOL, err_msg=f"rank {r}")
