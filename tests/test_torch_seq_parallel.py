"""Sequence parallelism (``seq_parallel=True``): the residual stream cut
on the sequence over ``"model"`` between the mixers and MLPs, against
the reference's steps with the same flag (its stream constrained to
``P(dp, "model", None)`` after every unit).

qwen3-1.7b and mamba2-370m at their smoke widths in float32, on (1, 2)
and (2, 2) ("data", "model") meshes, from the port's seed-0 weights
handed to the reference in its layout:

  * 2 baseline ``train_loop`` steps of the synthetic stream's global
    batches of 4 sequences of 16 tokens (AdamW as
    ``tests/test_torch_tp_train.py`` sets it): the losses within 1e-5
    relative, every parameter joined from the ranks' slices within 1e-5
    (of its leaf's largest |entry| where that is above 1);
  * the prefill of 8 tokens and 4 teacher-forced decode steps of a batch
    of 2: every logit within 1e-5 (atol = rtol) of the reference's, the
    greedy tokens equal, and the prefill's collectives the sequence's
    all-gathers and reduce-scatters (``tp_seq_gather`` /
    ``tp_seq_scatter``), no all-reduce of the stream;
  * with ``remat=True``, one baseline step's loss and gradients (before
    the update; ``tests/torch_mesh_workers.py`` kind ``tp_grads``) on
    (1, 2) at 16 positions and at 15, which do not split (the remat
    backward recomputes each unit in the layout its forward ran in),
    against ``jax.value_and_grad`` of the reference's ``loss_fn``: the
    loss within 1e-5 relative, every gradient leaf joined from the ranks
    within 1e-5 of the tree's largest |gradient| (the tolerance of
    ``tests/test_torch_train_frontends.py``);
  * a prefill of 7 tokens on (1, 2), which does not split over the two
    TP ranks: it runs with the stream whole on both (the layout without
    ``seq_parallel``: ``tp_sum``, no sequence collective; the TP ranks'
    residual streams bit for bit equal), and its logits and 4 decode
    steps match the reference's (whose GSPMD pads the cut; its KV cache,
    which lies over the sequence on ``"model"``, is sized at 8 and 12
    positions there).

The reference runs its ``build_train_step`` / ``build_prefill_step`` /
``build_decode_step`` in two subprocesses (one a config) with 4 forced
host devices, beside the port's one spawn of 4 gloo ranks
(``tests/torch_mesh_workers.py`` kinds ``tp_train`` and ``tp_serve``).
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
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.launch import sharding as SH
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = 4
ARCHS = ["qwen3-1.7b", "mamba2-370m"]
S, GB, STEPS = 16, 4, 2
B, DEC = 2, 4
PROMPTS = {1: (8, 7), 2: (8,)}      # prompt lengths by dp extent
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=5, total_steps=100,
           grad_clip=1.0)
TOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TRAIN = [(a, d) for a in ARCHS for d in (1, 2)]
GRADS = [(a, n) for a in ARCHS for n in (16, 15)]
SERVE = [(a, d, pl) for a in ARCHS for d in (1, 2) for pl in PROMPTS[d]]

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

arch, S, gb, steps, opt, (B, DEC, prompts), out, in_path = \\
    json.loads(sys.argv[1])
with open(in_path, "rb") as f:
    weights, tokens = pickle.load(f)
weights, tokens = weights[arch], tokens[arch]
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                          dp_mode="replicated", seq_parallel=True)
opt = adamw.OptConfig(**opt)
res = {}


def graft(big, small):
    if big.shape == small.shape:
        return small.astype(big.dtype)
    sl = tuple(slice(0, s) for s in small.shape)
    return jnp.zeros_like(big).at[sl].set(small.astype(big.dtype))


for data in (1, 2):
    mesh = make_host_mesh(data=data, model=2)
    shape = ShapeConfig("t", S, gb, "train")
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
    res[("train", data)] = (losses, jax.tree.map(np.asarray, params))
    params = jax.tree.map(jnp.asarray, weights)
    for PL in prompts[str(data)]:
        toks = tokens[:, :PL + DEC]
        # its KV cache lies over the sequence on "model": sized at an
        # even length, the prompt's rounded up, then the decode's
        pre, _ = ST.build_prefill_step(
            cfg, mesh, ShapeConfig("p", PL + PL % 2, B, "prefill"))
        logits0, cache = pre(params, {"tokens": jnp.asarray(toks[:, :PL])})
        n = PL + DEC + (PL + DEC) % 2
        dec, (_, cspecs, _) = ST.build_decode_step(
            cfg, mesh, ShapeConfig("d", n, B, "decode"), donate=False)
        cache = jax.device_put(
            jax.tree.map(graft, M.init_cache(cfg, B, n), cache),
            SH.to_shardings(cspecs, mesh))
        got = [np.asarray(logits0)[:, -1:]]
        for i in range(DEC):
            tok = jnp.asarray(toks[:, PL + i:PL + i + 1])
            logits, cache = dec(params, cache, tok, jnp.int32(PL + i))
            got.append(np.asarray(logits))
        res[("serve", data, PL)] = np.concatenate(got, axis=1)
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _jcfg(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               dp_mode="replicated", seq_parallel=True)


def _cfg(arch: str):
    return model_config_from_fields(dataclasses.asdict(_jcfg(arch)))


def _remat(arch: str):
    return dataclasses.replace(_jcfg(arch), remat=True)


def _grads_name(arch, n):
    return f"grads_{arch}_s{n}"


def _train_name(arch, data):
    return f"train_{arch}@{data}x2"


def _serve_name(arch, data, pl):
    return f"serve_{arch}@{data}x2_p{pl}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_parallel")
    inputs, weights, tokens, cases = {}, {}, {}, []
    for arch in ARCHS:
        params = PM.init_params(_cfg(arch), torch.Generator().manual_seed(0))
        for i, t in enumerate(tree_flatten(params)[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
        weights[arch] = W.to_reference(params)
        tokens[arch] = SyntheticStream(
            DataConfig(seq_len=max(PROMPTS[1]) + DEC, global_batch=B,
                       seed=0), _jcfg(arch)).global_batch(0)["tokens"]
    for arch, n in GRADS:
        name = _grads_name(arch, n)
        batch = SyntheticStream(DataConfig(
            seq_len=n, global_batch=GB, seed=0), _jcfg(arch)).global_batch(0)
        for k in ("tokens", "labels"):
            inputs[f"b/{name}/{k}"] = batch[k]
        cases.append(dict(
            kind="tp_grads", name=name,
            cfg=dataclasses.asdict(model_config_from_fields(
                dataclasses.asdict(_remat(arch)))),
            params=f"p/{arch}", batch=f"b/{name}",
            mesh=((1, 2), ("data", "model"))))
    for data in (1, 2):
        mesh = ((data, 2), ("data", "model"))
        for arch in ARCHS:
            cases.append(dict(
                kind="tp_train", name=_train_name(arch, data),
                cfg=dataclasses.asdict(_cfg(arch)), params=f"p/{arch}",
                opt=OPT, seq_len=S, global_batch=GB, steps=STEPS,
                secure=False, restart=False, ckpt_dir="", mesh=mesh))
            for pl in PROMPTS[data]:
                name = _serve_name(arch, data, pl)
                inputs[f"prompts/{name}/tokens"] = tokens[arch][:, :pl]
                inputs[f"forced/{name}"] = tokens[arch][:, pl:pl + DEC]
                cases.append(dict(
                    kind="tp_serve", name=name,
                    cfg=dataclasses.asdict(_cfg(arch)), params=f"p/{arch}",
                    prompts=f"prompts/{name}", forced=f"forced/{name}",
                    batch=B, prompt_len=pl, steps=DEC, serve=False,
                    mesh=mesh))
    in_path = str(tmp / "reference.in")
    with open(in_path, "wb") as f:
        pickle.dump((weights, tokens), f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    refs = []
    for arch in ARCHS:
        out = str(tmp / f"reference-{arch}.pkl")
        prompts = {str(d): list(v) for d, v in PROMPTS.items()}
        arg = json.dumps([arch, S, GB, STEPS, OPT, (B, DEC, prompts), out,
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
                for key, v in pickle.load(f).items():
                    want[(arch,) + key] = v
    finally:
        for _, _, ref in refs:
            ref.kill()
    return outs, want, inputs


def _rank_fields(outs: list, name: str) -> dict:
    """mesh rank -> {field: value} of one case (a (1, 2) case's fields
    carry their mesh rank; a (2, 2) case's mesh rank is the spawn's)."""
    got: dict = {}
    for r, out in enumerate(outs):
        for key, v in out.items():
            case, rest = key.split("/", 1)
            if case != name:
                continue
            if rest.startswith("r") and "/" in rest:
                i, field = rest.split("/", 1)
                got.setdefault(int(i[1:]), {})[field] = v
            else:
                got.setdefault(r, {})[rest] = v
    return got


@pytest.mark.parametrize("arch,data", TRAIN,
                         ids=[_train_name(a, d) for a, d in TRAIN])
def test_seq_parallel_train_matches_reference(run, arch, data):
    outs, want, _ = run
    losses, jparams = want[(arch, "train", data)]
    cfg = _cfg(arch)
    full = model_params_from_numpy(cfg, jparams, "cpu")
    _, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    n = len(tree_flatten(full)[0])
    got = _rank_fields(outs, _train_name(arch, data))
    assert sorted(got) == list(range(2 * data))
    slices = []
    for r in sorted(got):
        np.testing.assert_allclose(got[r]["losses"], losses, rtol=TOL,
                                   err_msg=f"rank {r}")
        slices.append(rebuild([torch.from_numpy(got[r][f"p{i}"])
                               for i in range(n)]))
    am = SH.AbstractMesh((data, 2), ("data", "model"))
    joined = tree_flatten(SH.unshard_tree(cfg, slices, am))[0]
    for i, (g, w) in enumerate(zip(joined, tree_flatten(full)[0])):
        w = w.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * max(1.0,
                                                  float(np.abs(w).max())),
                                   err_msg=f"{arch} leaf {i}")


@pytest.mark.parametrize("arch,data,pl", SERVE,
                         ids=[_serve_name(*c) for c in SERVE])
def test_seq_parallel_serve_matches_reference(run, arch, data, pl):
    outs, want, _ = run
    ref = want[(arch, "serve", data, pl)]
    vocab = _jcfg(arch).vocab_size
    got = _rank_fields(outs, _serve_name(arch, data, pl))
    assert sorted(got) == list(range(2 * data))
    rows = B // data
    for r, fields in got.items():
        mine = ref[(r // 2) * rows:(r // 2 + 1) * rows]
        np.testing.assert_allclose(fields["logits"], mine, atol=TOL,
                                   rtol=TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            fields["logits"][..., :vocab].argmax(-1),
            mine[..., :vocab].argmax(-1))
        # a prompt that splits: the stream's all-gathers and
        # reduce-scatters, no all-reduce of it (mamba2's gated norm sums
        # its (B, S, 1) squares); else the whole stream, all-reduced
        split = pl % 2 == 0
        assert ("prefill_calls_tp_seq_gather" in fields) == split
        assert ("prefill_calls_tp_seq_scatter" in fields) == split
        assert ("prefill_calls_tp_sum" in fields) == \
            (not split or arch == "mamba2-370m")
    # the TP ranks of a model slice hold one stream where it is whole
    if pl % 2:
        for d in range(data):
            assert str(got[2 * d]["resid_sha"]) == \
                str(got[2 * d + 1]["resid_sha"])


@pytest.mark.parametrize("arch,n", GRADS,
                         ids=[_grads_name(a, n) for a, n in GRADS])
def test_seq_parallel_remat_grads_match_reference(run, arch, n):
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    outs, _, inputs = run
    name = _grads_name(arch, n)
    jcfg = _remat(arch)
    cfg = _cfg(arch)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: jnp.asarray(inputs[f"b/{name}/{k}"])
             for k in ("tokens", "labels")}
    jparams = jax.tree.map(jnp.asarray, W.to_reference(params))
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch, total_tokens=GB * n)))(jparams)
    want = tree_flatten(model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu"))[0]
    _, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    got = _rank_fields(outs, name)
    assert sorted(got) == [0, 1]
    split = n % 2 == 0
    slices = []
    for r in sorted(got):
        np.testing.assert_allclose(got[r]["loss"], float(loss), rtol=TOL,
                                   err_msg=f"rank {r}")
        assert ("calls_tp_seq_gather" in got[r]) == split
        slices.append(rebuild([torch.from_numpy(got[r][f"g{i}"])
                               for i in range(len(want))]))
    am = SH.AbstractMesh((1, 2), ("data", "model"))
    joined = tree_flatten(SH.unshard_tree(cfg, slices, am))[0]
    scale = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(joined, want)):
        w = w.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL * scale,
                                   err_msg=f"{name} leaf {i}")
