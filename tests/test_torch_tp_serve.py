"""The tensor-parallel serve against the reference's sharded serve.

Every smoke config in float32 (an MoE config at a capacity factor of 16,
as ``tests/test_torch_serve.py`` runs it) on a (1, 2) ("data", "model")
mesh, and qwen3-1.7b, mamba2-370m and qwen3-moe-235b on (2, 2) (the
batch of 2 split over the dp ranks; qwen3-moe's experts split over
``"data"`` beside TP), plus qwen3-1.7b with one KV head at (1, 2), the
case where a KV head is held by both TP ranks.  The weights are the
port's seed-0 draw (``init_params``), handed to the reference in its
layout (the unit leaves stacked), so that neither side spends its time
on the other's init; each rank cuts its slice
(``sharding.shard_tree``).

The reference runs its ``build_prefill_step`` / ``build_decode_step``
(GSPMD over a host mesh of the same shape) in a subprocess with
``--xla_force_host_platform_device_count=4``, beside the port's one
spawn of 4 gloo ranks (``tests/torch_mesh_workers.py``, kind
``tp_serve``; a (1, 2) case runs on one of two 2-rank groups).  Both
prefill the stream's prompts of 8 tokens (hubert: its forward over 8
frames) and then decode 4 steps fed the same tokens, the stream's next
4 (teacher forcing, so that no flip compounds).  Held:

  * every logit within the float32 tolerances of
    ``tests/test_torch_models.py``, the companion of
    ``tests/test_torch_serve.py``: 2e-4 for the prefill (and hubert's
    forward), 5e-4 for the decode steps (atol = rtol);
  * each step's greedy token equal to the reference's;
  * the router's ids and the residual stream (every unit's output) bit
    for bit equal on the TP ranks of a model slice;
  * ``serve`` on the mesh (qwen3 at both shapes, mamba2 and qwen3-moe at
    (2, 2)): its greedy tokens, gathered over the dp ranks, equal the
    reference's greedy decode on its mesh, as its ``serve`` runs it (the
    reference's ``serve`` itself hands its grown cache to the decode step
    without the step's shardings, which jit refuses on a ``"model"``
    axis of 2, so the script places it first).
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

from repro.configs import get_smoke_config, list_archs
from repro.data.pipeline import DataConfig, SyntheticStream
from repro_torch.convert import model_config_from_fields
from repro_torch.core.engine import tree_flatten
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = 4
B, PL, STEPS = 2, 8, 4
PREFILL_TOL, DECODE_TOL = 2e-4, 5e-4
ONE_KV = "qwen3-1.7b-kv1"
WIDE = ("qwen3-1.7b", "mamba2-370m", "qwen3-moe-235b-a22b")
SERVED = {("qwen3-1.7b", 1), ("qwen3-1.7b", 2), ("mamba2-370m", 2),
          ("qwen3-moe-235b-a22b", 2)}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _jcfg(arch: str):
    base = "qwen3-1.7b" if arch == ONE_KV else arch
    cfg = dataclasses.replace(get_smoke_config(base), dtype="float32")
    if arch == ONE_KV:
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


ARCHS = list(list_archs()) + [ONE_KV]
CASES = [(a, 1) for a in ARCHS] + [(a, 2) for a in WIDE]


def _name(arch: str, data: int) -> str:
    return f"{arch}@{data}x2"


# the reference's cells over three subprocesses side by side (jamba's
# compile alone takes a third of the whole)
REF_GROUPS = [
    [("jamba-v0.1-52b", 1), ("olmo-1b", 1), ("hubert-xlarge", 1)],
    [("command-r-35b", 1), ("llama-3.2-vision-90b", 1),
     ("llama4-maverick-400b-a17b", 1), ("mamba2-370m", 1),
     ("qwen1.5-110b", 1)],
    [("qwen3-1.7b", 1), ("qwen3-moe-235b-a22b", 1), (ONE_KV, 1),
     ("qwen3-1.7b", 2), ("mamba2-370m", 2), ("qwen3-moe-235b-a22b", 2)]]

REFERENCE = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import sharding as SH
from repro.launch import steps as ST
from repro.launch.mesh import make_host_mesh
from repro.models import model as M

out_path, in_path, cases, served, one_kv, (B, PL, STEPS) = \\
    json.loads(sys.argv[1])
with open(in_path, "rb") as f:
    prompts, forced, weights = pickle.load(f)


def jcfg(arch):
    # test_torch_tp_serve._jcfg
    base = "qwen3-1.7b" if arch == one_kv else arch
    cfg = dataclasses.replace(get_smoke_config(base), dtype="float32")
    if arch == one_kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


def graft(big, small):
    if big.shape == small.shape:
        return small.astype(big.dtype)
    sl = tuple(slice(0, s) for s in small.shape)
    return jnp.zeros_like(big).at[sl].set(small.astype(big.dtype))


def greedy(cfg, logits):
    return jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None] \\
        .astype(jnp.int32)


res = {}
for arch, data in cases:
    cfg = jcfg(arch)
    mesh = make_host_mesh(data=data, model=2)
    params = jax.tree.map(jnp.asarray, weights[arch])
    batch = {k: jnp.asarray(v) for k, v in prompts[arch].items()}
    pre, _ = ST.build_prefill_step(cfg, mesh,
                                   ShapeConfig("p", PL, B, "prefill"))
    if not cfg.decoder:
        res[(arch, data)] = {"logits": np.asarray(pre(params, batch))}
        continue
    logits0, cache = pre(params, batch)
    # the serve's growth of the prompt-length cache, placed as the decode
    # step takes it
    dec, (_, cspecs, _) = ST.build_decode_step(
        cfg, mesh, ShapeConfig("d", PL + STEPS, B, "decode"),
        donate=False)
    cache0 = jax.device_put(
        jax.tree.map(graft, M.init_cache(cfg, B, PL + STEPS,
                                         media_len=cfg.n_media_tokens),
                     cache), SH.to_shardings(cspecs, mesh))
    got, cache = [np.asarray(logits0)[:, -1:]], cache0
    for i in range(STEPS):
        tok = jnp.asarray(forced[arch][:, i:i + 1])
        logits, cache = dec(params, cache, tok, jnp.int32(PL + i))
        got.append(np.asarray(logits))
    out = {"logits": np.concatenate(got, axis=1)}
    if [arch, data] in served:
        # the reference's serve: greedy from the prefill's last logits
        tok, cache, toks = greedy(cfg, logits0), cache0, []
        toks.append(np.asarray(tok))
        for i in range(STEPS):
            logits, cache = dec(params, cache, tok, jnp.int32(PL + i))
            tok = greedy(cfg, logits)
            toks.append(np.asarray(tok))
        out["tokens"] = np.concatenate(toks, axis=1)
    res[(arch, data)] = out
with open(out_path, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE DONE")
"""


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    inputs, prompts, forced, weights, cases = {}, {}, {}, {}, []
    for arch in ARCHS:
        jcfg = _jcfg(arch)
        pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
        params = PM.init_params(pcfg, torch.Generator().manual_seed(0))
        for i, t in enumerate(tree_flatten(params)[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
        weights[arch] = W.to_reference(params)
        # the stream at PL + STEPS positions: the prompt, then the tokens
        # both sides feed the decode steps
        batch = SyntheticStream(DataConfig(seq_len=PL + STEPS,
                                           global_batch=B, seed=0),
                                jcfg).global_batch(0)
        prompts[arch] = {k: (v[:, :PL] if k in ("tokens", "frames") else v)
                         for k, v in batch.items() if k != "labels"}
        if jcfg.decoder:
            forced[arch] = batch["tokens"][:, PL:PL + STEPS]
            inputs[f"forced/{arch}"] = forced[arch]
        for k, v in prompts[arch].items():
            inputs[f"prompts/{arch}/{k}"] = v
    for data in (1, 2):
        for arch, d in CASES:
            if d != data:
                continue
            pcfg = model_config_from_fields(dataclasses.asdict(_jcfg(arch)))
            cases.append(dict(
                kind="tp_serve", name=_name(arch, data),
                cfg=dataclasses.asdict(pcfg), params=f"p/{arch}",
                prompts=f"prompts/{arch}", forced=f"forced/{arch}",
                batch=B, prompt_len=PL, steps=STEPS,
                serve=(arch, data) in SERVED,
                mesh=((data, 2), ("data", "model"))))
    assert sorted(c for g in REF_GROUPS for c in g) == sorted(CASES)
    in_path = str(tmp / "reference.in")
    with open(in_path, "wb") as f:
        pickle.dump((prompts, forced, weights), f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    refs = []
    for g, group in enumerate(REF_GROUPS):
        out = str(tmp / f"reference{g}.pkl")
        arg = json.dumps([out, in_path, group, sorted(SERVED), ONE_KV,
                          (B, PL, STEPS)])
        refs.append((out, subprocess.Popen(
            [sys.executable, "-c", REFERENCE, arg], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    want = {}
    try:
        outs = W.run_job(str(tmp), cases, inputs, RANKS, timeout_s=240)
        for out, ref in refs:
            stdout, stderr = ref.communicate(timeout=240)
            assert ref.returncode == 0, stdout[-4000:] + stderr[-4000:]
            with open(out, "rb") as f:
                want.update(pickle.load(f))
    finally:
        for _, ref in refs:
            ref.kill()
    return outs, want


@pytest.mark.parametrize("arch,data", CASES,
                         ids=[_name(a, d) for a, d in CASES])
def test_tp_serve_matches_reference(run, arch, data):
    outs, want = run
    got = _rank_fields(outs, _name(arch, data))
    assert sorted(got) == list(range(2 * data))
    ref = want[(arch, data)]["logits"]
    vocab = _jcfg(arch).vocab_size
    rows = B // data
    for r, fields in got.items():
        lo = (r // 2) * rows            # this rank's rows of the batch
        mine = ref[lo:lo + rows]
        logits = fields["logits"]
        assert logits.shape == mine.shape, (r, logits.shape, mine.shape)
        if not _jcfg(arch).decoder:         # the encoder's forward
            np.testing.assert_allclose(logits, mine, atol=PREFILL_TOL,
                                       rtol=PREFILL_TOL,
                                       err_msg=f"forward rank {r}")
            continue
        np.testing.assert_allclose(logits[:, :1], mine[:, :1],
                                   atol=PREFILL_TOL, rtol=PREFILL_TOL,
                                   err_msg=f"prefill rank {r}")
        np.testing.assert_allclose(logits[:, 1:], mine[:, 1:],
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=f"decode rank {r}")
        np.testing.assert_array_equal(
            logits[..., :vocab].argmax(-1), mine[..., :vocab].argmax(-1))
    # the TP ranks of each model slice: one residual stream, one routing
    for d in range(data):
        pair = [got[2 * d], got[2 * d + 1]]
        for field in ("resid_sha", "router_sha"):
            assert str(pair[0][field]) == str(pair[1][field]), field
    if (arch, data) in SERVED:
        for fields in got.values():
            np.testing.assert_array_equal(fields["tokens"],
                                          want[(arch, data)]["tokens"])
