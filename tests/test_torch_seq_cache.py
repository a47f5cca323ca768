"""The KV cache cut on its positions, as the reference's ``cache_specs``
lays it out: every KV head a rank, the positions in ``n`` blocks over
``"model"`` (over ``("data", "model")`` where the batch does not split).

  * ``decode_attention_cut`` on ``n`` in {2, 4} blocks, its gather of
    the partial softmaxes run between ``n`` threads of this process (one
    a block, ``_Cut``), equals the reference's ``decode_attention`` over the whole
    cache within 1e-5 (atol = rtol, float32): G in {1, 2, 4}, soft-cap on
    and off, ``t`` in the first block (the later blocks wholly masked),
    ``t`` on a block's edge, a ring buffer's ``slot``, and the padded
    head layout (groups of 3 query heads padded to 4 with zero heads,
    compared on the real heads).  With nothing cut, ``attn_decode`` runs
    ``decode_attention``, which is the plain one-rank decode, bit for bit.
  * A length the cut does not divide raises ``ConfigError`` naming the
    counts; ``steps.cache_len`` rounds a serve's length up to split.
  * One spawn of 4 gloo ranks (``tests/torch_mesh_workers.py``, kind
    ``tp_serve``) beside one reference subprocess at 4 host devices, the
    port's seed-0 weights handed to the reference in its layout:
    llama4-maverick's smoke config at a prompt of 52 on (1, 2) (its
    window of 32 wraps: the tail's 20 slots span both ranks' 16-slot
    blocks), qwen3-1.7b at a prompt of 8 at batch 1 on (2, 1) (the cut
    over "data" at TP 1), and qwen3-1.7b and llama-3.2-vision at a
    prompt of 8 and llama4-maverick at 52 at batch 1 on (2, 2) (the cut
    over ("data", "model"): 12, 56, the window's 32 and the 16 media
    tokens split over 4).  Prefill and 4 teacher-forced decode steps
    against the reference's ``build_prefill_step`` /
    ``build_decode_step``: 2e-4 at the prefill, 5e-4 in decode, greedy
    tokens equal, and ``serve``'s
    tokens equal to the reference's greedy decode; each rank's cache
    leaves of the shapes ``NamedSharding(mesh, spec).shard_shape`` gives
    for the reference's ``abstract_cache`` under its ``cache_specs``; one
    ``tp_cache_a2a`` an attention layer in the prefill on a TP axis (none
    at TP 1), one ``tp_decode_qkv`` gather and one ``tp_decode_combine``
    gather an attention layer a step.
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.models import layers as JL
from repro_torch.convert import model_config_from_fields
from repro_torch.core.engine import tree_flatten
from repro_torch.core.schedules import ConfigError
from repro_torch.launch import steps as ST
from repro_torch.launch.sharding import AbstractMesh
from repro_torch.models import layers as L
from repro_torch.models import model as PM
from repro_torch.runtime import context as C

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

TOL = 1e-5
PREFILL_TOL, DECODE_TOL = 2e-4, 5e-4
RANKS, STEPS = 4, 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LLAMA4 = "llama4-maverick-400b-a17b"
# (arch, batch, prompt, (data, model))
SERVE = [(LLAMA4, 2, 52, (1, 2)), ("qwen3-1.7b", 1, 8, (2, 1)),
         ("qwen3-1.7b", 1, 8, (2, 2)), ("llama-3.2-vision-90b", 1, 8, (2, 2)),
         (LLAMA4, 1, 52, (2, 2))]


# ---------------------------------------------------------------------------
# The combine, on threads of this process
# ---------------------------------------------------------------------------


class _Cut:
    """Stands in for the cut's gather: ``n`` threads, one a block, each
    hands its tensor in, and each gets all ``n`` stacked in block
    order."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.parts = [None] * n
        self.local = threading.local()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        self.parts[self.local.j] = t
        self.barrier.wait()
        out = torch.stack(self.parts)
        self.barrier.wait()
        return out

    def run(self, fn) -> list:
        outs = [None] * self.n

        def one(j):
            self.local.j = j
            outs[j] = fn(j)

        threads = [threading.Thread(target=one, args=(j,))
                   for j in range(self.n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return outs


def _cut_decode(monkeypatch, n, q, k, v, t, softcap):
    """Every block's ``decode_attention_cut`` over the whole cache cut in
    ``n``; the outputs of all blocks."""
    cut = _Cut(n)
    monkeypatch.setattr(L, "cut_gather", lambda ctx, x: cut.gather(x))
    Sb = k.shape[1] // n
    return cut.run(lambda j: L.decode_attention_cut(
        q, k[:, j * Sb:(j + 1) * Sb], v[:, j * Sb:(j + 1) * Sb], t,
        lo=j * Sb, softcap=softcap))


def _draw(seed, B, S, H, K, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


# (n, G, S, t, softcap)
CASES = [(2, 1, 16, 11, 0.0), (4, 2, 16, 13, 0.0), (4, 4, 32, 30, 0.0),
         (2, 2, 16, 12, 30.0), (4, 4, 16, 3, 0.0), (4, 2, 16, 2, 5.0),
         (2, 1, 16, 7, 0.0), (4, 2, 16, 8, 0.0), (4, 4, 16, 11, 30.0),
         (2, 2, 32, 20, 0.0), (4, 1, 32, 20, 0.0)]
IDS = ["n2-g1", "n4-g2", "n4-g4", "n2-g2-cap", "t-first-block",
       "t-first-block-cap", "t-edge-n2", "t-edge-n4", "t-edge-cap",
       "ring-slot-n2", "ring-slot-n4"]


@pytest.mark.parametrize("n,G,S,t,cap", CASES, ids=IDS)
def test_cut_decode_equals_the_whole_cache(monkeypatch, n, G, S, t, cap):
    K = 2
    q, k, v = _draw(n * 100 + t, 2, S, K * G, K)
    want = np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t),
        softcap=cap))
    outs = _cut_decode(monkeypatch, n, *map(torch.from_numpy, (q, k, v)),
                       t, cap)
    for j, got in enumerate(outs):
        assert torch.equal(got, outs[0]), j
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_cut_decode_padded_heads(monkeypatch, n):
    """Groups of 3 query heads padded to 4 (a zero head a group, as
    ``q_group`` lays out heads that do not split): the real heads equal
    the reference's unpadded decode."""
    K, G, g, S, t = 2, 3, 4, 16, 9
    q, k, v = _draw(n, 2, S, K * G, K)
    want = np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t)))
    qp = np.zeros((2, 1, K * g, q.shape[-1]), np.float32)
    real = [h for h in range(K * g) if h % g < G]
    qp[:, :, real] = q
    outs = _cut_decode(monkeypatch, n, torch.from_numpy(qp),
                       torch.from_numpy(k), torch.from_numpy(v), t, 0.0)
    np.testing.assert_allclose(outs[0].numpy()[:, :, real], want,
                               atol=TOL, rtol=TOL)


def _plain_decode(q, k_cache, v_cache, t, softcap):
    """The one-rank decode attention, its operations in order."""
    B, _, H, hd = q.shape
    _, S, K, _ = k_cache.shape
    qg = (q[:, 0] * (1.0 / np.sqrt(hd))).reshape(B, K, H // K, hd)
    valid = torch.arange(S) <= t
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    p = torch.softmax(s.masked_fill(~valid, L.NEG_INF), dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_cut_is_the_one_rank_decode(dtype):
    """n = 1: ``decode_attention`` is the plain one-rank decode bit for
    bit, and ``attn_decode`` (a self and a cross layer, no context) calls
    it and writes the slot as before."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _draw(3, 2, 16, 4, 2))
    for t, cap in ((9, 0.0), (15, 30.0)):
        assert torch.equal(L.decode_attention(q, k, v, t, softcap=cap),
                           _plain_decode(q, k, v, t, cap))
    cfg = dataclasses.replace(get_smoke_config("llama-3.2-vision-90b"),
                              dtype=str(dtype).split(".")[1])
    cfg = model_config_from_fields(dataclasses.asdict(cfg))
    p = L.make_attn_params(cfg, torch.Generator().manual_seed(0))
    p = {n_: w.to(dtype) for n_, w in p.items()}
    x = torch.randn((2, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(dtype)
    assert C.cache_cut(C.get_ctx()) == (1, 0)
    for mixer in ("attn", "cross_attn"):
        cache = PM._layer_cache(cfg, dataclasses.replace(
            cfg.pattern[0], mixer=mixer), 2, 12, "cpu", media_len=16)
        for name in ("k", "v"):
            cache[name].normal_(generator=torch.Generator().manual_seed(2))
        before = {n_: c.clone() for n_, c in cache.items()}
        y, got = L.attn_decode(cfg, p, x, cache, 5, mixer=mixer)
        q, kk, vv = L._qkv(cfg, p, x, x if mixer == "attn" else x[:, :1],
                           dtype)
        if mixer == "attn":
            pos = torch.tensor([5], dtype=torch.int32)
            q, kk = L.rope(q, pos, cfg.rope_theta), L.rope(kk, pos,
                                                            cfg.rope_theta)
            before["k"][:, 5:6], before["v"][:, 5:6] = kk, vv
            o = _plain_decode(q, before["k"], before["v"], 5,
                              cfg.logit_softcap)
        else:
            o = _plain_decode(q, before["k"], before["v"], 15,
                              cfg.logit_softcap)
        assert torch.equal(got["k"], before["k"]), mixer
        assert torch.equal(y, L._attn_out(p, o, dtype)), mixer


class _Mesh:
    """The shape and this rank's coordinates, with no process group."""

    def __init__(self, shape, axes, coords):
        self.axis_names, self.shape = axes, dict(zip(axes, shape))
        self._coords = dict(zip(axes, coords))

    def coord(self, axis, rank=None):
        return self._coords[axis]


def test_a_length_the_cut_does_not_divide_raises():
    cfg = model_config_from_fields(dataclasses.asdict(
        get_smoke_config("qwen3-1.7b")))
    mesh = _Mesh((2, 2), ("data", "model"), (1, 1))
    one = C.DistCtx(mesh=mesh, tp_axis="model",
                    cache_axes=("data", "model"))
    assert C.cache_cut(one) == (4, 3)
    assert C.cache_cut(dataclasses.replace(one, cache_axes=("model",))) \
        == (2, 1)
    with C.use_ctx(one):
        with pytest.raises(ConfigError, match="13 positions .* 4 blocks"):
            PM.init_cache(cfg, 1, 13, "meta")
        shapes = {tuple(t.shape) for t in
                  tree_flatten(PM.init_cache(cfg, 1, 16, "meta"))[0]}
    assert shapes == {(1, 4, cfg.n_kv_heads, cfg.hd)}
    am = AbstractMesh((2, 2), ("data", "model"))
    assert ST.cache_len(13, 1, am) == 16         # over ("data", "model")
    assert ST.cache_len(13, 2, am) == 14         # over "model"
    assert ST.cache_len(13, 1, None) == 13


# ---------------------------------------------------------------------------
# Prefill and decode on 4 gloo ranks against the reference
# ---------------------------------------------------------------------------


def _jcfg(arch: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


def _name(arch, B, PL, mesh) -> str:
    return f"{arch}@{mesh[0]}x{mesh[1]}_b{B}_p{PL}"


REFERENCE = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import sharding as SH
from repro.launch import steps as ST
from repro.launch.mesh import make_host_mesh
from repro.models import model as M

out_path, in_path, cases, STEPS = json.loads(sys.argv[1])
with open(in_path, "rb") as f:
    prompts, forced, weights = pickle.load(f)


def jcfg(arch):
    # test_torch_seq_cache._jcfg
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
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
for name, arch, B, PL, (data, model) in cases:
    cfg = jcfg(arch)
    mesh = make_host_mesh(data=data, model=model)
    params = jax.tree.map(jnp.asarray, weights[name])
    batch = {k: jnp.asarray(v) for k, v in prompts[name].items()}
    pre, _ = ST.build_prefill_step(cfg, mesh,
                                   ShapeConfig("p", PL, B, "prefill"))
    logits0, cache = pre(params, batch)
    shape = ShapeConfig("d", PL + STEPS, B, "decode")
    dec, (_, cspecs, _) = ST.build_decode_step(cfg, mesh, shape,
                                               donate=False)
    shard = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(ST.abstract_cache(cfg, shape)),
            jax.tree.leaves(cspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        key = "/".join(str(k.key) for k in path)
        shard[key] = list(NamedSharding(mesh, spec).shard_shape(leaf.shape))
    cache0 = jax.device_put(
        jax.tree.map(graft, M.init_cache(cfg, B, PL + STEPS,
                                         media_len=cfg.n_media_tokens),
                     cache), SH.to_shardings(cspecs, mesh))
    got, cache = [np.asarray(logits0)[:, -1:]], cache0
    for i in range(STEPS):
        tok = jnp.asarray(forced[name][:, i:i + 1])
        logits, cache = dec(params, cache, tok, jnp.int32(PL + i))
        got.append(np.asarray(logits))
    tok, cache, toks = greedy(cfg, logits0), cache0, []
    toks.append(np.asarray(tok))
    for i in range(STEPS):
        logits, cache = dec(params, cache, tok, jnp.int32(PL + i))
        tok = greedy(cfg, logits)
        toks.append(np.asarray(tok))
    res[name] = {"logits": np.concatenate(got, axis=1),
                 "tokens": np.concatenate(toks, axis=1), "shard": shard}
with open(out_path, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE DONE")
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_cache")
    inputs, prompts, forced, weights, cases, ref_cases = {}, {}, {}, {}, \
        [], []
    params = {}
    for arch in sorted({a for a, _, _, _ in SERVE}):
        pcfg = model_config_from_fields(dataclasses.asdict(_jcfg(arch)))
        params[arch] = PM.init_params(pcfg, torch.Generator().manual_seed(0))
        for i, t in enumerate(tree_flatten(params[arch])[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
    # a 2-rank mesh's case runs on one of two 2-rank groups
    for arch, B, PL, mesh in sorted(SERVE, key=lambda c: math.prod(c[3])):
        name = _name(arch, B, PL, mesh)
        jcfg = _jcfg(arch)
        weights[name] = W.to_reference(params[arch])
        batch = SyntheticStream(DataConfig(seq_len=PL + STEPS,
                                           global_batch=B, seed=0),
                                jcfg).global_batch(0)
        prompts[name] = {k: (v[:, :PL] if k == "tokens" else v)
                         for k, v in batch.items() if k != "labels"}
        forced[name] = batch["tokens"][:, PL:PL + STEPS]
        inputs[f"forced/{name}"] = forced[name]
        for k, v in prompts[name].items():
            inputs[f"prompts/{name}/{k}"] = v
        cases.append(dict(
            kind="tp_serve", name=name,
            cfg=dataclasses.asdict(model_config_from_fields(
                dataclasses.asdict(jcfg))),
            params=f"p/{arch}", prompts=f"prompts/{name}",
            forced=f"forced/{name}", batch=B, prompt_len=PL, steps=STEPS,
            serve=True, mesh=(mesh, ("data", "model"))))
        ref_cases.append((name, arch, B, PL, mesh))
    in_path = str(tmp / "reference.in")
    with open(in_path, "wb") as f:
        pickle.dump((prompts, forced, weights), f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    out = str(tmp / "reference.pkl")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         json.dumps([out, in_path, ref_cases, STEPS])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        outs = W.run_job(str(tmp), cases, inputs, RANKS, timeout_s=240)
        stdout, stderr = ref.communicate(timeout=240)
        assert ref.returncode == 0, stdout[-4000:] + stderr[-4000:]
        with open(out, "rb") as f:
            want = pickle.load(f)
    finally:
        ref.kill()
    return outs, want


def _fields(outs: list, name: str) -> dict:
    """mesh rank -> {field: value} of one case."""
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


@pytest.mark.parametrize("arch,B,PL,mesh", SERVE,
                         ids=[_name(*c) for c in SERVE])
def test_cut_serve_matches_reference(run, arch, B, PL, mesh):
    outs, want = run
    name = _name(arch, B, PL, mesh)
    got = _fields(outs, name)
    assert sorted(got) == list(range(math.prod(mesh)))
    ref = want[name]
    cfg = _jcfg(arch)
    attn = sum(s.mixer != "mamba2" for s in cfg.pattern) * cfg.n_units
    for r, fields in got.items():
        logits = fields["logits"]
        assert logits.shape == ref["logits"].shape
        np.testing.assert_allclose(logits[:, :1], ref["logits"][:, :1],
                                   atol=PREFILL_TOL, rtol=PREFILL_TOL,
                                   err_msg=f"prefill rank {r}")
        np.testing.assert_allclose(logits[:, 1:], ref["logits"][:, 1:],
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=f"decode rank {r}")
        v = cfg.vocab_size
        np.testing.assert_array_equal(logits[..., :v].argmax(-1),
                                      ref["logits"][..., :v].argmax(-1))
        np.testing.assert_array_equal(fields["tokens"], ref["tokens"])
        # the rank's cache: the reference's shard shapes, unit by unit
        for unit in json.loads(str(fields["cache_shapes"])):
            for key, shp in unit.items():
                assert shp == ref["shard"][key][1:], (r, key, shp)
        # the relayout's exchange and the heads' gather run on a TP axis
        # (at TP 1 the block is a slice, the heads the rank's own)
        tp = int(mesh[1] > 1)
        assert int(fields.get("prefill_calls_tp_cache_a2a", 0)) == tp * attn
        assert int(fields.get("decode_calls_tp_decode_qkv", 0)) == \
            tp * STEPS * attn
        assert int(fields["decode_calls_tp_decode_combine"]) == \
            STEPS * attn
