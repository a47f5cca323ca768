"""The bfloat16 decode rounded where the reference rounds it.

The reference's ``decode_attention`` (``repro/models/layers.py``) has two
rounding points that torch does not make by itself:

  * ``q * (1 / sqrt(hd))`` with a Python float: JAX's weak typing rounds
    the scale to q's dtype first (0.08837890625 at hd 128, exact only
    where hd is a power of 4), torch keeps it whole and rounds only the
    product (``models.layers.weak_scalar``);
  * p normalized over the whole row, then rounded to the cache's dtype
    before its product with V: the cut decode (``decode_attention_cut``)
    gathers its blocks' row maxes and sums first (``tp_decode_stats``),
    then rounds each block's normalized p and sums the blocks' products.

The same seeded numpy draws (N(0, 1)) go through the reference and the
port.  ``r`` is rms(port - ref_bf16) / rms(ref_bf16 - ref_f32), ref_f32
the reference in float32 on the float32 draws: 0 where the port rounds
as the reference does, about 1 where it is as far from it as bfloat16
is from float32.  ``eq`` is the share of outputs bit-equal to ref_bf16.
Each case is gated at r <= 0.05 and eq >= 0.99 over its 16 batch rows.
What remains comes from the backend, not the program: XLA's float32
``exp`` gives torch's bits on 90% of draws, its row sums on 41% of rows
(``tests/torch_bf16_rounding.py``), so now and then a p lands on the
other side of a bfloat16 rounding and its row's outputs move by an ulp.
That makes a small draw's r heavy-tailed: over 54 draws of 2 rows the
one-rank decode's median is 0.000 and its largest 0.069 (a cut in 4
blocks: 0.056); over 54 draws of 16 rows the median is 0.011 and the
largest 0.048 (both).  So each case's r is taken over 16 rows: every
decode case's r is 0.040 or less and its eq 0.997 or more.  Without the
two roundings (the scale unrounded, p kept in float32 over the cut)
every case fails but the one-rank decode at hd 64 (bit-equal there): r
0.41-0.45 for the one-rank decode at hd 80, 0.59-0.64 at hd 128, and
0.52-0.73 for every cut at every hd, eq 0.54-0.81.

  * ``decode_attention`` at hd 64, 80 and 128, G in {1, 5, 8}, S up to
    2,048, soft-cap on and off;
  * ``decode_attention_cut`` on n in {2, 4, 16} blocks (the gather run
    between n threads, ``test_torch_seq_cache._Cut``) at the same hd and
    shapes, and at hd 128 with ``t`` in the first block, on a block's
    edge, a ring buffer's slot, and groups of 5 heads padded to 6;
  * ``attn_decode`` (the projections, qk-norm, rope, the cache write, the
    decode, ``wo``) of smoke configs at ``head_dim=128``: the decode
    attention inside it and the block's output at the same gate (without
    the roundings: 0.51-0.54 and 0.58-0.63);
  * an embedding multiplier that bfloat16 does not hold exactly: the
    embeddings bit-equal to the reference's;
  * one spawn of 4 gloo ranks (``tests/torch_mesh_workers.py``, kind
    ``tp_serve``): qwen3-1.7b's smoke config at ``head_dim=128`` in
    bfloat16, prefill and teacher-forced decode steps, against the
    port's own one-rank bfloat16 steps, r taken against one rank's
    bfloat16-vs-float32 distance.  On (2, 1) at batch 1 only the cut
    over "data" differs from one rank: gated at r <= 0.05 (0.000,
    bit-equal; without the roundings 0.70, eq 0.25).  On (2, 2) TP's
    row-parallel sums of bfloat16 partials round apart from one rank's
    single product too: its r (0.70) is reported, not gated.
    On both every rank's logits are equal, and a decode step makes one
    ``tp_decode_stats`` and one ``tp_decode_combine`` gather a layer.
"""
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.models import layers as L
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402
from test_torch_seq_cache import _Cut  # noqa: E402

R_GATE, EQ_GATE = 0.05, 0.99
B, K = 16, 2
HDS = [64, 80, 128]
# (G, S, t, softcap)
SHAPES = [(1, 256, 200, 0.0), (5, 2048, 1500, 0.0), (8, 1024, 700, 30.0)]
SHAPE_IDS = ["g1-s256", "g5-s2048", "g8-s1024-cap"]


def _draw(seed: int, H: int, S: int, hd: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _reference(q, k, v, t: int, cap: float) -> tuple:
    """The reference's decode in bfloat16 and in float32, as float32
    numpy."""
    return tuple(np.asarray(JL.decode_attention(
        jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        jnp.int32(t), softcap=cap).astype(jnp.float32))
        for dt in (jnp.bfloat16, jnp.float32))


def _r_eq(got, want, want32) -> tuple:
    got = np.asarray(got, np.float32)
    r = float(np.sqrt(np.mean((got - want) ** 2))
              / np.sqrt(np.mean((want - want32) ** 2)))
    return r, float(np.mean(got == want))


def _gate(got, want, want32, what: str) -> None:
    r, eq = _r_eq(got, want, want32)
    print(f"GATE {what}: r {r:.4f} eq {eq:.4f}")
    assert r <= R_GATE and eq >= EQ_GATE, f"{what}: r {r:.4f}, eq {eq:.4f}"


def _cut(monkeypatch, n: int, q, k, v, t: int, cap: float) -> torch.Tensor:
    """Every block's ``decode_attention_cut`` over the cache cut in n;
    each block's output is the same, and it is returned."""
    cut = _Cut(n)
    monkeypatch.setattr(L, "cut_gather",
                        lambda ctx, x, kind="": cut.gather(x))
    Sb = k.shape[1] // n
    outs = cut.run(lambda j: L.decode_attention_cut(
        q, k[:, j * Sb:(j + 1) * Sb], v[:, j * Sb:(j + 1) * Sb], t,
        lo=j * Sb, softcap=cap))
    for j, o in enumerate(outs):
        assert torch.equal(o, outs[0]), j
    return outs[0]


def test_the_scale_is_the_reference_constant():
    """At hd 128 JAX's weak typing gives the bfloat16 0.08837890625, not
    1 / sqrt(128) = 0.0883883...; in float32 the scalar is torch's own."""
    assert L.weak_scalar(1 / math.sqrt(128), torch.bfloat16) == 0.08837890625
    q = jnp.ones((1,), jnp.bfloat16) * (1 / math.sqrt(128))
    assert float(q[0]) == 0.08837890625
    x = torch.randn(64, generator=torch.Generator().manual_seed(0))
    s = 1 / math.sqrt(80)
    assert torch.equal(x * L.weak_scalar(s, torch.float32), x * s)


@pytest.mark.parametrize("G,S,t,cap", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("hd", HDS)
def test_one_rank_decode_rounds_as_the_reference(hd, G, S, t, cap):
    q, k, v = _draw(hd * 100 + G, K * G, S, hd)
    want, want32 = _reference(q, k, v, t, cap)
    got = L.decode_attention(_bf16(q), _bf16(k), _bf16(v), t, softcap=cap)
    assert got.dtype == torch.bfloat16
    _gate(got.float().numpy(), want, want32, "one rank")


@pytest.mark.parametrize("G,S,t,cap", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("n", [2, 4, 16])
def test_cut_decode_rounds_as_the_reference(monkeypatch, n, hd, G, S, t,
                                            cap):
    q, k, v = _draw(n * 1000 + hd * 100 + G, K * G, S, hd)
    want, want32 = _reference(q, k, v, t, cap)
    got = _cut(monkeypatch, n, _bf16(q), _bf16(k), _bf16(v), t, cap)
    assert got.dtype == torch.bfloat16
    _gate(got.float().numpy(), want, want32, f"cut in {n}")


S_EDGE, G_EDGE = 1024, 5
# name -> t, each at n blocks of S_EDGE / n
EDGES = {
    "t-first-block": lambda n: S_EDGE // n // 2,   # later blocks masked
    "t-block-edge": lambda n: (n // 2) * (S_EDGE // n) - 1,
    # a chunked layer's ring of S_EDGE slots at position 5,000
    "ring-slot": lambda n: 5000 % S_EDGE,
}


@pytest.mark.parametrize("where", sorted(EDGES))
@pytest.mark.parametrize("n", [2, 4, 16])
def test_cut_decode_at_the_edges(monkeypatch, n, where):
    t = EDGES[where](n)
    q, k, v = _draw(n * 10 + len(where), K * G_EDGE, S_EDGE, 128)
    want, want32 = _reference(q, k, v, t, 0.0)
    got = _cut(monkeypatch, n, _bf16(q), _bf16(k), _bf16(v), t, 0.0)
    _gate(got.float().numpy(), want, want32, f"{where}, t {t}")


@pytest.mark.parametrize("n", [2, 4, 16])
def test_cut_decode_padded_heads(monkeypatch, n):
    """Groups of 5 query heads padded to 6 with zero heads (llama4's 40
    over 8 KV heads at TP 16): the real heads against the reference's
    unpadded decode."""
    g, t = 6, 700
    q, k, v = _draw(n + 7, K * G_EDGE, S_EDGE, 128)
    want, want32 = _reference(q, k, v, t, 0.0)
    qp = np.zeros((B, 1, K * g, 128), np.float32)
    real = [h for h in range(K * g) if h % g < G_EDGE]
    qp[:, :, real] = q
    got = _cut(monkeypatch, n, _bf16(qp), _bf16(k), _bf16(v), t, 0.0)
    _gate(got.float().numpy()[:, :, real], want, want32, "padded heads")


# ---------------------------------------------------------------------------
# The attn_decode block
# ---------------------------------------------------------------------------

# (arch, layer): a self layer with qk-norm, one without, a cross layer
BLOCKS = [("qwen3-1.7b", 0), ("llama-3.2-vision-90b", 0),
          ("llama-3.2-vision-90b", 4)]
BLOCK_S, BLOCK_T, BLOCK_M = 512, 300, 64


def _record(monkeypatch, module, into: list) -> None:
    """Keep every output of ``module.decode_attention``."""
    inner = module.decode_attention

    def rec(*a, **kw):
        o = inner(*a, **kw)
        into.append(np.asarray(
            o.float() if isinstance(o, torch.Tensor) else
            o.astype(jnp.float32)))
        return o

    monkeypatch.setattr(module, "decode_attention", rec)


def _reference_rope(x: torch.Tensor, positions: torch.Tensor,
                    theta: float) -> torch.Tensor:
    """The reference's ``rope`` on a bfloat16 tensor: its float32 cos
    and sin are XLA's, which differ from torch's on some angles by an
    ulp (``tests/torch_bf16_rounding.py``), and that alone moves a few q
    elements by a bfloat16 ulp, which moves their rows' scores."""
    y = JL.rope(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                jnp.asarray(positions.numpy()), theta)
    return torch.from_numpy(np.array(y.astype(jnp.float32))).to(x.dtype)


@pytest.mark.parametrize("arch,layer", BLOCKS,
                         ids=[f"{a}-layer{i}" for a, i in BLOCKS])
def test_attn_decode_block_rounds_as_the_reference(monkeypatch, arch,
                                                    layer):
    """One layer's ``attn_decode`` at hd 128 from the same weights, x and
    cache: the decode attention inside it (recorded in both packages) and
    the block's output at the gate.  The port runs the reference's rope
    here (``_reference_rope``): the backend's trigonometry is not a
    rounding point of the program."""
    base = dataclasses.replace(get_smoke_config(arch), head_dim=128)
    spec = base.pattern[layer]
    jp = JL.make_attn_params(base, jax.random.PRNGKey(layer),
                             cross=spec.mixer == "cross_attn")
    rng = np.random.default_rng(layer)
    S = BLOCK_M if spec.mixer == "cross_attn" else BLOCK_S
    x = rng.standard_normal((B, 1, base.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, base.n_kv_heads, 128))
              .astype(np.float32) for _ in range(2))
    outs, attn = {}, {"ref": [], "port": []}
    _record(monkeypatch, JL, attn["ref"])
    _record(monkeypatch, L, attn["port"])
    monkeypatch.setattr(L, "rope", _reference_rope)
    for dt in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(base, dtype=dt)
        jd = jnp.dtype(dt)
        y, _ = JL.attn_decode(jcfg, jp, jnp.asarray(x, jd),
                              {"k": jnp.asarray(kc, jd),
                               "v": jnp.asarray(vc, jd)},
                              jnp.int32(BLOCK_T), mixer=spec.mixer)
        outs[dt] = np.asarray(y.astype(jnp.float32))
    pcfg = model_config_from_fields(dataclasses.asdict(
        dataclasses.replace(base, dtype="bfloat16")))
    pp = {name: torch.from_numpy(np.array(w)) for name, w in jp.items()}
    y, _ = L.attn_decode(pcfg, pp, _bf16(x),
                         {"k": _bf16(kc), "v": _bf16(vc)}, BLOCK_T,
                         mixer=spec.mixer)
    assert y.dtype == torch.bfloat16
    (want, want32), (got,) = attn["ref"], attn["port"]
    _gate(got, want, want32, "the decode attention inside attn_decode")
    _gate(y.float().numpy(), outs["bfloat16"], outs["float32"],
          "attn_decode's output")


def test_embedding_multiplier_rounds_as_the_reference():
    """A multiplier bfloat16 does not hold (sqrt(3072), as a model that
    scales by the square root of its width would): the reference rounds
    it to bfloat16 before the product, and so does the port; the
    unrounded product differs."""
    mult = math.sqrt(3072)
    jcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               dtype="bfloat16", embedding_multiplier=mult)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(pcfg,
                                      jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    want = np.asarray(JM.embed_inputs(jcfg, jparams, {
        "tokens": jnp.asarray(toks)}).astype(jnp.float32))
    got = PM.embed_inputs(pcfg, pparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    rows = pparams["embed"][torch.from_numpy(toks).long()].to(torch.bfloat16)
    assert not torch.equal(rows * mult, got)


# ---------------------------------------------------------------------------
# The cut serve on 4 gloo ranks against one rank
# ---------------------------------------------------------------------------

RANKS, STEPS, PROMPT = 4, 8, 24
MESHES = [(2, 1), (2, 2)]


def _serve_cfg(dtype: str):
    return model_config_from_fields(dataclasses.asdict(dataclasses.replace(
        get_smoke_config("qwen3-1.7b"), head_dim=128, dtype=dtype)))


def _one_rank(cfg, params, prompts, forced) -> np.ndarray:
    """The port's one-rank prefill and teacher-forced decode logits
    (1 + STEPS positions) as float32 numpy."""
    logits, cache = PM.prefill(cfg, params, {"tokens": prompts},
                               PROMPT + STEPS)
    got = [logits[:, -1:]]
    for i in range(STEPS):
        logits, cache = PM.decode_step(cfg, params, cache,
                                       forced[:, i:i + 1], PROMPT + i)
        got.append(logits)
    return torch.cat(got, dim=1).float().numpy()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16_decode")
    cfg = _serve_cfg("bfloat16")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (1, PROMPT + STEPS),
                        dtype=np.int32)
    inputs = {f"p/{i}": t.numpy()
              for i, t in enumerate(tree_flatten(params)[0])}
    inputs["prompts/tokens"] = toks[:, :PROMPT]
    inputs["forced"] = toks[:, PROMPT:]
    cases = [dict(kind="tp_serve", name=f"m{d}x{m}",
                  cfg=dataclasses.asdict(cfg), params="p",
                  prompts="prompts", forced="forced", batch=1,
                  prompt_len=PROMPT, steps=STEPS, serve=False,
                  mesh=((d, m), ("data", "model"))) for d, m in MESHES]
    outs = W.run_job(str(tmp), cases, inputs, RANKS, timeout_s=300)
    prompts, forced = (torch.from_numpy(a) for a in
                       (toks[:, :PROMPT], toks[:, PROMPT:]))
    one = {dt: _one_rank(_serve_cfg(dt), params, prompts, forced)
           for dt in ("bfloat16", "float32")}
    return outs, one


def _ranks(outs: list, d: int, m: int) -> list:
    """Each mesh rank's fields of the (d, m) case, in rank order, after
    checking that every rank's logits are rank 0's and that a decode
    step made one ``tp_decode_stats`` and one ``tp_decode_combine``
    gather a layer (the qwen3 smoke config's two)."""
    name, got = f"m{d}x{m}", {}
    for r, out in enumerate(outs):
        for key, v in out.items():
            if not key.startswith(name + "/"):
                continue
            rest = key[len(name) + 1:]
            if rest.startswith("r") and "/" in rest:
                i, rest = rest.split("/", 1)
                got.setdefault(int(i[1:]), {})[rest] = v
            else:
                got.setdefault(r, {})[rest] = v
    assert sorted(got) == list(range(d * m)), sorted(outs[0])
    ranks = [got[r] for r in range(d * m)]
    for r, fields in enumerate(ranks):
        np.testing.assert_array_equal(fields["logits"], ranks[0]["logits"],
                                      err_msg=str(r))
        for kind in ("tp_decode_stats", "tp_decode_combine"):
            assert int(fields[f"decode_calls_{kind}"]) == 2 * STEPS, \
                (r, kind)
    return ranks


def test_cut_over_data_serve_rounds_as_one_rank(served, record_property):
    """(2, 1) at batch 1: the cut over "data" at TP 1 is all that
    differs from one rank, and its decode logits are within the gate of
    one rank's bfloat16 logits."""
    outs, one = served
    logits = _ranks(outs, 2, 1)[0]["logits"]
    r, eq = _r_eq(logits[:, 1:], one["bfloat16"][:, 1:],
                  one["float32"][:, 1:])
    record_property("decode_logits_r", r)
    record_property("decode_logits_eq", eq)
    print(f"(2, 1) decode logits against one rank: r {r:.4f}, eq {eq:.4f}")
    assert r <= R_GATE, f"decode logits on (2, 1): r {r:.4f}, eq {eq:.4f}"


def test_cut_over_data_and_model_serve_is_reported(served,
                                                   record_property):
    """(2, 2): TP's row-parallel sums of bfloat16 partials round apart
    from one rank's single product as well, so the decode logits' r is
    reported, not gated; every rank's logits are the same."""
    outs, one = served
    logits = _ranks(outs, 2, 2)[0]["logits"]
    assert np.isfinite(logits).all()
    r, eq = _r_eq(logits[:, 1:], one["bfloat16"][:, 1:],
                  one["float32"][:, 1:])
    record_property("decode_logits_r", r)
    record_property("decode_logits_eq", eq)
    print(f"(2, 2) decode logits against one rank: r {r:.4f}, eq {eq:.4f}")
