"""The port's model stack against the JAX package on the smoke configs.

The served archs (qwen3-1.7b: GQA attention with qk-norm and a SwiGLU
MLP; mamba2-370m: Mamba2 SSD layers; command-r-35b: LayerNorm with a
scale, rope theta 4e6; qwen1.5-110b: QKV biases and an untied head;
qwen3-moe-235b: the MoE MLP, top-8 of 128 at full width; llama4-maverick:
MoE every other layer with a shared expert, chunked attention; jamba:
Mamba2 and attention layers, MoE every other layer) run
in float32 on the weights the reference draws (``M.init_params(cfg,
PRNGKey(2))``, its zero QKV biases replaced by seeded nonzero ones so the
bias add is tested), carried across by ``repro_torch.convert``, on CPU
tensors, so the kernel wrappers run their plain versions.  The MoE
configs run at a capacity factor of 16, as the reference's own
``tests/test_models.py`` does, so that no pair drops and a decode step's
routing of one token matches the full forward's; the capacity's drops
are held against the reference in ``tests/test_torch_moe.py``.  Tolerances are those of
``tests/test_models.py``: 2e-4 for prefill logits, 5e-4 for decode
logits (float32 sums taken in other orders by XLA and torch); the layers
are held at 1e-5, where only a few float32 roundings separate the two.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config as p_config
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.models import layers as PL
from repro_torch.models import model as PM

ARCHS = ["qwen3-1.7b", "mamba2-370m", "command-r-35b", "qwen1.5-110b",
         "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b"]
B, S, S_MAX = 2, 24, 48
LAYER_TOL = 1e-5
BIASES = ("bq", "bk", "bv")


def seeded_biases(jparams: dict, seed: int = 3) -> dict:
    """The reference's params with every QKV bias (zeros as drawn) set to
    seeded N(0, 0.5^2) values, stacked over the units as the rest."""
    rng = np.random.default_rng(seed)
    for lp in jparams["units"].values():
        for name in BIASES:
            if name in lp["mixer"]:
                shape = lp["mixer"][name].shape
                lp["mixer"][name] = jnp.asarray(
                    0.5 * rng.standard_normal(shape), jnp.float32)
    return jparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) for one arch."""
    jcfg = dataclasses.replace(get_smoke_config(request.param),
                               dtype="float32")
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=16.0))
    jparams = seeded_biases(JM.init_params(jcfg, jax.random.PRNGKey(2)))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, pcfg, pparams


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


def _unit0_layer0(jparams, pparams):
    jl = jax.tree.map(lambda a: a[0], jparams["units"])["layer0"]
    return jl, pparams["units"][0]["layer0"]


def test_config_carries_across(pair):
    jcfg, _, pcfg, _ = pair
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.param_count() == jcfg.param_count()
    assert PM.padded_vocab(pcfg) == JM.padded_vocab(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_is_the_reference(arch):
    """The port registers the reference's full config field for field,
    and the converter carries it across unchanged."""
    jfull = get_config(arch)
    assert dataclasses.asdict(p_config(arch)) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(model_config_from_fields(
        dataclasses.asdict(jfull))) == dataclasses.asdict(jfull)


def test_norm_and_rope(pair):
    jcfg, jparams, pcfg, pparams = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jl, pl = _unit0_layer0(jparams, pparams)
    _close(PL.apply_norm(pcfg, pl["norm1"], _t(x)),
           JL.apply_norm(jcfg, jl["norm1"], jnp.asarray(x)), LAYER_TOL)
    h = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    _close(PL.rope(_t(h), _t(pos), 1e6),
           JL.rope(jnp.asarray(h), jnp.asarray(pos), 1e6), LAYER_TOL)
    pos2 = (pos[None] + np.array([[0], [5]])).astype(np.int32)
    _close(PL.rope(_t(h), _t(pos2), 1e4),
           JL.rope(jnp.asarray(h), jnp.asarray(pos2), 1e4), LAYER_TOL)


def test_params_carry_across(pair):
    """The port draws the reference's leaves, shapes and dtypes (the
    untied head and the QKV biases where the config has them), and the
    converter carries every one, the seeded biases included."""
    jcfg, jparams, pcfg, pparams = pair
    mine = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path
    ref = {jax.tree_util.keystr(k): v for k, v in flat(
        jax.tree.map(lambda a: a[0], jparams["units"]))[0]}
    got = {jax.tree_util.keystr(k): v
           for k, v in flat(pparams["units"][0])[0]}
    drawn = {jax.tree_util.keystr(k): v
             for k, v in flat(mine["units"][0])[0]}
    assert got.keys() == drawn.keys() == ref.keys()
    for k in ref:
        assert tuple(drawn[k].shape) == ref[k].shape, k
        _close(got[k], ref[k], 0.0, k)
    assert ("head" in mine) == ("head" in jparams) == \
        (not jcfg.tie_embeddings)
    for k in ("embed", "head"):
        if k in jparams:
            assert tuple(mine[k].shape) == jparams[k].shape
            _close(pparams[k], jparams[k], 0.0, k)
    mixer = pparams["units"][0]["layer0"]["mixer"]
    for name in BIASES:
        assert (name in mixer) == jcfg.attn_bias
        if jcfg.attn_bias:
            assert float(mixer[name].abs().max()) > 0.1
            assert float(mine["units"][0]["layer0"]["mixer"][name]
                         .abs().max()) == 0.0


def test_mixer_and_mlp(pair):
    """q, k, v (qk-normed for qwen3, with biases for qwen1.5), the SwiGLU
    MLP (the MoE MLP where layer 0 has it) and attention; the Mamba2
    block's prefill and one decode step from its state (mamba2, jamba)."""
    jcfg, jparams, pcfg, pparams = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jl, pl = _unit0_layer0(jparams, pparams)
    if jcfg.ssm is None:
        got = PL._qkv(pcfg, pl["mixer"], _t(x), _t(x), torch.float32)
        want = JL._qkv(jcfg, jl["mixer"], jnp.asarray(x), jnp.asarray(x),
                       jnp.float32)
        for g, w, name in zip(got, want, "qkv"):
            _close(g, w, LAYER_TOL, name)
        if jcfg.pattern[0].mlp == "moe":
            _close(PL.moe_forward(pcfg, pl["mlp"], _t(x)),
                   JL.moe_forward(jcfg, jl["mlp"], jnp.asarray(x)),
                   LAYER_TOL)
        else:
            _close(PL.mlp_forward(pcfg, pl["mlp"], _t(x)),
                   JL.mlp_forward(jcfg, jl["mlp"], jnp.asarray(x)),
                   LAYER_TOL)
        _close(PL.attn_forward(pcfg, pl["mixer"], _t(x), mixer="attn"),
               JL.attn_forward(jcfg, jl["mixer"], jnp.asarray(x),
                               mixer="attn"), LAYER_TOL)
        return
    y, st = PL.mamba_forward(pcfg, pl["mixer"], _t(x))
    jy, jst = JL.mamba_forward(jcfg, jl["mixer"], jnp.asarray(x))
    _close(y, jy, 1e-4, "mamba prefill")
    for k in jst:
        _close(st[k], jst[k], 1e-4, f"mamba state {k}")
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    y1, st1 = PL.mamba_forward(pcfg, pl["mixer"], _t(x1), state=st,
                               decode=True)
    jy1, jst1 = JL.mamba_forward(jcfg, jl["mixer"], jnp.asarray(x1),
                                 state=jst, decode=True)
    _close(y1, jy1, 1e-4, "mamba decode")
    for k in jst1:
        _close(st1[k], jst1[k], 1e-4, f"mamba decode state {k}")


def test_forward_prefill_and_decode(pair):
    """``forward`` logits, ``prefill``'s last logits and every cache leaf,
    then 8 decode steps, each against the reference."""
    jcfg, jparams, pcfg, pparams = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S_MAX)).astype(np.int32)
    ref = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got = PM.forward(pcfg, pparams, {"tokens": _t(toks)})
    _close(got, ref, 2e-4, "forward")

    jlog, jcache = JM.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :S])},
                              max_seq=S_MAX)
    plog, pcache = PM.prefill(pcfg, pparams, {"tokens": _t(toks[:, :S])},
                              max_seq=S_MAX)
    _close(plog, jlog, 2e-4, "prefill logits")
    for u in range(pcfg.n_units):
        for name, leaves in pcache[u].items():
            for k, leaf in leaves.items():
                _close(leaf, jcache[name][k][u], 2e-4, f"cache {u} {name} {k}")
    for t in range(S, S + 8):
        jlog, jcache = JM.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        plog, pcache = PM.decode_step(pcfg, pparams, pcache,
                                      _t(toks[:, t:t + 1]), t)
        _close(plog, jlog, 5e-4, f"decode step {t}")
        _close(plog[:, 0], ref[:, t], 5e-4, f"decode vs forward {t}")


@pytest.mark.parametrize("arch, slice_", [
    ("qwen3-moe-235b-a22b", "the MoE slice"),
    ("llama-3.2-vision-90b", "the cross-attention and frontends slice"),
    ("hubert-xlarge", "the cross-attention and frontends slice"),
    ("llama4-maverick-400b-a17b", "the MoE slice")])
def test_later_slices_raise(arch, slice_):
    """The configs of later slices of the port, once refused with the
    slice they waited for, now run: the MoE configs came with the MoE
    slice, llama-3.2-vision-90b and hubert-xlarge with the
    cross-attention and frontends slice.  Each inits and runs a forward,
    a prefill and (a decoder) a decode step of finite logits; the
    frontend models on seeded media or frames.  (Their agreement with the
    reference is held in ``tests/test_torch_moe.py``,
    ``tests/test_torch_cross_attention.py`` and
    ``tests/test_torch_frontends.py``; the dense options, QKV biases, the
    untied head, the GELU MLP, soft-capping in decode and the embedding
    multiplier, in ``tests/test_torch_dense_options.py`` and the
    ``ARCHS`` above.)"""
    cfg = model_config_from_fields(dataclasses.asdict(get_smoke_config(arch)))
    params = PM.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    if cfg.frontend == "audio_frames":
        batch = {"frames": torch.randn((2, 16, cfg.d_model), generator=gen)}
    else:
        batch = {"tokens": toks}
    if cfg.frontend == "vision_patches":
        batch["media"] = torch.randn((2, cfg.n_media_tokens, cfg.d_model),
                                     generator=gen)
    logits = PM.forward(cfg, params, batch)
    assert logits.shape == (2, 16, PM.padded_vocab(cfg))
    last, cache = PM.prefill(cfg, params, batch, 20)
    outs = [logits, last]
    if cfg.decoder:
        outs.append(PM.decode_step(cfg, params, cache, toks[:, -1:], 16)[0])
    for t in outs:
        assert bool(torch.isfinite(t.float()).all())


def test_cast_params_keeps_float32_leaves():
    from repro_torch.configs import get_smoke_config as p_smoke
    for arch in ARCHS:
        cfg = p_smoke(arch)
        params = PM.init_params(cfg, torch.Generator().manual_seed(0))
        cast = PM.cast_params(cfg, params)
        layer = cast["units"][0]["layer0"]
        assert cast["embed"].dtype == torch.bfloat16
        assert layer["norm1"]["scale"].dtype == torch.bfloat16
        # the untied head and the QKV biases are read in the compute
        # dtype, as the reference's per-use casts
        for leaf in [cast.get("head")] + [layer["mixer"].get(b)
                                          for b in BIASES]:
            assert leaf is None or leaf.dtype == torch.bfloat16
        for k in PM.F32_LEAVES:
            if k in layer["mixer"]:
                assert layer["mixer"][k].dtype == torch.float32, k
        assert torch.equal(cast["embed"], params["embed"].to(torch.bfloat16))
        # the MoE router is read in float32 (the reference's
        # ``xf.astype(f32) @ p["router"].astype(f32)``): a bf16 router
        # would pick other experts; the expert stacks and the shared
        # expert are read in the compute dtype
        for name, lp in cast["units"][0].items():
            moe = lp.get("mlp", {})
            if "router" in moe:
                assert moe["router"].dtype == torch.float32
                assert torch.equal(
                    moe["router"],
                    params["units"][0][name]["mlp"]["router"])
                for leaf in ("w_gate", "w_up", "w_down"):
                    assert moe[leaf].dtype == torch.bfloat16
                for leaf in moe.get("shared", {}).values():
                    assert leaf.dtype == torch.bfloat16
    assert "router" in PM.F32_LEAVES


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_cast_as_drawn(arch):
    """``init_params(cast=True)``, which casts each piece as it is drawn,
    gives the same tree, dtypes and values as ``cast_params`` of the
    float32 masters from the same generator."""
    from repro_torch.configs import get_smoke_config as p_smoke
    cfg = p_smoke(arch)
    want = PM.cast_params(
        cfg, PM.init_params(cfg, torch.Generator().manual_seed(5)))
    got = PM.init_params(cfg, torch.Generator().manual_seed(5), cast=True)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_cached_conv_state_does_not_hold_the_prompt():
    """The Mamba2 conv state cached by a prefill is a copy of the last
    d_conv - 1 positions, not a view that keeps the whole padded prompt
    alive in the cache."""
    x = torch.randn(2, 300, 32)
    _, state = PL._causal_conv(x, torch.randn(4, 32), torch.zeros(32))
    assert state.shape == (2, 3, 32)
    assert state.untyped_storage().nbytes() == state.numel() * 4
