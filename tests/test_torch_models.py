"""The port's model stack against the JAX package on the smoke configs.

Both archs of the serving slice (qwen3-1.7b: GQA attention with qk-norm
and a SwiGLU MLP; mamba2-370m: Mamba2 SSD layers) run in float32 on the
weights the reference draws (``M.init_params(cfg, PRNGKey(2))``), carried
across by ``repro_torch.convert``, on CPU tensors, so the kernel wrappers
run their plain versions.  Tolerances are those of
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

from repro.configs import get_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.models import layers as PL
from repro_torch.models import model as PM

ARCHS = ["qwen3-1.7b", "mamba2-370m"]
B, S, S_MAX = 2, 24, 48
LAYER_TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) for one arch."""
    jcfg = dataclasses.replace(get_smoke_config(request.param),
                               dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
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


def test_mixer_and_mlp(pair):
    """qk-normed q, k, v and the SwiGLU MLP (qwen3); the Mamba2 block's
    prefill and one decode step from its state (mamba2)."""
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
        _close(PL.mlp_forward(pcfg, pl["mlp"], _t(x)),
               JL.mlp_forward(jcfg, jl["mlp"], jnp.asarray(x)), LAYER_TOL)
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


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b", "hubert-xlarge",
                                  "llama4-maverick-400b-a17b",
                                  "qwen1.5-110b"])
def test_later_slices_raise(arch):
    """MoE, cross-attention, frontends and the other configs' features
    (QKV biases, untied heads) are later slices of the port.  (The
    layernorm norms came with the training slice: olmo-1b runs, see
    ``tests/test_torch_train.py``.)"""
    cfg = model_config_from_fields(dataclasses.asdict(get_smoke_config(arch)))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PM.init_params(cfg, torch.Generator().manual_seed(0))


def test_cast_params_keeps_float32_leaves():
    from repro_torch.configs import get_smoke_config as p_smoke
    for arch in ARCHS:
        cfg = p_smoke(arch)
        params = PM.init_params(cfg, torch.Generator().manual_seed(0))
        cast = PM.cast_params(cfg, params)
        layer = cast["units"][0]["layer0"]
        assert cast["embed"].dtype == torch.bfloat16
        assert layer["norm1"]["scale"].dtype == torch.bfloat16
        for k in PM.F32_LEAVES:
            if k in layer["mixer"]:
                assert layer["mixer"][k].dtype == torch.float32, k
        assert torch.equal(cast["embed"], params["embed"].to(torch.bfloat16))


def test_cached_conv_state_does_not_hold_the_prompt():
    """The Mamba2 conv state cached by a prefill is a copy of the last
    d_conv - 1 positions, not a view that keeps the whole padded prompt
    alive in the cache."""
    x = torch.randn(2, 300, 32)
    _, state = PL._causal_conv(x, torch.randn(4, 32), torch.zeros(32))
    assert state.shape == (2, 3, 32)
    assert state.untyped_storage().nbytes() == state.numel() * 4
