"""The port's cross-attention model against the JAX package.

llama-3.2-vision-90b's smoke config (four self-attention layers and a
cross-attention layer to 16 media tokens a unit) in float32, on the
reference's weights (``M.init_params(cfg, PRNGKey(0))``) carried across
by ``repro_torch.convert``, on CPU tensors, so the flash wrapper runs its
plain version.  Prompts and media are drawn from a seeded numpy
generator and handed to both.  Tolerances are ``tests/test_torch_models.
py``'s: 1e-5 for one layer, 5e-4 for logits and caches (float32 sums
taken in other orders by XLA and torch); ``serve``'s greedy tokens are
held equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import serve as j_serve
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config as p_config
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as P
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.optim import adamw

ARCH = "llama-3.2-vision-90b"
B, S, S_MAX = 2, 24, 32
TOL, LAYER_TOL = 5e-4, 1e-5
CROSS = "layer4"            # the pattern's fifth layer


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params, numpy batch)."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(pcfg, jax.tree.map(np.asarray,
                                                         jparams))
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S + 4),
                                    dtype=np.int32),
             "media": rng.standard_normal(
                 (B, jcfg.n_media_tokens, jcfg.d_model)).astype(np.float32)}
    return jcfg, jparams, pcfg, pparams, batch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


def test_config_and_parameter_tree_are_the_reference():
    """The full config field for field; the port's own draw has the
    reference's tree and shapes, ``media_norm`` on the cross layer."""
    assert dataclasses.asdict(p_config(ARCH)) == \
        dataclasses.asdict(get_config(ARCH))
    jcfg = get_smoke_config(ARCH)
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    mine = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))

    def shapes(tree, unit_axis=False):
        return jax.tree.map(
            lambda a: tuple(a.shape[1:] if unit_axis else a.shape), tree)

    want = {k: shapes(v) for k, v in ref.items() if k != "units"}
    want["unit"] = shapes(ref["units"], unit_axis=True)
    got = {k: shapes(v) for k, v in mine.items() if k != "units"}
    got["unit"] = shapes(mine["units"][0])
    assert got == want
    assert "media_norm" in mine["units"][0][CROSS]


def test_cross_layer_matches_the_reference(pair):
    """One cross-attention layer: the forward (q from x, k and v from the
    media, no rope, no mask, Sq != Skv through the flash wrapper) and a
    decode step against the media's K / V."""
    jcfg, jparams, pcfg, pparams, batch = pair
    jl = jax.tree.map(lambda a: a[0], jparams["units"])[CROSS]["mixer"]
    pl = pparams["units"][0][CROSS]["mixer"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    med = batch["media"]
    want = JL.attn_forward(jcfg, jl, jnp.asarray(x), mixer="cross_attn",
                           media=jnp.asarray(med))
    got = PL.attn_forward(pcfg, pl, _t(x), mixer="cross_attn",
                          media=_t(med))
    _close(got, want, LAYER_TOL, "cross attn_forward")
    _, mk, mv = JL._qkv(jcfg, jl, jnp.asarray(x), jnp.asarray(med),
                        jnp.float32)
    cache = {"k": _t(mk), "v": _t(mv)}
    want, jcache = JL.attn_decode(jcfg, jl, jnp.asarray(x[:, :1]),
                                  {"k": mk, "v": mv}, jnp.int32(S),
                                  mixer="cross_attn")
    got, pcache = PL.attn_decode(pcfg, pl, _t(x[:, :1]), cache, S,
                                 mixer="cross_attn")
    _close(got, want, LAYER_TOL, "cross attn_decode")
    assert pcache is cache


def test_forward_prefill_decode_match_the_reference(pair):
    """Logits of the forward, the prefill's last logits and every cache
    (the cross layer's holds the media's K / V), then four decode
    steps."""
    jcfg, jparams, pcfg, pparams, batch = pair
    toks, med = batch["tokens"], batch["media"]
    jb = {"tokens": jnp.asarray(toks), "media": jnp.asarray(med)}
    _close(PM.forward(pcfg, pparams, {"tokens": _t(toks),
                                      "media": _t(med)}),
           JM.forward(jcfg, jparams, jb), TOL, "forward")
    jlog, jcache = JM.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :S]),
                               "media": jnp.asarray(med)}, max_seq=S_MAX)
    plog, pcache = PM.prefill(pcfg, pparams, {"tokens": _t(toks[:, :S]),
                                              "media": _t(med)},
                              max_seq=S_MAX)
    _close(plog, jlog, TOL, "prefill logits")
    assert pcache[0][CROSS]["k"].shape == (B, jcfg.n_media_tokens,
                                           jcfg.n_kv_heads, jcfg.hd)
    for name, leaves in pcache[0].items():
        for k, leaf in leaves.items():
            _close(leaf, jcache[name][k][0], TOL, f"cache {name} {k}")
    for t in range(S, S + 4):
        jlog, jcache = JM.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        plog, pcache = PM.decode_step(pcfg, pparams, pcache,
                                      _t(toks[:, t:t + 1]), t)
        _close(plog, jlog, TOL, f"decode step {t}")


def test_init_cache_sizes_cross_layers_at_the_media(pair):
    jcfg, _, pcfg, _, _ = pair
    want = JM.init_cache(jcfg, B, S_MAX, media_len=jcfg.n_media_tokens)
    got = PM.init_cache(pcfg, B, S_MAX, "cpu",
                        media_len=pcfg.n_media_tokens)
    for name, leaves in got[0].items():
        for k, leaf in leaves.items():
            assert tuple(leaf.shape) == want[name][k].shape[1:], (name, k)


def test_serve_greedy_tokens_equal_the_reference(pair):
    """``serve`` passes the stream's media to the prefill and decodes
    against the cached media K / V: the reference's tokens exactly."""
    jcfg, _, pcfg, pparams, _ = pair
    want = j_serve(jcfg, make_host_mesh(), batch=B, prompt_len=16, gen=6,
                   seed=0)
    got = P.serve(pcfg, batch=B, prompt_len=16, gen=6, seed=0,
                  params=pparams, device="cpu")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_training_is_refused_naming_the_slice(pair):
    """Training is no longer refused: ``build_train_step`` accepts the
    config and takes one step, the cross layers' media k, v projections
    getting gradients (their weights move) and the loss finite."""
    _, _, pcfg, pparams, batch = pair
    params = jax.tree.map(lambda t: t.clone(), pparams)
    before = params["units"][0][CROSS]["mixer"]["wk"].clone()
    step, opt_cfg = build_train_step(
        pcfg, shape=ShapeConfig("t", S, B, "train"))
    data = {"tokens": _t(batch["tokens"][:, :S]),
            "labels": _t(batch["tokens"][:, 1:S + 1]),
            "media": _t(batch["media"])}
    params, _, metrics = step(params, adamw.init_opt_state(opt_cfg, params),
                              data)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(params["units"][0][CROSS]["mixer"]["wk"], before)
