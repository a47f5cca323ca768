"""The dense models' remaining layer options against the JAX package.

No registered config of either package sets a GELU MLP, an embedding
multiplier or logit soft-capping, so each runs on a smoke config changed
to set it (``dataclasses.replace``), in float32 on the reference's
weights carried across by ``repro_torch.convert``, on CPU tensors.
Tolerances are ``tests/test_torch_models.py``'s: 1e-5 for one layer,
2e-4 for forward logits, 5e-4 for decode logits.

* The GELU MLP (``mlp_gated=False``: ``w_up`` and ``w_down``, the tanh
  GELU of ``jax.nn.gelu``) layer by layer and through a whole forward.
* ``embedding_multiplier=12.0`` through a whole forward.
* ``logit_softcap=30.0`` in ``decode_attention`` on scores far past the
  cap, and in ``decode_step`` after a prefill without it.
* A prefill (and a training forward) with soft-capping raises in both
  packages: the reference soft-caps only in decode.
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

B, S, S_MAX = 2, 24, 32
LAYER_TOL, LOGIT_TOL, DECODE_TOL = 1e-5, 2e-4, 5e-4
SOFTCAP = 30.0


def _pair(arch: str, **kw):
    """(jax cfg, jax params, port cfg, port params) of ``arch``'s smoke
    config in float32 with ``kw`` replaced."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(4))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    return jcfg, jparams, pcfg, model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, jparams))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


def _tokens(cfg, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S_MAX)).astype(np.int32)


@pytest.mark.parametrize("arch", ["olmo-1b", "command-r-35b"])
def test_gelu_mlp_matches_reference(arch):
    jcfg, jparams, pcfg, pparams = _pair(arch, mlp_gated=False)
    jl = jax.tree.map(lambda a: a[0], jparams["units"])["layer0"]["mlp"]
    pl = pparams["units"][0]["layer0"]["mlp"]
    assert set(pl) == set(jl) == {"w_up", "w_down"}
    drawn = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in
            drawn["units"][0]["layer0"]["mlp"].items()} == \
        {k: v.shape for k, v in jl.items()}
    assert pcfg.param_count() == jcfg.param_count()
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32) * 2.0
    got = PL.mlp_forward(pcfg, pl, _t(x))
    _close(got, JL.mlp_forward(jcfg, jl, jnp.asarray(x)), LAYER_TOL, "mlp")
    # the tanh approximation, not the exact erf GELU: the two differ by
    # far more than the tolerance on these inputs
    exact = torch.nn.functional.gelu(_t(x) @ pl["w_up"]) @ pl["w_down"]
    assert float((exact - got).abs().max()) > 10 * LAYER_TOL
    toks = _tokens(jcfg)
    _close(PM.forward(pcfg, pparams, {"tokens": _t(toks)}),
           JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}),
           LOGIT_TOL, "forward")


def test_embedding_multiplier_matches_reference():
    jcfg, jparams, pcfg, pparams = _pair("qwen3-1.7b",
                                         embedding_multiplier=12.0)
    toks = _tokens(jcfg, 1)
    _close(PM.embed_inputs(pcfg, pparams, {"tokens": _t(toks)}),
           JM.embed_inputs(jcfg, jparams, {"tokens": jnp.asarray(toks)}),
           0.0, "embedding")
    want = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got = PM.forward(pcfg, pparams, {"tokens": _t(toks)})
    _close(got, want, LOGIT_TOL, "forward")
    # the multiplier moves the logits: the same weights without it differ
    plain = PM.forward(dataclasses.replace(pcfg, embedding_multiplier=1.0),
                       pparams, {"tokens": _t(toks)})
    assert float((plain - got).abs().max()) > 100 * LOGIT_TOL


def test_decode_attention_softcap_matches_reference():
    rng = np.random.default_rng(2)
    H, K, hd, t = 8, 2, 16, 19
    # scores of tens: the cap bends them far from the uncapped ones
    q = (20.0 * rng.standard_normal((B, 1, H, hd))).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S_MAX, K, hd)).astype(np.float32)
              for _ in range(2))
    got = PL.decode_attention(_t(q), _t(kc), _t(vc), t, softcap=SOFTCAP)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.int32(t),
                               softcap=SOFTCAP)
    _close(got, want, LAYER_TOL, "softcap decode attention")
    uncapped = PL.decode_attention(_t(q), _t(kc), _t(vc), t)
    assert float((uncapped - got).abs().max()) > 0.1


def test_decode_step_with_softcap_matches_reference():
    """A prefill without the cap fills the cache (the reference cannot
    prefill with one), then decode steps of the soft-capped config."""
    jcfg, jparams, pcfg, pparams = _pair("qwen3-1.7b")
    jsoft = dataclasses.replace(jcfg, logit_softcap=SOFTCAP)
    psoft = dataclasses.replace(pcfg, logit_softcap=SOFTCAP)
    toks = _tokens(jcfg, 3)
    _, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                           max_seq=S_MAX)
    _, pcache = PM.prefill(pcfg, pparams, {"tokens": _t(toks[:, :S])},
                           max_seq=S_MAX)
    for t in range(S, S + 4):
        jlog, jcache = JM.decode_step(jsoft, jparams, jcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        plog, pcache = PM.decode_step(psoft, pparams, pcache,
                                      _t(toks[:, t:t + 1]), t)
        _close(plog, jlog, DECODE_TOL, f"decode step {t}")


def test_prefill_with_softcap_raises_in_both():
    jcfg, jparams, pcfg, pparams = _pair("qwen3-1.7b",
                                         logit_softcap=SOFTCAP)
    toks = _tokens(jcfg, 4)[:, :S]
    with pytest.raises(NotImplementedError, match="softcap"):
        JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                   max_seq=S_MAX)
    with pytest.raises(NotImplementedError, match="softcap"):
        PM.prefill(pcfg, pparams, {"tokens": _t(toks)}, max_seq=S_MAX)
    with pytest.raises(NotImplementedError, match="softcap"):
        JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    with pytest.raises(NotImplementedError, match="softcap"):
        PM.forward(pcfg, pparams, {"tokens": _t(toks)})
