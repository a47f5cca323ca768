"""The port's audio-frames encoder against the JAX package.

hubert-xlarge's smoke config (bidirectional self-attention, LayerNorm,
the GELU MLP, QKV biases, no embedding table and its own head) in
float32, on the reference's weights (``M.init_params(cfg,
PRNGKey(0))``, its zero QKV biases replaced by seeded nonzero ones so the
bias add is tested) carried across by ``repro_torch.convert``, on CPU
tensors, so the flash wrapper runs its plain version.  Frames are drawn
from a seeded numpy generator and handed to both, except where ``encode``
reads the synthetic stream's own frames, as the reference's encoder-only
prefill step reads its batch.  Tolerance 5e-4, as
``tests/test_torch_models.py``'s decode logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro_torch.configs import get_config as p_config
from repro_torch.configs.base import ShapeConfig as PShape
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.launch import serve as P
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as PM
from repro_torch.optim import adamw

ARCH = "hubert-xlarge"
B, S = 2, 32
TOL = 5e-4


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    for lp in jparams["units"].values():
        for name in ("bq", "bk", "bv"):
            lp["mixer"][name] = jnp.asarray(
                0.5 * rng.standard_normal(lp["mixer"][name].shape),
                jnp.float32)
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(pcfg, jax.tree.map(np.asarray,
                                                         jparams))
    return jcfg, jparams, pcfg, pparams


def _frames(seed: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def test_config_and_parameters_are_the_reference(pair):
    """The full config field for field; no embedding table, its own head,
    in the reference's draw and in the port's."""
    assert dataclasses.asdict(p_config(ARCH)) == \
        dataclasses.asdict(get_config(ARCH))
    _, jparams, pcfg, pparams = pair
    mine = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    for tree in (jparams, pparams, mine):
        assert "embed" not in tree and "head" in tree
    assert tuple(mine["head"].shape) == jparams["head"].shape


def test_forward_matches_the_reference(pair):
    jcfg, jparams, pcfg, pparams = pair
    x = _frames(5, jcfg.d_model)
    want = JM.forward(jcfg, jparams, {"frames": jnp.asarray(x)})
    got = PM.forward(pcfg, pparams, {"frames": torch.from_numpy(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_encode_matches_the_reference_encoder_step(pair):
    """``encode`` is the reference's encoder-only prefill step (its
    inference forward) on the stream's frames."""
    jcfg, jparams, pcfg, pparams = pair
    step, _ = JS.build_prefill_step(jcfg, make_host_mesh(),
                                    ShapeConfig("enc", S, B, "prefill"))
    batch = SyntheticStream(DataConfig(seq_len=S, global_batch=B, seed=0),
                            jcfg).global_batch(0)
    want = step(jparams, {"frames": jnp.asarray(batch["frames"])})
    got = P.encode(pcfg, batch=B, seq_len=S, seed=0, params=pparams,
                   device="cpu")
    assert got["t_s"] > 0 and sum(got["launches"].values()) == 0
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_encoder_is_bidirectional(pair):
    """The port's ``tests/test_models.py::test_encoder_is_bidirectional``:
    a change to the last frame moves position 0's logits."""
    _, _, pcfg, pparams = pair
    x = torch.from_numpy(_frames(6, pcfg.d_model))
    out0 = PM.forward(pcfg, pparams, {"frames": x})
    x2 = x.clone()
    x2[:, -1] += 5.0
    out1 = PM.forward(pcfg, pparams, {"frames": x2})
    assert not torch.allclose(out0[:, 0], out1[:, 0])


def test_serve_and_training_are_refused(pair):
    """No decode for an encoder, as the reference's ``serve`` says;
    training is accepted: ``build_train_step`` takes one step on frames,
    with a finite loss and every weight moved."""
    _, _, pcfg, pparams = pair
    with pytest.raises(ValueError, match="encoder-only"):
        P.serve(pcfg, batch=B, prompt_len=8, gen=2, params=pparams,
                device="cpu")
    params = jax.tree.map(lambda t: t.clone(), pparams)
    step, opt_cfg = build_train_step(pcfg, shape=PShape("t", S, B, "train"))
    labels = np.random.default_rng(8).integers(0, pcfg.vocab_size, (B, S))
    params, _, metrics = step(
        params, adamw.init_opt_state(opt_cfg, params),
        {"frames": torch.from_numpy(_frames(7, pcfg.d_model)),
         "labels": torch.from_numpy(labels.astype(np.int32))})
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(params["head"], pparams["head"])
