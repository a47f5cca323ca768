"""Training of the two frontend models against the JAX package, on the
CPU: hubert-xlarge (an encoder over audio frames, head dim 80 in its
full config) and llama-3.2-vision-90b (cross-attention to media tokens
every fifth layer).

* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn`` on the reference's weights carried
  across (``convert``), float32 smoke configs, a batch of frames (hubert)
  or of tokens and media (llama-vision) drawn from a numpy seed: the
  loss within 1e-5 relative, every gradient leaf within 1e-5 of the
  tree's largest |gradient| (the cross layer's media k, v projections
  get theirs through the attention backward at Sq != Skv).
* ``train_loop`` against the reference's ``train_loop`` from the same
  parameters and the synthetic stream's frames / media, plain and secure
  (a one-rank mesh: mask, quantize and unmask active), 4 steps: losses
  within 2e-4 relative, as ``tests/test_torch_train.py`` holds the
  dense models.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_mesh
from repro.launch.train import train_loop as j_train
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy,
                                 opt_config_from_fields)
from repro_torch.launch.train import train_loop
from repro_torch.models import model as PM

ARCHS = ["hubert-xlarge", "llama-3.2-vision-90b"]
B, S = 2, 32
LOSS_RTOL, GRAD_SHARE = 1e-5, 1e-5
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=100, grad_clip=1.0)


def pair(arch: str, seed: int = 0, **kw):
    """(jax cfg, jax params, port cfg, port params): float32 smoke
    config, the reference's draw and its copy in the port."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **kw)
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, pcfg, model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, jp), "cpu")


def batch_of(cfg, seed: int = 5) -> dict:
    """A numpy batch the config reads: frames or tokens (with media for
    a vision model), labels with masked positions."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    if cfg.frontend == "audio_frames":
        out = {"frames": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size,
                                      (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["media"] = rng.standard_normal(
            (B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    return {**out, "labels": labels}


def check_loss_and_grads(jcfg, jp, pcfg, pp, batch) -> None:
    """The port's loss and autograd gradients against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    total = B * S
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch, total_tokens=total))(jp)
    leaves = jax.tree.leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    ploss = PM.loss_fn(pcfg, pp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                       total_tokens=total)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    want = model_params_from_numpy(pcfg, jax.tree.map(np.asarray, jgrads))
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(jgrads))
    got = jax.tree.leaves(pp)
    assert len(got) == len(jax.tree.leaves(want))
    for g, w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.grad.numpy(), w.numpy(),
                                   atol=GRAD_SHARE * scale, rtol=0)


def train_losses(jcfg, pcfg, pp, secure: bool, steps: int = 4):
    """(port losses, reference losses) of ``train_loop`` from the
    reference's seed-0 draw, AdamW's moments in float32."""
    jopt = JA.OptConfig(**OPT)
    want = j_train(jcfg, j_mesh(), steps=steps,
                   shape=JShape("t", S, B * 2, "train"), opt_cfg=jopt,
                   secure=secure, log_every=1000)
    got = train_loop(pcfg, steps=steps, shape=ShapeConfig("t", S, B * 2,
                                                          "train"),
                     secure=secure,
                     opt_cfg=opt_config_from_fields(dataclasses.asdict(jopt)),
                     log_every=1000, device="cpu", params=pp)
    return got["losses"], want["losses"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, jp, pcfg, pp = pair(arch)
    check_loss_and_grads(jcfg, jp, pcfg, pp, batch_of(jcfg))


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_losses_match_reference(arch, secure):
    jcfg, _, pcfg, pp = pair(arch)
    got, want = train_losses(jcfg, pcfg, pp, secure)
    np.testing.assert_allclose(got, want, rtol=2e-4)
