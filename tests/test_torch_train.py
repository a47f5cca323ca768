"""The port's training path against the JAX package, on the CPU.

* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn`` on the reference's weights carried
  across (``convert``), float32 smoke configs of qwen3-1.7b, olmo-1b,
  mamba2-370m (its SSD scan differentiated by the port's
  ``_SSDChunked``), command-r-35b and qwen1.5-110b (seeded nonzero QKV
  biases, an untied head), with and without remat: loss to 1e-5, every
  gradient leaf to 2e-4 of the largest gradient (float32 sums in other
  orders through two layers and the head).
* ``train_loop`` against the reference's ``train_loop`` from the same
  parameters and data, plain and secure (a one-rank mesh: mask,
  quantize and unmask active), 4 steps, AdamW's moments in the full
  config's ``opt_state_dtype`` (bfloat16 for qwen1.5-110b): per-step
  losses to 2e-4 relative (the two differ by float32 rounding of the gradients, which
  AdamW's first steps turn into updates of up to lr each).
* ``train_loop`` resumed from the reference's weights and AdamW state
  after 4 steps (carried across by ``convert``, written as the port's
  checkpoint) against the reference's own resume from its checkpoint of
  the same step: losses to 2e-4 relative, as above.
* The reference's ``tests/test_train_e2e.py`` cases on the port: loss
  decreases, crash and restart resume exactly (rtol 1e-5), secure
  training within 2e-3 of the baseline.
* A Mamba2 model under autograd runs its SSD backward on the CPU (the
  plain backward) and on the card (the kernel); on any other device,
  shown on ``meta``, the scan raises rather than run a plain version.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as j_mesh
from repro.launch.train import train_loop as j_train
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch.checkpoint import ckpt as PCK
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy,
                                 opt_config_from_fields,
                                 opt_state_from_numpy)
from repro_torch.kernels import backend
from repro_torch.launch.train import train_loop
from repro_torch.models import model as PM
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailurePlan, InjectedCrash
from test_torch_models import seeded_biases

SHAPE = ShapeConfig("t", 64, 4, "train")
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=100,
                      grad_clip=1.0)
ARCHS = ["qwen3-1.7b", "olmo-1b", "mamba2-370m", "command-r-35b",
         "qwen1.5-110b"]


def _pair(arch, **kw):
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **kw)
    return jcfg, model_config_from_fields(dataclasses.asdict(jcfg))


def _params(jcfg, pcfg, seed=0, biases=False):
    """The reference's draw and its copy in the port; ``biases`` sets the
    QKV biases (zeros as drawn) to seeded nonzero values in both."""
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    if biases:
        jp = seeded_biases(jp, seed + 1)
    return jp, model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, jp), "cpu")


def _batch(pcfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, pcfg.vocab_size, size=(2, 33)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                    # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    jcfg, pcfg = _pair(arch, remat=remat)
    jp, pp = _params(jcfg, pcfg, biases=True)
    batch = _batch(pcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch, total_tokens=64))(jp)
    leaves = [t for t in jax.tree.leaves(pp)]
    for t in leaves:
        t.requires_grad_(True)
    ploss = PM.loss_fn(pcfg, pp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                       total_tokens=64)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    want = model_params_from_numpy(pcfg, jax.tree.map(np.asarray, jgrads))
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(jgrads))
    for got, w in zip(jax.tree.leaves(pp), jax.tree.leaves(want)):
        np.testing.assert_allclose(got.grad.numpy(), w.numpy(),
                                   atol=2e-4 * scale, rtol=0)


def _j_opt(arch="qwen3-1.7b"):
    """``OPT`` with AdamW's moments in ``arch``'s full-config dtype."""
    return JA.OptConfig(**{**dataclasses.asdict(OPT),
                           "state_dtype": j_full(arch).opt_state_dtype})


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_losses_match_reference(arch, secure):
    jcfg, pcfg = _pair(arch)
    jshape = JShape("t", 64, 4, "train")
    want = j_train(jcfg, j_mesh(), steps=4, shape=jshape,
                   opt_cfg=_j_opt(arch), secure=secure, log_every=1000)
    _, pp = _params(jcfg, pcfg)
    got = train_loop(pcfg, steps=4, shape=SHAPE, secure=secure,
                     opt_cfg=opt_config_from_fields(
                         dataclasses.asdict(_j_opt(arch))),
                     log_every=1000, device="cpu", params=pp)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_from_reference_opt_state(arch, tmp_path):
    jcfg, pcfg = _pair(arch)
    jshape = JShape("t", 64, 4, "train")
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    kw = dict(shape=jshape, opt_cfg=_j_opt(arch), log_every=1000)
    first = j_train(jcfg, j_mesh(), steps=4, ckpt_dir=jdir, ckpt_every=4,
                    **kw)
    want = j_train(jcfg, j_mesh(), steps=6, ckpt_dir=jdir, ckpt_every=4,
                   **kw)
    assert want["resumed_from"] == 4
    state = opt_state_from_numpy(
        pcfg, jax.tree.map(np.asarray, first["opt_state"]))
    assert int(state["step"]) == 4
    PCK.save(pdir, 4, model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, first["params"])))
    PCK.save(pdir + "/opt", 4, state)
    got = train_loop(pcfg, steps=6, shape=SHAPE, ckpt_dir=pdir,
                     opt_cfg=opt_config_from_fields(
                         dataclasses.asdict(_j_opt(arch))),
                     log_every=1000, device="cpu")
    assert got["resumed_from"] == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)


def test_loss_decreases():
    cfg = get_smoke_config("olmo-1b")
    out = train_loop(cfg, steps=30, shape=SHAPE, opt_cfg=OPT,
                     log_every=1000, device="cpu")
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 0.3


def test_crash_restart_resumes_exactly(tmp_path):
    cfg = get_smoke_config("qwen3-1.7b")
    ck = str(tmp_path / "ck")
    ref = train_loop(cfg, steps=16, shape=SHAPE, opt_cfg=OPT,
                     log_every=1000, device="cpu")
    plan = FailurePlan(crash_at_steps=(10,))
    with pytest.raises(InjectedCrash):
        train_loop(cfg, steps=16, shape=SHAPE, opt_cfg=OPT, ckpt_dir=ck,
                   ckpt_every=8, failure_plan=plan, log_every=1000,
                   device="cpu")
    out = train_loop(cfg, steps=16, shape=SHAPE, opt_cfg=OPT, ckpt_dir=ck,
                     ckpt_every=8, log_every=1000, device="cpu")
    assert out["resumed_from"] == 8
    np.testing.assert_allclose(out["losses"][-1], ref["losses"][-1],
                               rtol=1e-5)


def test_secure_matches_baseline_trajectory():
    """The paper's aggregation path reproduces baseline training within
    fixed-point quantization error (one-rank mesh: n_nodes = 1 keeps the
    full mask / quantize / unmask dataflow active)."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    base = train_loop(cfg, steps=10, shape=SHAPE, opt_cfg=OPT,
                      log_every=1000, device="cpu")
    sec = train_loop(cfg, steps=10, shape=SHAPE, opt_cfg=OPT, secure=True,
                     log_every=1000, device="cpu")
    np.testing.assert_allclose(sec["losses"], base["losses"], atol=2e-3)


def test_train_loop_runs_on_the_card_unless_asked(monkeypatch):
    """The default device is the card; without one the loop raises
    before it builds anything, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(get_smoke_config("olmo-1b"), steps=1, shape=SHAPE)


def test_mamba2_backward_off_the_cpu_raises():
    """The SSD scan's backward runs on the CPU (the plain version) and the
    card (the kernel) only: a ``meta`` tensor that needs a gradient
    raises in the scan's dispatch, and nothing runs a plain version in
    its place."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"),
                              dtype="float32")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss = PM.loss_fn(cfg, params, batch)          # no grad: runs
    assert torch.isfinite(loss)
    leaves = jax.tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    PM.loss_fn(cfg, params, batch).backward()      # CPU autograd: allowed
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves)
    meta = jax.tree.map(lambda t: t.detach().to("meta").requires_grad_(True),
                        params)
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        PM.loss_fn(cfg, meta, {k: v.to("meta") for k, v in batch.items()})
    # a frozen input: only the mixers' A_log needs a gradient, so the
    # mixer's input does not, but the scan's operand A does
    frozen = jax.tree.map(lambda t: t.detach().to("meta"), params)
    for unit in frozen["units"]:
        for layer in unit.values():
            layer["mixer"]["A_log"].requires_grad_(True)
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        PM.loss_fn(cfg, frozen, {k: v.to("meta") for k, v in batch.items()})
    assert backend.SSD.launches == backend.SSD_BWD.launches == 0
