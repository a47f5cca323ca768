"""Training of the MoE models against the JAX package, on one rank on
the CPU: qwen3-moe-235b (8 experts top-2 in its smoke config) and
llama4-maverick (4 experts top-1 and a shared expert, a chunked window)
here, jamba-v0.1-52b (4 experts top-2 beside Mamba2 layers) in
``tests/test_torch_train_moe_jamba.py`` with the same checks (a file of
its own, so the test workers share its reference's compile time).

The comparisons of ``tests/test_torch_train_frontends.py``, each at a
capacity factor of 16, where nothing drops, and at the configs' own
1.25:

* ``loss_fn`` and its gradients against ``jax.value_and_grad``: the
  loss within 1e-5 relative, every gradient leaf within 1e-5 of the
  tree's largest |gradient|.  At 1.25 the batch draws its tokens from
  four ids, so most tokens pick the same experts and pairs drop (the
  test asserts that some do).
* ``train_loop`` losses against the reference's, plain and secure, 4
  steps, within 2e-4 relative.

And which meshes the steps take an MoE config on: every dp mesh, a
``"pod"`` axis of more than one rank included (the experts split over
``"data"`` and sync over ``"pod"``; the 2-rank steps are held against the
reference in ``tests/test_torch_train_moe_mesh.py``, a pod mesh in
``tests/test_torch_fsdp.py``); an expert count that does not split over
``"data"`` is refused.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.core.schedules import ConfigError
from repro_torch.launch import steps as PS
from repro_torch.models import layers as PL
from test_torch_train_frontends import (batch_of, check_loss_and_grads,
                                        pair, train_losses)

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
FACTORS = [16.0, 1.25]


def moe_pair(arch: str, cf: float):
    jcfg, jp, pcfg, pp = pair(arch)
    jm = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    pm = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=cf))
    return jm, jp, pm, pp


def skewed_batch(cfg) -> dict:
    """``batch_of``'s batch with its tokens drawn from four ids."""
    batch = batch_of(cfg)
    ids = np.random.default_rng(9).integers(0, cfg.vocab_size, 4)
    batch["tokens"] = ids[batch["tokens"] % 4].astype(np.int32)
    return batch


def check_moe_loss_and_grads(arch: str, cf: float, monkeypatch) -> None:
    """``check_loss_and_grads`` at capacity factor ``cf``; pairs drop
    exactly when ``cf`` is below 2."""
    jcfg, jp, pcfg, pp = moe_pair(arch, cf)
    drops = []
    slots = PL._dispatch_slots

    def counted(cfg, idx, T):
        slot, C_e = slots(cfg, idx, T)
        drops.append(int((slot == cfg.moe.n_experts * C_e).sum()))
        return slot, C_e

    monkeypatch.setattr(PL, "_dispatch_slots", counted)
    batch = skewed_batch(jcfg) if cf < 2 else batch_of(jcfg)
    check_loss_and_grads(jcfg, jp, pcfg, pp, batch)
    assert drops and (sum(drops) > 0) == (cf < 2), drops


def check_moe_train_loop(arch: str, cf: float, secure: bool) -> None:
    jcfg, _, pcfg, pp = moe_pair(arch, cf)
    got, want = train_losses(jcfg, pcfg, pp, secure)
    np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, cf, monkeypatch):
    check_moe_loss_and_grads(arch, cf, monkeypatch)


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_losses_match_reference(arch, cf, secure):
    check_moe_train_loop(arch, cf, secure)


def _mesh(**shape):
    """What ``_check_mesh`` reads of a mesh: its axes and their sizes."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


@pytest.mark.parametrize("shape,refused", [
    (dict(data=1, model=1), None),
    (dict(data=2, model=1), None),
    (dict(pod=1, data=2, model=1), None),
    (dict(pod=2, data=2, model=1), None),
    (dict(pod=2, data=1, model=1), None),
    (dict(data=3, model=1), "do not split"),
    (dict(data=2, model=2), None),
    (dict(data=2, model=3), "do not split over the 3 ranks of 'model'"),
], ids=["one_rank", "data2", "pod1_data2", "pod2_data2", "pod2",
        "data3", "model2", "model3"])
def test_moe_meshes_taken_and_refused(shape, refused):
    cfg = p_smoke("qwen3-moe-235b-a22b")
    mesh = _mesh(**shape)
    if refused is None:
        PS._check_mesh(cfg, mesh)
        return
    with pytest.raises(ConfigError, match=refused):
        PS._check_mesh(cfg, mesh)
    if shape.get("model", 1) == 1 and shape["data"] != 3:
        # a dense config trains on the same mesh
        PS._check_mesh(p_smoke("qwen3-1.7b"), mesh)
