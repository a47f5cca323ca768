"""The vocabulary-parallel loss: under tensor parallelism over
``"model"`` the logits stay cut on the vocabulary and ``loss_fn`` reduces
over the cut (``runtime.context.vocab_ce``), as the reference's loss
reduces over its logits left on ``"model"``.

One baseline step's loss and gradients (before the update) on a (2, 2)
("data", "model") mesh, each rank on its slice of the weights and its
rows of the global batch, the gradients summed over ``"data"``
(``tests/torch_mesh_workers.py`` kind ``tp_grads``, one spawn of 4 gloo
ranks), against ``jax.value_and_grad`` of the reference's ``loss_fn`` on
the whole batch, from the same weights: qwen3-1.7b at its smoke widths
(tied embeddings; its 128 tokens padded to 256, so the second TP rank's
columns are all padding) and qwen1.5-110b's smoke config with a
vocabulary of 200 (an untied head, QKV biases; the second rank holds 72
real columns and 56 padded ones), float32.  Held: the loss within 1e-5
relative, every gradient leaf joined from the ranks' slices within 1e-5
of the tree's largest |gradient| (the tolerance of
``tests/test_torch_train_frontends.py``), and the collective tally of
the loss and its backward: three small all-reduces (``tp_loss``) and no
gather of the logits (``tp_cat``).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, SyntheticStream
from repro_torch.convert import (model_config_from_fields,
                                 model_params_from_numpy)
from repro_torch.core.engine import tree_flatten
from repro_torch.launch import sharding as SH
from repro_torch.models import model as PM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = 4
ARCHS = {"qwen3-1.7b": {}, "qwen1.5-110b": {"vocab_size": 200}}
S, GB = 16, 4
TOL = 1e-5
MESH = SH.AbstractMesh((2, 2), ("data", "model"))


def _jcfg(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               dp_mode="replicated", **ARCHS[arch])


def _cfg(arch: str):
    return model_config_from_fields(dataclasses.asdict(_jcfg(arch)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab_loss")
    inputs, cases, full = {}, [], {}
    for arch in ARCHS:
        params = PM.init_params(_cfg(arch), torch.Generator().manual_seed(0))
        full[arch] = params
        for i, t in enumerate(tree_flatten(params)[0]):
            inputs[f"p/{arch}/{i}"] = t.numpy()
        batch = SyntheticStream(DataConfig(
            seq_len=S, global_batch=GB, seed=0), _jcfg(arch)).global_batch(0)
        for k in ("tokens", "labels"):
            inputs[f"b/{arch}/{k}"] = batch[k]
        cases.append(dict(kind="tp_grads", name=arch,
                          cfg=dataclasses.asdict(_cfg(arch)),
                          params=f"p/{arch}", batch=f"b/{arch}",
                          mesh=((2, 2), ("data", "model"))))
    outs = W.run_job(str(tmp), cases, inputs, RANKS, timeout_s=240)
    return outs, full, inputs


@pytest.mark.parametrize("arch", list(ARCHS))
def test_vocab_parallel_loss_matches_reference(run, arch):
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    outs, full, inputs = run
    jcfg = _jcfg(arch)
    batch = {k: jnp.asarray(inputs[f"b/{arch}/{k}"])
             for k in ("tokens", "labels")}
    jparams = jax.tree.map(jnp.asarray, W.to_reference(full[arch]))
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch, total_tokens=GB * S)))(jparams)
    cfg = _cfg(arch)
    want = tree_flatten(model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu"))[0]
    _, rebuild = tree_flatten(PM.init_params(cfg, torch.device("meta")))
    slices = []
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{arch}/loss"], float(loss),
                                   rtol=TOL, err_msg=f"rank {r}")
        # the loss gathers no logits: three float32 (B, S) all-reduces
        assert f"{arch}/calls_tp_cat" not in out
        assert int(out[f"{arch}/calls_tp_loss"]) == 3
        slices.append(rebuild([torch.from_numpy(out[f"{arch}/g{i}"])
                               for i in range(len(want))]))
    got = tree_flatten(SH.unshard_tree(cfg, slices, MESH))[0]
    scale = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL * scale,
                                   err_msg=f"{arch} leaf {i}")
