"""Expert parallelism of the port's MoE MLP on 2 gloo ranks, on the CPU.

One spawn of 2 rank processes (``tests/torch_mesh_workers.py``, kind
``moe``): each rank holds half the experts and runs ``moe_forward``
under an expert-axis context -- ``moe_distributed`` (two ``all_to_all``
exchanges) on its own (2, 16) tokens and ``moe_distributed_replicated``
(one float32 ``all_reduce``) on one token every rank holds -- beside
``moe_local`` over all the experts on the same rank.  Each output must
be within 2e-4 of the port's ``moe_local`` and of the JAX package's
``moe_local`` on the same weights (the reference's
``tests/test_distributed.py::test_moe_distributed_matches_local_2dev``
tolerance).  The configs are qwen3-moe's smoke config (top-2 of 8) and
llama4-maverick's (top-1 of 4 and a shared expert), at their own
capacity factor of 1.25 on tokens skewed so that pairs drop.  A float8
dispatch (``moe.dispatch_dtype``) stays near the float32 result without
equalling it.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models import layers as JL
from repro.models import model as JM

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_workers as W  # noqa: E402

RANKS = 2
ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
B, S = 2, 16
EP_TOL = 2e-4


def _layer(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    i = next(i for i, s in enumerate(cfg.pattern) if s.mlp == "moe")
    params = JM.init_params(cfg, jax.random.PRNGKey(4))
    mlp = jax.tree.map(lambda a: np.asarray(a[0]),
                       params["units"])[f"layer{i}"]["mlp"]
    return cfg, mlp


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(11)
    cases, inputs, ref = [], {}, {}
    for a, arch in enumerate(ARCHS):
        cfg, mlp = _layer(arch)
        d = cfg.d_model
        u = rng.standard_normal(d)
        x = (rng.standard_normal((RANKS, B, S, d)) + 2.0 * u) / np.sqrt(5.0)
        inputs.update(_flat(mlp, f"p{a}"))
        inputs[f"x{a}"] = x.astype(np.float32)
        inputs[f"x1_{a}"] = rng.standard_normal((1, 1, d)).astype(np.float32)
        cases.append(dict(kind="moe", name=arch, params=f"p{a}",
                          x=f"x{a}", x1=f"x1_{a}",
                          cfg=dataclasses.asdict(cfg),
                          mesh=((RANKS,), ("data",)), dp_axes=("data",)))
        ref[arch] = (cfg, mlp)
    outs = W.run_job(str(tmp_path_factory.mktemp("moe")), cases, inputs,
                     RANKS, timeout_s=240)
    return inputs, ref, outs


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_distributed_matches_local(run, arch):
    inputs, ref, outs = run
    cfg, mlp = ref[arch]
    a = ARCHS.index(arch)
    jp = jax.tree.map(jnp.asarray, mlp)
    dropped = 0
    for r, out in enumerate(outs):
        x = inputs[f"x{a}"][r]
        want = np.asarray(JL.moe_local(cfg, jp, jnp.asarray(x)))
        for got in (out[f"{arch}/dist"], out[f"{arch}/local"]):
            np.testing.assert_allclose(got, want, atol=EP_TOL, rtol=EP_TOL)
        np.testing.assert_allclose(out[f"{arch}/dist"], out[f"{arch}/local"],
                                   atol=EP_TOL, rtol=EP_TOL)
        idx, _ = JL._router(cfg, jp, jnp.asarray(x.reshape(-1, cfg.d_model)))
        slot, C = JL._dispatch_slots(cfg, idx, B * S)
        dropped += int((np.asarray(slot) == cfg.moe.n_experts * C).sum())
    assert dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_replicated_matches_local(run, arch):
    inputs, ref, outs = run
    cfg, mlp = ref[arch]
    a = ARCHS.index(arch)
    x1 = inputs[f"x1_{a}"]
    want = np.asarray(JL.moe_local(cfg, jax.tree.map(jnp.asarray, mlp),
                                   jnp.asarray(x1)))
    for out in outs:
        np.testing.assert_allclose(out[f"{arch}/rep"], want, atol=EP_TOL,
                                   rtol=EP_TOL)
        np.testing.assert_allclose(out[f"{arch}/rep"], out[f"{arch}/local1"],
                                   atol=EP_TOL, rtol=EP_TOL)
    np.testing.assert_array_equal(outs[0][f"{arch}/rep"],
                                  outs[1][f"{arch}/rep"])


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_dispatch_is_honoured(run, arch):
    """The float8 dispatch rounds the tokens the experts see: within a
    float8 rounding (2^-3 relative) of the float32 result, not equal."""
    _, _, outs = run
    for out in outs:
        got, want = out[f"{arch}/dist_fp8"], out[f"{arch}/local"]
        assert not np.array_equal(got, want)
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 2 ** -3 * scale
