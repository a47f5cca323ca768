"""The port's MoE MLP against the JAX package's, function by function.

On the three MoE smoke configs (qwen3-moe: 8 experts top-2; llama4-
maverick: 4 experts top-1 and a shared expert; jamba: 4 experts top-2)
in float32, on the reference's weights (``init_params(cfg, PRNGKey(2))``,
carried across by ``repro_torch.convert``) and inputs drawn from a numpy
seed.  The router's ids and the dispatch slots must be equal, the
router's weights within 1e-6 (the float32 logits are sums taken in
another order by XLA and torch), ``moe_local`` and the chunked path
within 1e-5.  The capacity is checked at a factor of 16, where nothing
drops, and at the configs' own 1.25 on inputs skewed toward a few
experts, where pairs drop (each test asserts that some do).
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

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b"]
B, S = 2, 40
ROUTER_TOL = 1e-6
MOE_TOL = 1e-5


def _with_cf(cfg, cf: float):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(jax cfg, jax MoE params, port cfg, port MoE params) of the first
    MoE layer of unit 0."""
    jcfg = dataclasses.replace(get_smoke_config(request.param),
                               dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(pcfg,
                                      jax.tree.map(np.asarray, jparams))
    i = next(i for i, s in enumerate(jcfg.pattern) if s.mlp == "moe")
    jl = jax.tree.map(lambda a: a[0], jparams["units"])[f"layer{i}"]["mlp"]
    return jcfg, jl, pcfg, pparams["units"][0][f"layer{i}"]["mlp"]


def _x(cfg, seed: int, skew: float = 0.0, shape=(B, S)) -> np.ndarray:
    """N(0, 1) tokens; ``skew`` adds one shared direction to every token,
    so most of them pick the same experts and the capacity bites (scaled
    back to unit variance, so the outputs keep the scale the tolerances
    are set for)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    return ((x + skew * u) / np.sqrt(1.0 + skew ** 2)).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _routes(jcfg, jl, pcfg, pl, x):
    xf = x.reshape(-1, jcfg.d_model)
    jidx, jw = JL._router(jcfg, jl, jnp.asarray(xf))
    pidx, pw = PL._router(pcfg, pl, _t(xf))
    return np.asarray(jidx), np.asarray(jw), pidx, pw


@pytest.mark.parametrize("skew", [0.0, 4.0])
def test_router(layer, skew):
    jcfg, jl, pcfg, pl = layer
    jidx, jw, pidx, pw = _routes(jcfg, jl, pcfg, pl, _x(jcfg, 0, skew))
    assert pidx.shape == jidx.shape == (B * S, jcfg.moe.top_k)
    np.testing.assert_array_equal(pidx.numpy(), jidx)
    _close(pw, jw, ROUTER_TOL)
    assert pw.dtype == torch.float32


def test_router_ties_go_to_the_lower_id():
    """Equal logits: the lower expert id first, as ``jax.lax.top_k``."""
    jcfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"),
                               dtype="float32")
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    E, d = jcfg.moe.n_experts, jcfg.d_model
    router = np.zeros((d, E), np.float32)
    router[0] = [1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 3.0, 1.0][:E]
    x = np.zeros((3, d), np.float32)
    x[:, 0] = [1.0, 0.0, -1.0]
    jidx, jw = JL._router(jcfg, {"router": jnp.asarray(router)},
                          jnp.asarray(x))
    pidx, pw = PL._router(pcfg, {"router": _t(router)}, _t(x))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pidx.numpy(), [[1, 2], [0, 1], [5, 0]])
    _close(pw, jw, 0.0)


@pytest.mark.parametrize("cf", [16.0, 1.25, 1.0, 0.5])
def test_capacity(cf):
    jcfg = _with_cf(get_smoke_config("qwen3-moe-235b-a22b"), cf)
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    for T in (1, 4, 7, 80, 81, 1000, 4096, 8192):
        assert PL._capacity(pcfg, T) == JL._capacity(jcfg, T), (cf, T)


@pytest.mark.parametrize("cf, skew", [(16.0, 0.0), (1.25, 4.0)])
def test_dispatch_slots(layer, cf, skew):
    """Slots bit-equal; at 1.25 on skewed tokens some pairs drop (the
    sink slot E * C_e) and the kept slots are distinct."""
    jcfg, jl, pcfg, pl = layer
    jcfg, pcfg = _with_cf(jcfg, cf), _with_cf(pcfg, cf)
    jidx, _, pidx, _ = _routes(jcfg, jl, pcfg, pl, _x(jcfg, 1, skew))
    T = B * S
    jslot, jC = JL._dispatch_slots(jcfg, jnp.asarray(jidx), T)
    pslot, pC = PL._dispatch_slots(pcfg, pidx, T)
    assert pC == jC
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
    sink = jcfg.moe.n_experts * jC
    dropped = int((pslot == sink).sum())
    kept = pslot[pslot != sink]
    assert kept.unique().numel() == kept.numel()
    if cf == 16.0:
        assert dropped == 0
    else:
        assert dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_slots_at_full_width(arch):
    """The full configs' expert counts and top-k over 4,096 tokens, ids
    drawn skewed toward the low experts (a power law), so the heavy
    experts overflow their capacity: slots bit-equal to the reference's
    one-hot cumsum, drops included."""
    from repro.configs import get_config
    jcfg = get_config(arch)
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    E, k, T = jcfg.moe.n_experts, jcfg.moe.top_k, 4096
    rng = np.random.default_rng(8)
    w = 1.0 / np.arange(1, E + 1)
    idx = np.stack([rng.choice(E, size=k, replace=False, p=w / w.sum())
                    for _ in range(T)]).astype(np.int32)
    jslot, C = JL._dispatch_slots(jcfg, jnp.asarray(idx), T)
    pslot, pC = PL._dispatch_slots(pcfg, torch.from_numpy(idx).long(), T)
    assert pC == C
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
    assert int((pslot == E * C).sum()) > 0


@pytest.mark.parametrize("cf, skew", [(16.0, 0.0), (1.25, 0.0), (1.25, 4.0)])
def test_moe_local(layer, cf, skew):
    jcfg, jl, pcfg, pl = layer
    jcfg, pcfg = _with_cf(jcfg, cf), _with_cf(pcfg, cf)
    x = _x(jcfg, 2, skew)
    got = PL.moe_local(pcfg, pl, _t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, JL.moe_local(jcfg, jl, jnp.asarray(x)), MOE_TOL)
    if skew:
        _, _, pidx, _ = _routes(jcfg, jl, pcfg, pl, x)
        slot, C = PL._dispatch_slots(pcfg, pidx, B * S)
        assert int((slot == pcfg.moe.n_experts * C).sum()) > 0


@pytest.mark.parametrize("skew", [0.0, 4.0])
def test_moe_seq_chunks(layer, skew):
    """``moe_seq_chunks = 2``: each half of the sequence dispatched with
    the capacity of its own tokens, through ``moe_forward``; equal to the
    reference's chunked path and to ``moe_local`` of each half."""
    jcfg, jl, pcfg, pl = layer
    jcfg = dataclasses.replace(jcfg, moe_seq_chunks=2)
    pcfg = dataclasses.replace(pcfg, moe_seq_chunks=2)
    x = _x(jcfg, 3, skew)
    got = PL.moe_forward(pcfg, pl, _t(x))
    _close(got, JL.moe_forward(jcfg, jl, jnp.asarray(x)), MOE_TOL)
    halves = torch.cat([PL.moe_local(pcfg, pl, _t(x[:, :S // 2])),
                        PL.moe_local(pcfg, pl, _t(x[:, S // 2:]))], dim=1)
    assert torch.equal(got, halves)
    # a sequence that the chunk count does not divide is not split
    x = _x(jcfg, 4, skew, shape=(B, S - 1))
    assert torch.equal(PL.moe_forward(pcfg, pl, _t(x)),
                       PL.moe_local(pcfg, pl, _t(x)))


def test_shared_expert():
    """llama4-maverick's shared expert, and that ``moe_local`` adds it."""
    jcfg = dataclasses.replace(get_smoke_config("llama4-maverick-400b-a17b"),
                               dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(pcfg,
                                      jax.tree.map(np.asarray, jparams))
    jl = jax.tree.map(lambda a: a[0], jparams["units"])["layer1"]["mlp"]
    pl = pparams["units"][0]["layer1"]["mlp"]
    assert set(pl["shared"]) == {"w_gate", "w_up", "w_down"}
    xf = _x(jcfg, 5).reshape(-1, jcfg.d_model)
    sh = PL._shared_expert(pl, _t(xf))
    assert sh.dtype == torch.float32
    _close(sh, JL._shared_expert(jl, jnp.asarray(xf)), MOE_TOL)
    no_shared = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, d_shared=0))
    x = _t(xf.reshape(B, S, -1))
    _close(PL.moe_local(pcfg, pl, x) - PL.moe_local(no_shared, pl, x),
           sh.reshape(B, S, -1), MOE_TOL)


def test_bf16_routes_as_the_reference(layer):
    """bf16 tokens: the router still reads float32 (logits of the same
    bf16 values, a float32 router), so the ids and slots equal the
    reference's, drops included, and the output is a few bf16 roundings
    away."""
    jcfg, jl, pcfg, pl = layer
    x = _x(jcfg, 6, 4.0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jidx, _ = JL._router(jcfg, jl, xj.reshape(-1, jcfg.d_model))
    pidx, _ = PL._router(pcfg, pl, xb.reshape(-1, pcfg.d_model))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    jslot, C = JL._dispatch_slots(jcfg, jidx, B * S)
    pslot, _ = PL._dispatch_slots(pcfg, pidx, B * S)
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
    assert int((pslot == pcfg.moe.n_experts * C).sum()) > 0
    cast = PM.cast_params(pcfg, {"mlp": pl})["mlp"]
    assert cast["router"].dtype == torch.float32
    assert cast["w_gate"].dtype == torch.float32   # float32 compute here
    got = PL.moe_local(pcfg, pl, xb)
    want = JL.moe_local(jcfg, jl, xj)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # bf16 products and sums rounded in other places by XLA and torch:
    # two bf16 ulps (2^-7 relative), over a floor of 2^-6 of the largest
    # entry where terms cancel
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -6 * float(np.abs(want).max()))


def test_expert_leaves_split_per_unit():
    """The reference's stacked expert leaves (n_units, E, d, f) carry
    across as one (E, d, f) stack a unit, in order."""
    jcfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"),
                               dtype="float32")
    assert jcfg.n_units == 2
    jparams = jax.tree.map(np.asarray,
                           JM.init_params(jcfg, jax.random.PRNGKey(7)))
    pcfg = model_config_from_fields(dataclasses.asdict(jcfg))
    pparams = model_params_from_numpy(pcfg, jparams)
    m = jcfg.moe
    ref = jparams["units"]["layer0"]["mlp"]
    assert ref["w_gate"].shape == (2, m.n_experts, jcfg.d_model, m.d_expert)
    assert ref["w_down"].shape == (2, m.n_experts, m.d_expert, jcfg.d_model)
    for u in range(2):
        got = pparams["units"][u]["layer0"]["mlp"]
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(got[name].numpy(), ref[name][u])
    assert not np.array_equal(ref["w_gate"][0], ref["w_gate"][1])


def test_expert_draws_equal_at_any_storage_dtype():
    """``make_moe_params`` draws each expert's matrix in float32 and
    stores it in ``expert_dtype``: the bf16 stacks are the float32 ones
    rounded, and the router and shared expert are drawn alike."""
    from repro_torch.configs import get_smoke_config as p_smoke
    cfg = p_smoke("llama4-maverick-400b-a17b")
    f32 = PL.make_moe_params(cfg, torch.Generator().manual_seed(3))
    b16 = PL.make_moe_params(cfg, torch.Generator().manual_seed(3),
                             torch.bfloat16)
    for name in ("w_gate", "w_up", "w_down"):
        assert b16[name].dtype == torch.bfloat16
        assert torch.equal(b16[name], f32[name].to(torch.bfloat16))
    assert torch.equal(b16["router"], f32["router"])
    for name, leaf in f32["shared"].items():
        assert torch.equal(b16["shared"][name], leaf)


def test_expert_axis_of_one_runs_local(layer):
    """An expert axis of size 1 in the context runs ``moe_local``, and so
    does a context without a mesh or without an expert axis."""
    import types

    from repro_torch.runtime.context import DistCtx, use_ctx
    _, _, pcfg, pl = layer
    x = _t(_x(pcfg, 9))
    want = PL.moe_local(pcfg, pl, x)
    one = types.SimpleNamespace(shape={"data": 1})
    for ctx in (DistCtx(), DistCtx(mesh=one, dp_axes=("data",)),
                DistCtx(mesh=one, dp_axes=("data",), ep_axis="data")):
        with use_ctx(ctx):
            assert torch.equal(PL.moe_forward(pcfg, pl, x), want)
