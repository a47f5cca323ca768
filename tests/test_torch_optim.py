"""The port's AdamW, error-feedback compression and data pipeline against
the JAX package.

``apply_updates`` / ``lr_at`` / ``global_norm`` run on one random tree
(numpy, seeded) in both packages and agree to 1e-6 (relative and
absolute: float32 arithmetic in the same order, but XLA's and torch's
``cos`` / ``sqrt`` / power may differ in the last bit).
``compress_with_feedback`` agrees bit for bit, NaN and +-Inf gradients
included: the reference's int8 cast sends NaN to 0 (XLA), the port
sends it to 0 explicitly before torch's cast.  The cases of
``tests/test_optim_data.py`` run on the port as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro.optim import compress as JC
from repro_torch.configs import get_smoke_config
from repro_torch.convert import opt_config_from_fields
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.optim import adamw as P
from repro_torch.optim import compress as PC


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(3, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 2, 4)) * scale
                        ).astype(np.float32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float32)
                        if not isinstance(t, torch.Tensor)
                        else t.float().numpy(), tree)


OPT_CASES = [
    dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=1.0),
    dict(lr=3e-3, warmup_steps=1, total_steps=5, weight_decay=0.0,
         grad_clip=100.0, betas=(0.8, 0.99)),
    dict(lr=1e-3, warmup_steps=0, total_steps=10, min_lr_frac=0.5,
         state_dtype="bfloat16"),
]


@pytest.mark.parametrize("case", range(len(OPT_CASES)))
def test_apply_updates_matches_reference(case):
    jcfg = J.OptConfig(**OPT_CASES[case])
    pcfg = opt_config_from_fields(dataclasses.asdict(jcfg))
    params = _tree(case)
    jp, pp = _jax(params), _torch(params)
    js, ps = J.init_opt_state(jcfg, jp), P.init_opt_state(pcfg, pp)
    for step in range(6):
        grads = _tree(100 + step, scale=3.0 if step % 2 else 0.1)
        if step == 4:
            jn = pn = None
        else:
            jn = J.global_norm(_jax(grads))
            pn = P.global_norm(_torch(grads))
            np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        jp, js, jm = J.apply_updates(jcfg, jp, _jax(grads), js, grad_norm=jn)
        pp, ps, pm = P.apply_updates(pcfg, pp, _torch(grads), ps,
                                     grad_norm=pn)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)
        for got, want in zip(jax.tree.leaves(_np(pp)),
                             jax.tree.leaves(_np(jp))):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for k in ("m", "v"):
            for got, want in zip(jax.tree.leaves(ps[k]),
                                 jax.tree.leaves(js[k])):
                assert str(got.dtype).endswith(str(want.dtype))
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=1e-6 if pcfg.state_dtype == "float32" else 1e-2,
                    atol=1e-6)
        assert int(ps["step"]) == int(js["step"]) == step + 1


@pytest.mark.parametrize("step", [0, 1, 4, 9, 10, 11, 55, 99, 100, 150])
def test_lr_at_matches_reference(step):
    cfg = dict(lr=2.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(J.lr_at(J.OptConfig(**cfg), jnp.int32(step)))
    got = float(P.lr_at(P.OptConfig(**cfg), torch.tensor(step,
                                                         dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _grad_with_edges(seed, n=300):
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)
    x[5], x[77], x[200] = np.nan, np.inf, -np.inf
    x[201] = -0.0
    return x


@pytest.mark.parametrize("kind,nonfinite", [("int8", False), ("int8", True),
                                            ("topk", False), ("topk", True)])
def test_compress_with_feedback_matches_reference_bitwise(kind, nonfinite):
    jcfg = JC.CompressConfig(kind=kind, block=64, topk_frac=0.1)
    pcfg = PC.CompressConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(3)
    g = {"w": (_grad_with_edges(4) if nonfinite
               else rng.normal(size=(300,)).astype(np.float32)),
         "u": rng.normal(size=(5, 13)).astype(np.float32)}
    jr, pr = JC.init_residual(_jax(g)), PC.init_residual(_torch(g))
    for _ in range(3):
        jg, jr, jm = JC.compress_with_feedback(jcfg, _jax(g), jr)
        pg, pr, pm = PC.compress_with_feedback(pcfg, _torch(g), pr)
        assert pm == jm
        for got, want in zip(jax.tree.leaves(_np(pg)) + jax.tree.leaves(
                _np(pr)), jax.tree.leaves(_np(jg)) + jax.tree.leaves(
                _np(jr))):
            np.testing.assert_array_equal(got, want)


def test_int8_nan_goes_to_zero_before_the_cast():
    """A NaN block rounds to the int8 code 0 (so the round trip is 0 x
    NaN scale = NaN, as in the reference), never to a platform-defined
    code."""
    x = torch.tensor([float("nan"), 1.0, 2.0, 3.0])
    out = PC._int8_rt(x, 4)
    assert torch.isnan(out).all()
    fin = PC._int8_rt(torch.tensor([0.5, -1.0, 2.0, 0.0]), 4)
    assert torch.isfinite(fin).all()


# --- tests/test_optim_data.py's cases on the port ---------------------------


def test_adamw_minimizes_quadratic():
    cfg = P.OptConfig(lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, grad_clip=10.0)
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(32,))
                              .astype(np.float32))
    params = {"w": torch.zeros(32)}
    state = P.init_opt_state(cfg, params)
    for _ in range(150):
        grads = {"w": params["w"] - target}
        params, state, _ = P.apply_updates(cfg, params, grads, state)
    assert float((params["w"] - target).abs().max()) < 0.05


def test_grad_clip_engages():
    cfg = P.OptConfig(grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    state = P.init_opt_state(cfg, params)
    _, _, m = P.apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                              state)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_lr_schedule_shape():
    cfg = P.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(P.lr_at(cfg, s)) for s in (0, 9, 50, 99)]
    assert lrs[0] < lrs[1]
    assert lrs[1] >= lrs[2] >= lrs[3]
    assert lrs[3] >= 0.099


def test_bf16_opt_state_dtype():
    cfg = P.OptConfig(state_dtype="bfloat16")
    state = P.init_opt_state(cfg, {"w": torch.zeros(4)})
    assert state["m"]["w"].dtype == torch.bfloat16


def test_apply_updates_groups_large_trees(monkeypatch):
    """The foreach passes run over groups of leaves; a small group cap
    gives the same update as one group."""
    cfg = P.OptConfig(lr=1e-2, warmup_steps=0)
    tree = _tree(9)
    grads = _torch(_tree(10))
    outs = []
    for cap in (1 << 27, 8):
        monkeypatch.setattr(P, "GROUP_ELEMS", cap)
        params = _torch(tree)
        state = P.init_opt_state(cfg, params)
        params, state, _ = P.apply_updates(cfg, params, grads, state)
        outs.append(jax.tree.leaves(_np(params)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_preserves_signal(kind):
    """With EF, the accumulated compressed gradient tracks the true sum."""
    cfg = PC.CompressConfig(kind=kind, topk_frac=0.25)
    g_true = torch.from_numpy(np.random.default_rng(1).normal(size=(256,))
                              .astype(np.float32))
    params = {"w": g_true}
    res = PC.init_residual(params)
    acc = torch.zeros_like(g_true)
    for _ in range(30):
        comp, res, _ = PC.compress_with_feedback(cfg, params, res)
        acc = acc + comp["w"]
    assert float((acc / 30 - g_true).abs().max()) < 0.15


def test_int8_roundtrip_bounded():
    cfg = PC.CompressConfig(kind="int8", block=64)
    x = {"w": torch.from_numpy(np.random.default_rng(2).normal(size=(512,))
                               .astype(np.float32))}
    comp, _, _ = PC.compress_with_feedback(cfg, x, PC.init_residual(x))
    assert float((comp["w"] - x["w"]).abs().max()) < \
        float(x["w"].abs().max()) / 64


def test_data_determinism_and_shapes():
    cfg = get_smoke_config("olmo-1b")
    dc = DataConfig(seq_len=64, global_batch=8, seed=7)
    s1, s2 = SyntheticStream(dc, cfg), SyntheticStream(dc, cfg)
    b1, b2 = s1.batch(3, 0, 2), s2.batch(3, 0, 2)
    assert (b1["tokens"] == b2["tokens"]).all()
    assert b1["tokens"].shape == (4, 64)
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()


def test_data_ranks_disjoint():
    cfg = get_smoke_config("olmo-1b")
    s = SyntheticStream(DataConfig(seq_len=32, global_batch=8, seed=7), cfg)
    b0, b1 = s.batch(0, 0, 2), s.batch(0, 1, 2)
    assert not (b0["tokens"] == b1["tokens"]).all()


def test_data_learnable_structure():
    """Bigram structure: next token is predictable 85% of the time."""
    cfg = get_smoke_config("olmo-1b")
    s = SyntheticStream(DataConfig(seq_len=128, global_batch=8), cfg)
    t = s.global_batch(0)["tokens"]
    pred = (t[:, :-1] * 31 + s.shift[t[:, :-1] % 257]) % cfg.vocab_size
    assert (pred == t[:, 1:]).mean() > 0.7
