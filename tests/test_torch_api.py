"""The port's facade against ``repro.api.SecureAggregator``, the state
conversion helpers, device resolution and import isolation: the port and
``chip_smoke.py`` never import ``jax`` or ``repro``."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as J
from repro.core.byzantine import ByzantineSpec as JByzantineSpec
from repro_torch import api as P
from repro_torch.convert import (config_from_fields, session_meta_from_numpy,
                                 words_from_numpy, words_to_numpy)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(23)


def _pair(**kw):
    jcfg = J.AggConfig(n_nodes=16, cluster_size=4, redundancy=3, clip=2.0,
                       **kw)
    return (J.SecureAggregator(jcfg),
            P.SecureAggregator(config_from_fields(dataclasses.asdict(jcfg)),
                               device="cpu"))


@pytest.mark.parametrize("masking", ["global", "pairwise", "none"])
@pytest.mark.parametrize("transport", ["full", "digest"])
def test_allreduce_matches_reference(transport, masking):
    T = 96
    ja, pa = _pair(transport=transport, masking=masking)
    xs = (RNG.normal(size=(16, T)) * 0.2).astype(np.float32)
    want = np.asarray(ja.allreduce(xs))
    got = pa.allreduce(torch.from_numpy(xs))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pa.allreduce(xs).numpy(), want)   # numpy in
    st = pa.stats()
    assert st["backend"] == "sim" and st["plan_cache"]["size"] >= 1
    # the analytic account equals the engine's executed wire bytes
    assert pa.cost(T) == ja.cost(T)
    assert st["bytes_sent"] == 2 * pa.cost(T)["bytes_total"]


def test_allreduce_dict_payload_matches_reference():
    n = 16
    ja, pa = _pair()
    xs = (RNG.normal(size=(n, 70)) * 0.2).astype(np.float32)
    tree = {"w": xs[:, :32].reshape(n, 4, 8), "b": xs[:, 32:]}
    want = ja.allreduce(tree)
    got = pa.allreduce({k: torch.from_numpy(v) for k, v in tree.items()})
    assert set(got) == {"w", "b"} and tuple(got["w"].shape) == (n, 4, 8)
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    pair = pa.allreduce((torch.from_numpy(xs[:, :5]),
                         [torch.from_numpy(xs[:, 5:])]))
    assert isinstance(pair, tuple) and isinstance(pair[1], list)
    with pytest.raises(P.ConfigError, match="leading axis"):
        pa.allreduce(torch.zeros((n + 1, 8)))


def test_allreduce_batched_matches_reference():
    S, n, T = 5, 16, 48
    ja, pa = _pair()
    xs = (RNG.normal(size=(S, n, 8, 6)) * 0.2).astype(np.float32)
    want = np.asarray(ja.allreduce_batched(xs))
    got = pa.allreduce_batched(torch.from_numpy(xs))
    assert tuple(got.shape) == (S, 8, 6)
    assert np.array_equal(got.numpy(), want)
    for i in range(S):                 # each row is its own session
        assert torch.equal(got[i].reshape(T),
                           pa.allreduce(torch.from_numpy(xs[i]))[0]
                           .reshape(T))
    sent = pa.stats()["bytes_sent"]
    assert torch.equal(pa.allreduce_batched(xs), got)
    assert pa.stats()["bytes_sent"] - sent == S * pa.cost(T)["bytes_total"]
    assert tuple(pa.allreduce_batched(
        np.zeros((0, n, T), np.float32)).shape) == (0, T)
    with pytest.raises(P.ConfigError, match="per-node"):
        pa.allreduce_batched(np.zeros((S, n + 1, T), np.float32))


def test_convert_round_trips():
    jcfg = J.AggConfig(n_nodes=8, cluster_size=4, redundancy=3,
                       transport="digest", masking="pairwise",
                       kernel_impl="jnp",
                       byzantine=JByzantineSpec(corrupt_ranks=(1, 6),
                                                mode="garbage@1"))
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    theirs = dataclasses.asdict(jcfg)
    ours = dataclasses.asdict(cfg)
    theirs.pop("kernel_impl"), ours.pop("kernel_impl")
    assert ours == theirs and cfg.kernel_impl is None
    assert config_from_fields(dataclasses.asdict(cfg)) == cfg
    with pytest.raises(ValueError, match="unknown"):
        config_from_fields({"n_nodes": 8, "warp_drive": 9})
    seeds = np.array([1, 2 ** 32 - 1], np.uint32)
    offsets = np.array([0, 2 ** 31], np.uint32)
    masks = {"flip": np.array([[True, False], [False, True]])}
    meta = session_meta_from_numpy(seeds, offsets, masks, "cpu")
    assert np.array_equal(words_to_numpy(meta.seeds), seeds)
    assert np.array_equal(words_to_numpy(meta.offsets), offsets)
    assert np.array_equal(meta.fault_masks["flip"].numpy(), masks["flip"])
    w = RNG.integers(0, 2 ** 32, size=(3, 5), dtype=np.uint32)
    assert np.array_equal(words_to_numpy(words_from_numpy(w)), w)


def test_nan_payload_allreduce_matches_reference():
    """A NaN payload element quantizes to 0 on both sides (XLA's NaN to
    int conversion), so the revealed sums stay bit-equal; +-Inf clip and
    -0.0 rows alongside."""
    n, T = 8, 16
    jcfg = J.AggConfig(n_nodes=n, cluster_size=4, redundancy=3)
    ja = J.SecureAggregator(jcfg)
    pa = P.SecureAggregator(config_from_fields(dataclasses.asdict(jcfg)),
                            device="cpu")
    xs = (RNG.normal(size=(n, T)) * 0.2).astype(np.float32)
    xs[2, 5] = np.nan
    xs[3, 1], xs[4, 1], xs[6, 7] = np.inf, -np.inf, -0.0
    want = np.asarray(ja.allreduce(xs))
    got = pa.allreduce(torch.from_numpy(xs)).numpy()
    assert np.array_equal(got, want)
    zeroed = xs.copy()
    zeroed[2, 5] = 0.0
    assert np.array_equal(got[:, 5], np.asarray(ja.allreduce(zeroed))[:, 5])


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.SecureAggregator(topology=P.Topology(n_nodes=8))
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu")
    assert agg.stats()["device"] == "cpu"


def test_later_slices_raise_config_error():
    """What is not in the port raises ``ConfigError`` and names what to
    do instead; the tuner and the function verbs are ported, so their
    refusals are now the reference's argument checks."""
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu")
    for verb, args in (("histogram", (np.zeros(8),)),
                       ("quantile", (np.zeros(8), 0.5)),
                       ("median", (np.zeros(8),)),
                       ("minimum", (np.zeros(8),)),
                       ("maximum", (np.zeros(8),)),
                       ("topk", (np.zeros(8), 2))):
        with pytest.raises(TypeError):
            getattr(agg, verb)()                    # missing arguments
        if verb != "histogram":
            with pytest.raises(TypeError, match="domain"):
                getattr(agg, verb)(*args)
    with pytest.raises(P.ConfigError, match="bins"):
        agg.cost(fn="histogram")
    with pytest.raises(P.ConfigError, match="needs bins"):
        agg.open_session(fn="histogram")
    assert agg.cost(fn="histogram", bins=4)["allreduces"] == 1
    # the service is ported: its verbs want an open session first
    with pytest.raises(P.ConfigError, match="needs elems"):
        agg.open_session()
    for verb in ("seal", "result"):
        with pytest.raises(P.ConfigError, match="no session opened yet"):
            getattr(agg, verb)(0)
    for verb in ("pump", "drain"):
        with pytest.raises(P.ConfigError, match="no session opened yet"):
            getattr(agg, verb)()
    # the distributed backends are ported: 'mesh' needs a mesh, as in the
    # reference; 'manual' needs a started process group (none here) and
    # never falls back to the sim oracle; it has no batched verb and no
    # function verbs
    with pytest.raises(P.ConfigError, match="needs a mesh"):
        P.Runtime(backend="mesh")
    manual = P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu",
                                runtime=P.Runtime(backend="manual"))
    assert manual.stats()["backend"] == "manual"
    with pytest.raises(P.ConfigError, match="process group"):
        manual.allreduce(torch.zeros(4))
    with pytest.raises(P.ConfigError, match="'manual' backend"):
        manual.allreduce_batched(torch.zeros(2, 8, 4))
    with pytest.raises(P.ConfigError, match="'manual'"):
        manual.median(np.zeros(8), domain=(0.0, 1.0, 8))
    with pytest.raises(P.ConfigError, match="unknown tune mode"):
        P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu",
                           tune="fastest")
    tuned = P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu",
                               tune="auto")
    assert tuned.stats()["tuner"]["decisions"] == 0
    with pytest.raises(P.ConfigError, match="needs a config"):
        P.SecureAggregator(device="cpu")
    d = agg.derive(n_nodes=6)
    assert (d.cfg.cluster_size, d.cfg.redundancy, d.device.type) == \
        (3, 3, "cpu")
    # the launcher's mesh transport is ported (tests/test_torch_launch_agg_
    # mesh.py); a host mesh past one rank waits for the sharded serve
    from repro_torch.launch import serve_agg
    with pytest.raises(P.ConfigError, match="Queue 1 item 10.9"):
        serve_agg.main(["--transport", "mesh", "--device", "cpu",
                        "--data", "2"])


def test_tuned_facade_runs_each_shape_on_its_own_plan():
    """A tuned facade keeps one callable a payload shape, each built on
    the plan the tuner picked for that shape: the bytes of each call
    equal that shape's ``cost``, and a repeated shape is a cache hit."""
    from repro_torch.core.plan import compile_plan
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=16), device="cpu",
                             tune="auto")
    plans = {}
    for T in (8, 70000, 8, 70000):
        xs = torch.from_numpy((RNG.normal(size=(16, T)) * 0.3)
                              .astype(np.float32))
        before = agg.stats()["bytes_sent"]
        agg.allreduce(xs)
        sent = agg.stats()["bytes_sent"] - before
        plan = compile_plan(agg._tune_decision(T).config)
        assert sent == agg.cost(T)["bytes_total"] == plan.wire_bytes(T)
        plans[T] = plan
    assert plans[8].cfg != plans[70000].cfg
    assert {fn.plan.cfg for fn in agg._fns.values()} \
        == {plans[8].cfg, plans[70000].cfg}
    assert agg.stats()["fn_cache"] == {"hits": 2, "misses": 2, "size": 2}
    xs = torch.zeros((4, 16, 8))
    agg.allreduce_batched(xs)
    fn = agg._fns[("batched", "sim", 4, 8)]
    assert fn.plan is compile_plan(agg._tune_decision(8, 4).config)


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core.engine, "
            "repro_torch.convert, repro_torch.kernels.build, "
            "repro_torch.kernels.modmul, repro_torch.crypto.paillier, "
            "repro_torch.core.protocol, repro_torch.core.baseline_nl, "
            "repro_torch.core.lower_bound, repro_torch.runtime, "
            "repro_torch.runtime.compat, repro_torch.launch.selftest; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/runtime/compat.py",
            "src/repro_torch/launch/selftest.py"} <= names
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
