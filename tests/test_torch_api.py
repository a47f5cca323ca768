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


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.SecureAggregator(topology=P.Topology(n_nodes=8))
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu")
    assert agg.stats()["device"] == "cpu"


def test_later_slices_raise_config_error():
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu")
    for verb in ("open_session", "seal", "pump", "drain", "result",
                 "histogram", "quantile", "median", "minimum", "maximum",
                 "topk"):
        with pytest.raises(P.ConfigError, match="not ported yet"):
            getattr(agg, verb)()
    with pytest.raises(P.ConfigError, match="not ported yet"):
        agg.cost(fn="histogram")
    for backend in ("manual", "mesh"):
        with pytest.raises(P.ConfigError, match="distributed slice"):
            P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu",
                               runtime=P.Runtime(backend=backend))
    with pytest.raises(P.ConfigError, match="not ported yet"):
        P.SecureAggregator(topology=P.Topology(n_nodes=8), device="cpu",
                           tune="auto")
    with pytest.raises(P.ConfigError, match="needs a config"):
        P.SecureAggregator(device="cpu")
    d = agg.derive(n_nodes=6)
    assert (d.cfg.cluster_size, d.cfg.redundancy, d.device.type) == \
        (3, 3, "cpu")


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core.engine, "
            "repro_torch.convert, repro_torch.kernels.build, "
            "repro_torch.kernels.modmul, repro_torch.crypto.paillier, "
            "repro_torch.core.protocol, repro_torch.core.baseline_nl, "
            "repro_torch.core.lower_bound; "
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
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
