"""The port's self-tuning planner (``repro_torch.tune``) against the JAX
package's ``repro.tune``.

  * DECISIONS: every row of ``tests/test_tune.py::GOLDEN`` and a seeded
    grid of signatures resolve to the reference's ``TuneDecision`` field
    for field (``candidates_scored`` and ``expected_bytes`` included),
    and the ``tuner_*_bytes`` rows of ``BENCH_secure_agg.json`` come out
    exactly;
  * EXACTNESS: each decision's ``predicted_bytes`` equals the port's
    executed bytes, on the engine and through the service, as the
    reference's do; a tuned one-shot equals the reference's bit for bit;
  * the memo, the facade memo, argument validation and probe mode;
  * import isolation of the new modules.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_tune import GOLDEN, _cfg
from repro import api as J
from repro.core.plan import compile_plan as j_compile_plan
from repro.service import BatchingConfig as JBatchingConfig
from repro.tune import Tuner as JTuner
from repro.tune import clear_tuner_cache as j_clear
from repro.tune import expected_retransmit_bytes as j_retransmit
from repro_torch import api as P
from repro_torch.convert import (batching_from_fields, config_from_fields,
                                 decision_fields, signature_from_fields)
from repro_torch.core.engine import sim_batch
from repro_torch.core.plan import ConfigError, SessionMeta, compile_plan
from repro_torch.tune import (Tuner, WorkloadSignature, clear_tuner_cache,
                              expected_retransmit_bytes, tuner_cache_stats)
from repro_torch.tune.planner import pad_candidates

ROOT = pathlib.Path(__file__).resolve().parents[1]
IDS = [f"n{k[0]}_T{k[2]}_S{k[3]}_b{k[4]}_ch{k[5]}" for k, _ in GOLDEN]


@pytest.fixture(autouse=True)
def _fresh_tuner_caches():
    clear_tuner_cache(), j_clear()
    yield
    clear_tuner_cache(), j_clear()


def _port(jcfg):
    return config_from_fields(dataclasses.asdict(jcfg))


def _decide(sig_row):
    """(reference decision, port decision) of one signature row."""
    n, cluster, T, S, budget, churn = sig_row
    jcfg = _cfg(n, cluster, budget)
    return (JTuner(churn_rate=churn).resolve(jcfg, T, S),
            Tuner(churn_rate=churn).resolve(_port(jcfg), T, S))


@pytest.mark.parametrize("sig_row,want", GOLDEN, ids=IDS)
def test_golden_decisions_equal_reference(sig_row, want):
    jd, d = _decide(sig_row)
    assert decision_fields(d) == decision_fields(jd)
    got = (d.config.schedule, d.config.transport, d.config.digest_words,
           d.config.digest_backup, d.padded_elems, d.predicted_bytes,
           d.baseline_bytes)
    assert got == want
    assert d.saving_vs_default == jd.saving_vs_default
    assert signature_from_fields(dataclasses.asdict(jd.signature)) \
        == d.signature


def test_seeded_signature_grid_equals_reference():
    rng = np.random.default_rng(0x70E)
    rows = []
    for _ in range(40):
        n, cluster = [(8, 4), (12, 4), (16, 4), (24, 3), (32, 4), (64, 4),
                      (48, 4), (16, 8)][rng.integers(8)]
        T = int(rng.choice([1, 7, 64, 65, 300, 1024, 1100, 5000, 70000]))
        S = int(rng.choice([1, 2, 8, 33]))
        budget = int(rng.integers(0, n // 3 + 1))
        churn = float(rng.choice([0.0, 0.0, 0.01, 0.05, 0.3, 1.0]))
        rows.append((n, cluster, T, S, budget, churn))
    for row in rows:
        jd, d = _decide(row)
        assert decision_fields(d) == decision_fields(jd), row
        # the retransmit expectation, a float sum over rounds, ties too
        jcfg = jd.config.replace(transport="digest", digest_backup=False)
        assert expected_retransmit_bytes(
            compile_plan(_port(jcfg)), d.padded_elems, d.signature) \
            == j_retransmit(j_compile_plan(jcfg), d.padded_elems,
                            jd.signature)
    assert tuner_cache_stats()["size"] == len(set(rows))


def test_pad_candidates_and_bench_rows_equal_reference():
    from repro.tune.planner import pad_candidates as j_pads
    for T in (1, 8, 64, 127, 128, 1024, 1100, 16384, 16385, 200000):
        assert pad_candidates(T) == j_pads(T)
    rows = json.loads((ROOT / "BENCH_secure_agg.json").read_text())
    tuner = Tuner()
    for n, cluster, T, S in ((16, 4, 1024, 8), (16, 4, 200000, 2),
                             (64, 4, 4096, 16)):
        cfg = P.AggConfig.compose(P.Topology(n_nodes=n, cluster_size=cluster),
                                  P.Security(), P.Wire())
        d = tuner.resolve(cfg, T, S)
        tag = f"n{n}_T{T}_S{S}"
        assert d.predicted_bytes == rows[f"tuner_decision_{tag}_bytes"]
        assert d.baseline_bytes == rows[f"tuner_default_{tag}_bytes"]


@pytest.mark.parametrize("sig_row,want", GOLDEN, ids=IDS)
def test_golden_predicted_equals_engine_executed(sig_row, want):
    n, cluster, T, S, budget, churn = sig_row
    _, d = _decide(sig_row)
    plan = compile_plan(d.config)
    xs = torch.zeros((S, n, d.padded_elems))
    # the hops, and so the bytes, are those of the full run; revealing
    # one row a session spares the CPU the other nodes' unmask
    _, tp = sim_batch(plan, xs, SessionMeta.build(S, n, device="cpu",
                                                  seed=d.config.seed),
                      reveal_only=True)
    assert tp.bytes_sent == d.predicted_bytes <= d.baseline_bytes


@pytest.mark.parametrize("n,cluster,elems,S", [(16, 4, 1000, 4),
                                               (12, 4, 1100, 2)])
def test_predicted_bytes_equal_service_executed(n, cluster, elems, S):
    """One full batch through each facade's service with tuning on: the
    executed wire account equals ``predicted_bytes`` and the reference's,
    and every session equals the reference's bit for bit."""
    jb = JBatchingConfig(max_batch=S)
    aggs = (J.SecureAggregator(topology=J.Topology(n_nodes=n,
                                                   cluster_size=cluster),
                               tune="auto", batching=jb),
            P.SecureAggregator(topology=P.Topology(n_nodes=n,
                                                   cluster_size=cluster),
                               tune="auto", device="cpu",
                               batching=batching_from_fields(
                                   dataclasses.asdict(jb))))
    vals = (np.random.default_rng(7).integers(0, 2, size=(S, n, elems))
            .astype(np.float32))
    sids = []
    for agg in aggs:
        ids = []
        for s_idx in range(S):
            s = agg.open_session(elems)
            for slot in range(n):
                s.contribute(slot, vals[s_idx, slot])
            agg.seal(s.sid)
            ids.append(s.sid)
        assert agg.drain() == S
        sids.append(ids)
    ja, pa = aggs
    d = pa._tune_decision(elems, S)
    assert decision_fields(d) == decision_fields(ja._tune_decision(elems, S))
    executed = pa.stats()["service"]["wire"]["bytes_sent"]
    assert executed == d.predicted_bytes \
        == ja.stats()["service"]["wire"]["bytes_sent"]
    assert pa._tuned_rows == ja._tuned_rows == {elems: d.padded_elems}
    for jsid, psid in zip(*sids):
        assert np.array_equal(pa.result(psid).numpy(),
                              np.asarray(ja.result(jsid)))
    st = pa.stats()["tuner"]
    assert st == ja.stats()["tuner"] and st["decisions"] == 1


def test_tuned_one_shots_equal_reference_on_their_own_plans():
    """A tuned facade runs each payload shape on that shape's plan: the
    results equal the reference's tuned facade bit for bit, and each
    call's bytes equal that shape's ``cost``."""
    rng = np.random.default_rng(3)
    ja = J.SecureAggregator(topology=J.Topology(n_nodes=16), tune="auto")
    pa = P.SecureAggregator(topology=P.Topology(n_nodes=16), tune="auto",
                            device="cpu")
    plain = P.SecureAggregator(topology=P.Topology(n_nodes=16),
                               device="cpu")
    for T in (600, 8, 600, 70000):
        xs = (rng.normal(size=(16, T)) * 0.3).astype(np.float32)
        before = pa.stats()["bytes_sent"]
        got = pa.allreduce(torch.from_numpy(xs))
        assert np.array_equal(got.numpy(), np.asarray(ja.allreduce(xs)))
        sent = pa.stats()["bytes_sent"] - before
        d = pa._tune_decision(T)
        assert sent == pa.cost(T)["bytes_total"] \
            == compile_plan(d.config).wire_bytes(T)
        np.testing.assert_allclose(got.numpy(),
                                   plain.allreduce(xs).numpy(), atol=1e-4)
    assert pa.stats()["bytes_sent"] == ja.stats()["bytes_sent"]
    assert pa.stats()["fn_cache"] == ja.stats()["fn_cache"] \
        == {"hits": 1, "misses": 3, "size": 3}
    assert pa.cost(1024)["bytes_total"] < plain.cost(1024)["bytes_total"]
    xs = (rng.normal(size=(5, 16, 300)) * 0.3).astype(np.float32)
    assert np.array_equal(pa.allreduce_batched(xs).numpy(),
                          np.asarray(ja.allreduce_batched(xs)))
    assert pa.stats()["bytes_sent"] == ja.stats()["bytes_sent"]


def test_decision_memo_is_module_wide():
    cfg = _port(_cfg())
    t1 = Tuner()
    d1 = t1.resolve(cfg, 512, 2)
    assert t1.resolve(cfg, 512, 2) is d1
    assert t1.stats()["decisions"] == 1 and t1.stats()["cache_hits"] == 1
    t2 = Tuner()
    assert t2.resolve(cfg, 512, 2) is d1
    assert tuner_cache_stats() == {"hits": 2, "misses": 1, "size": 1}
    assert t1.resolve(cfg.replace(schedule="butterfly"), 512, 2) is d1
    assert t1.resolve(cfg, 513, 2) is not d1
    assert tuner_cache_stats()["size"] == 2


def test_facade_memo_and_validation():
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=16), tune="auto",
                             device="cpu")
    assert agg._tune_decision(777, 4) is agg._tune_decision(777, 4)
    assert agg.stats()["tuner"]["decisions"] == 1
    assert agg.stats()["tuner"]["cache_hits"] == 0
    for bad, frag in (("fastest", "unknown tune mode"),
                      (42, "repro_torch.tune.Tuner")):
        with pytest.raises(ConfigError, match=frag):
            P.SecureAggregator(topology=P.Topology(n_nodes=8), tune=bad,
                               device="cpu")
    t = Tuner(churn_rate=0.1)
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=8), tune=t,
                             device="cpu")
    assert agg._tuner is t and agg.derive(n_nodes=4)._tuner is t
    for kw, frag in ((dict(n_nodes=0, T=128), "n_nodes"),
                     (dict(n_nodes=8, T=128, churn_rate=1.5), "churn_rate"),
                     (dict(n_nodes=8, T=128, byzantine_budget=9),
                      "byzantine_budget")):
        with pytest.raises(ConfigError, match=frag):
            WorkloadSignature(**kw)
    sig = WorkloadSignature.of(_port(_cfg(budget=3)), 128, 4)
    assert sig.byzantine_budget == 3
    assert sig.corruption_rate() == pytest.approx(3 / 16)
    # a g = 3 committee prunes tree/butterfly: AggConfig.replace raises
    # before any plan compiles, and ring wins
    with pytest.raises(ConfigError, match="power-of-two"):
        _port(_cfg(n=12)).replace(schedule="tree")
    d = Tuner().resolve(_port(_cfg(n=12)), 256, 2)
    assert d.config.schedule == "ring" and d.candidates_scored > 0


def test_probe_mode_runs_measured_finalists(tmp_path, monkeypatch):
    from repro_torch.tune import planner
    monkeypatch.setattr(planner, "PROBE_DIR", str(tmp_path))
    tuner = Tuner(probe=True, probe_finalists=2, probe_rows=1,
                  probe_report=True, device="cpu")
    d = tuner.resolve(_port(_cfg()), 64, 1)
    assert d.probed and tuner.stats()["probes"] == 2
    assert len(tuner.last_probe) == 2
    assert all(r["probe_s"] > 0 for r in tuner.last_probe)
    assert d.predicted_bytes <= d.baseline_bytes
    (report,) = tmp_path.iterdir()
    assert json.loads(report.read_text())["finalists"] == tuner.last_probe
    agg = P.SecureAggregator(topology=P.Topology(n_nodes=16), tune="probe",
                             device="cpu")
    xs = torch.zeros((16, 100))
    assert torch.equal(agg.allreduce(xs), xs)
    assert agg.stats()["tuner"]["probes"] == 3


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.tune, repro_torch.funcs, "
            "repro_torch.launch.serve_agg, "
            "repro_torch.launch.secure_polling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
