"""The port's observability layer against ``repro.obs`` on the CPU:
registry semantics, the flight recorder, the exporters, and the
exactness chain

    round events  ==  batch event  ==  AggPlan.wire_bytes
                  ==  executed Transport.bytes_sent  ==  schedule_cost

with every traced run held to the reference's: the same events, the
same ``prometheus_text``, and under a ``TickClock`` and a fixed chaos
seed a JSONL trace of the same sha256.  The cases are the outcomes of
``tests/test_obs.py``.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro.core.plan import AggConfig
from repro.obs import prometheus_text as j_prometheus_text
from repro.obs import stats_table as j_stats_table
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.runtime.chaos import ChaosConfig, ChaosError
from repro.runtime.fault import SessionFaultPlan
from repro.runtime.resilience import RetryPolicy
from repro.service import BatchingConfig, SessionParams
from repro_torch import convert as C
from repro_torch.core import engine as PE
from repro_torch.core import plan as PP
from repro_torch.core.schedules import schedule_cost
from repro_torch.obs import (MetricsRegistry, SVC_STATS_DEPRECATED,
                             SVC_STATS_KEYS, SVC_STATS_VERSION, TickClock,
                             TraceRecorder, prometheus_text, stats_table)
from repro_torch.obs.trace import read_jsonl, to_jsonl
from repro_torch.runtime import chaos as PC
from repro_torch.service import SessionState
from torch_service_pair import feed, services

RNG = np.random.default_rng(31)
N, ELEMS = 8, 16


def _params(**kw):
    return SessionParams(n_nodes=N, elems=ELEMS, cluster_size=4,
                         redundancy=3, **kw)


def _vals(S=4):
    return (RNG.normal(size=(S, N, ELEMS)) * 0.3).astype(np.float32)


def _traced(S, vals, *, params=None, batching=None, sink=None, **kw):
    """Both services, with TickClock recorders, fed ``vals``."""
    recorder = {} if sink is None else {"sink": sink}
    js, ps = services(params or _params(), recorder=recorder,
                      batching=batching or BatchingConfig(max_batch=S,
                                                          max_age=1e9),
                      **kw)
    for svc in (js, ps):
        feed(svc, vals)
    return js, ps


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def _exercise(reg):
    c = reg.counter("x.count")
    c.inc()
    c.inc(4)
    assert reg.counter("x.count") is c
    g = reg.gauge("x.depth")
    g.set(2.0)
    g.track_max(7.0)
    g.track_max(3.0)
    h = reg.histogram("x.lat")
    for v in (1.0, 3.0):
        h.observe(v)
    reg.counter("q.flushes", reason="size").inc(2)
    reg.counter("q.flushes", reason="age").inc()
    reg.histogram("stage.seconds", stage="reveal").observe(0.001)
    return c, g


def test_registry_counters_gauges_histograms_and_labels():
    reg = MetricsRegistry()
    c, g = _exercise(reg)
    assert c.value == 5 and g.value == 7.0
    jreg = JRegistry()
    _exercise(jreg)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert snap["histograms"]["x.lat"] == {
        "count": 2, "total": 4.0, "min": 1.0, "max": 3.0, "mean": 2.0}
    assert snap["counters"]["q.flushes{reason=age}"] == 1
    reg.reset()
    assert c.value == 0 and g.value == 0.0
    assert reg.snapshot()["histograms"]["x.lat"]["count"] == 0


def test_disabled_registry_hands_out_noops():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("x")
    c.inc(100)
    reg.histogram("h").observe(1.0)
    reg.gauge("g").set(5.0)
    assert c.value == 0
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


def test_exporters_render_like_the_reference():
    reg, jreg = MetricsRegistry(), JRegistry()
    for r in (reg, jreg):
        _exercise(r)
        r.counter("executor.batches_run").inc(3)
    prom = prometheus_text(reg)
    assert prom == j_prometheus_text(jreg)
    assert "repro_executor_batches_run 3" in prom
    assert 'repro_stage_seconds_count{stage="reveal"} 1' in prom
    assert stats_table(reg) == j_stats_table(jreg)
    assert stats_table(MetricsRegistry()) == "-- metrics: (no series) --"


# ---------------------------------------------------------------------------
# Trace recorder
# ---------------------------------------------------------------------------


def test_recorder_ring_jsonl_and_tick_clock(tmp_path):
    path = tmp_path / "t.jsonl"
    rec = TraceRecorder(capacity=3, clock=TickClock(), sink=str(path))
    for i in range(5):
        rec.event("tick", i=i)
    rec.event("other")
    rec.close()
    assert rec.events_recorded == 6
    assert [e["ts"] for e in rec.events()] == [3.0, 4.0, 5.0]
    assert rec.events("other") == [{"ts": 5.0, "kind": "other"}]
    disk = read_jsonl(str(path))
    assert len(disk) == 6
    assert disk[0] == {"ts": 0.0, "kind": "tick", "i": 0}
    assert to_jsonl(disk) == path.read_text()


@pytest.mark.parametrize("transport,backup", [("full", True),
                                              ("digest", True),
                                              ("digest", False)])
def test_hop_wire_words_matches_plan_and_schedule_cost(transport, backup):
    from repro.core.plan import compile_plan as j_compile
    from repro.core.plan import hop_wire_words as j_words
    T = 48
    jcfg = AggConfig(n_nodes=16, cluster_size=4, redundancy=3,
                     schedule="tree", transport=transport,
                     digest_backup=backup)
    cfg = C.config_from_fields(dataclasses.asdict(jcfg))
    plan = PP.compile_plan(cfg)
    words = [PP.hop_wire_words(cfg, rnd, T) for rnd in plan.rounds]
    assert words == [j_words(jcfg, rnd, T)
                     for rnd in j_compile(jcfg).rounds]
    total = 4 * sum(w["payload"] + w["digest"] + w["backup"] for w in words)
    assert total == plan.wire_bytes(T)
    assert total == schedule_cost(
        "tree", 4, 4, 3, payload_bytes=4 * T, digest=transport == "digest",
        digest_bytes=4 * cfg.digest_words,
        digest_backup=backup)["bytes_total"]


# ---------------------------------------------------------------------------
# Executor integration: flight-recorder events + registry views
# ---------------------------------------------------------------------------


def test_batch_and_round_events_reconcile_with_engine_account():
    S, vals = 4, _vals(4)
    js, ps = _traced(S, vals)
    for svc in (js, ps):
        assert svc.pump(now=1.0) == S
    rec = ps.recorder
    assert rec.events() == js.recorder.events()
    assert prometheus_text(ps.metrics) == j_prometheus_text(js.metrics)
    (b,) = rec.events("batch")
    rounds = rec.events("round")
    assert b["rows"] == S and b["sids"] == [0, 1, 2, 3] and b["fresh"]
    assert len(rounds) == b["rounds"]
    assert sum(r["bytes"] for r in rounds) == b["bytes"]
    plan = PP.compile_plan(ps.default_params.agg_config())
    assert b["bytes"] == plan.wire_bytes(b["padded"], S=S)
    assert b["bytes"] == S * schedule_cost(
        "ring", N // 4, 4, 3, payload_bytes=4 * b["padded"])["bytes_total"]
    xs = torch.zeros((S, N, b["padded"]))
    _, tp = PE.sim_batch(plan, xs, PP.SessionMeta.build(
        S, N, device="cpu", seed=plan.cfg.seed))
    assert tp.bytes_sent == b["bytes"] == ps.executor.wire_bytes
    assert ps.stats["wire"]["bytes_sent"] == b["bytes"]
    hists = ps.metrics.snapshot()["histograms"]
    for stage in ("admission_wait", "plan_compile", "reveal"):
        assert hists[f"stage.seconds{{stage={stage}}}"]["count"] == 1, stage
    kinds = [e["kind"] for e in rec.events()]
    assert kinds.index("flush") < kinds.index("batch")


def test_round_events_model_fault_population_on_digest():
    vals = _vals(1)
    js, ps = _traced(1, vals, params=_params(transport="digest"))
    plan = SessionFaultPlan(byzantine_slots=(2,), byzantine_mode="mismatch")
    js.get(0).inject_fault(plan)
    ps.get(0).inject_fault(C.fault_plan_from_fields(
        dataclasses.asdict(plan)))
    for svc in (js, ps):
        svc.drain()
        assert svc.get(0).state.value == "revealed"
    assert np.array_equal(ps.get(0).result.numpy(),
                          np.asarray(js.get(0).result))
    rounds = ps.recorder.events("round")
    assert rounds and rounds == js.recorder.events("round")
    for r in rounds:
        assert r["fault_population"] == {"mismatch": 1}
        assert r["vote_disagreements"] == r["digest_mismatches"] == 1
        assert r["digest_bytes"] > 0


@pytest.mark.parametrize("times", [1, None])
def test_resilience_ladder_events_retry_bisect_quarantine(times):
    """One injected dispatch failure -> chaos, retry, a batch at attempt
    2; unbounded chaos -> retries, a bisection, both halves quarantined,
    no batch: the port's events equal the reference's."""
    vals = _vals(2)
    js, ps = _traced(2, vals,
                     retry=RetryPolicy(max_attempts=2, base_backoff_s=0),
                     chaos=ChaosConfig(mode="dispatch", times=times))
    for svc, err in ((js, ChaosError), (ps, PC.ChaosError)):
        if times is None:
            with pytest.raises(err):
                svc.drain()
        else:
            svc.drain()
    rec = ps.recorder
    assert rec.events() == js.recorder.events()
    if times == 1:
        (chaos,) = rec.events("chaos")
        (retry,) = rec.events("retry")
        assert chaos["mode"] == "dispatch" and chaos["attempt"] == 1
        assert retry["attempt"] == 1 and "chaos" in retry["error"]
        assert [e["attempt"] for e in rec.events("batch")] == [2]
    else:
        (bisect,) = rec.events("bisect")
        assert bisect["left"] == [0] and bisect["right"] == [1]
        assert [sorted(e["sids"]) for e in rec.events("quarantine")] \
            == [[0], [1]]
        assert not rec.events("batch")
        assert ps.stats["resilience"]["quarantined"] == 2


def test_queue_protection_events_shed_and_expire():
    vals = _vals(4)
    js, ps = _traced(4, vals, batching=BatchingConfig(
        max_batch=2, max_age=1e9, max_pending_rows=3))
    (shed,) = ps.recorder.events("shed")
    assert shed["sid"] == 3 and shed["limit"] == 3
    for svc in (js, ps):
        svc.drain()
    assert ps.get(3).state is SessionState.EXPIRED
    assert ps.recorder.events() == js.recorder.events()


def test_svc_stats_schema():
    vals = _vals(2)
    js, ps = services(_params(), batching=BatchingConfig(max_batch=2,
                                                         max_age=1e9))
    for svc in (js, ps):
        feed(svc, vals)
        svc.drain()
    st = ps.stats
    assert st["schema"] == SVC_STATS_VERSION and SVC_STATS_DEPRECATED == ()
    assert set(st) == set(SVC_STATS_KEYS)
    assert st["sessions"] == {"opened": 2, "run": 2, "failed": 0,
                              "pending": 0}
    assert st["batches"] == {"run": 1, "sizes": (2,)}
    assert set(st["caches"]) == {"executor", "plan"}
    assert st["wire"]["bytes_sent"] == ps.executor.wire_bytes > 0
    assert set(st["metrics"]) == {"counters", "gauges", "histograms"}
    jst = js.stats
    for k in ("schema", "sessions", "batches", "queue", "resilience",
              "wire", "epoch"):
        assert st[k] == jst[k], k


# ---------------------------------------------------------------------------
# Deterministic byte-identical replay under chaos: the reference's sha256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_trace_has_the_reference_sha256(tmp_path, seed):
    """Same chaos seed + TickClock + zero backoff: the port's JSONL trace
    is byte for byte the reference's (pinned by sha256), so are its
    dead letters, quarantines and Prometheus text; every executed
    batch's round events reconcile with the analytic byte account."""
    vals = _vals(8)
    a, b = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    js, ps = _traced(
        8, vals, sink=(str(a), str(b)),
        batching=BatchingConfig(max_batch=4, max_age=1e9),
        retry=RetryPolicy(max_attempts=2, base_backoff_s=0),
        chaos=ChaosConfig(mode="dispatch", p=0.35, seed=seed))
    for svc, err in ((js, ChaosError), (ps, PC.ChaosError)):
        try:
            svc.drain()
        except err:
            pass
        svc.recorder.close()
    assert ps.recorder.events_recorded > 0
    da = hashlib.sha256(a.read_bytes()).hexdigest()
    db = hashlib.sha256(b.read_bytes()).hexdigest()
    assert db == da
    assert ps.executor.dead_letter == js.executor.dead_letter
    assert ps.stats["resilience"] == js.stats["resilience"]
    assert prometheus_text(ps.metrics) == j_prometheus_text(js.metrics)
    events = read_jsonl(str(b))
    batches = [e for e in events if e["kind"] == "batch"]
    assert batches and any(e["kind"] == "retry" for e in events)
    for bt in batches:
        rsum = sum(e["bytes"] for e in events
                   if e["kind"] == "round" and e["unit"] == bt["unit"]
                   and e["attempt"] == bt["attempt"])
        assert rsum == bt["bytes"] == bt["rows"] * schedule_cost(
            "ring", N // 4, 4, 3,
            payload_bytes=4 * bt["padded"])["bytes_total"]
    for i in range(8):
        sj, sp = js.get(i), ps.get(i)
        assert sp.state.value == sj.state.value
        if sp.state is SessionState.REVEALED:
            assert np.array_equal(sp.result.numpy(), np.asarray(sj.result))
