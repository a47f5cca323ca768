"""The port's resilience layer against the reference's, on the CPU: the
retry -> bisect -> quarantine ladder, session deadlines, load shedding
and the mesh->sim circuit breaker, driven by ``runtime.chaos``.

Each run builds the reference's and the port's service from one
description (``tests/torch_service_pair.py``) and holds the port to the
reference: revealed results bit for bit (and equal to the fault-free
run), session states, dead letters and quarantines, the resilience
account.  The cases are the outcomes of every non-mesh test of
``tests/test_resilience.py``; the mesh cells run over gloo in
``tests/test_torch_service_mesh.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.runtime.chaos import ChaosConfig, ChaosError
from repro.runtime.resilience import RetryPolicy
from repro.service import BatchingConfig, SessionParams, StreamConfig
from repro_torch import api as PA
from repro_torch import convert as C
from repro_torch.runtime import chaos as PC
from repro_torch.runtime import resilience as PR
from repro_torch.runtime.resilience import (CircuitBreaker, DeadlineExceeded,
                                            ResilienceError)
from repro_torch.service import SessionState
from torch_service_pair import feed, port_params, results, services, states

RNG = np.random.default_rng(23)
N, ELEMS = 8, 16


def _params(elems=ELEMS):
    return SessionParams(n_nodes=N, elems=elems, cluster_size=4,
                         redundancy=3)


def _vals(S=6):
    return (RNG.normal(size=(S, N, ELEMS)) * 0.3).astype(np.float32)


def _reference(vals):
    """The port's fault-free run of the same sessions (same sids, same
    pad keys): the bit-identity oracle of every chaos scenario."""
    _, ps = services(_params(), batching=BatchingConfig(max_batch=64,
                                                        max_age=1e9))
    ss = feed(ps, vals)
    assert ps.pump(force=True) == len(vals)
    return results(ss)


def _run_both(vals, *, batching=None, **kw):
    """Both services over ``vals`` under the same knobs, pumped once:
    per side (sessions, pump result)."""
    js, ps = services(_params(), batching=batching or BatchingConfig(
        max_batch=64, max_age=1e9), **kw)
    out = []
    for svc in (js, ps):
        ss = feed(svc, vals)
        out.append((ss, svc.pump(force=True)))
    return js, ps, out


def _same_outcome(js, ps, out):
    """States, revealed rows and the resilience accounts agree."""
    (jss, jran), (pss, pran) = out
    assert jran == pran
    assert states(jss) == states(pss)
    for sj, sp in zip(jss, pss):
        if sp.state is SessionState.REVEALED:
            assert np.array_equal(np.asarray(sj.result),
                                  np.asarray(sp.result)), sp.sid
        else:
            assert sj.failed_reason == sp.failed_reason, sp.sid
    assert js.stats["resilience"] == ps.stats["resilience"]
    assert js.stats["queue"] == ps.stats["queue"]


# ---------------------------------------------------------------------------
# Outcome "recovered": every chaos mode, transient fault, retry wins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chaos", [
    ChaosConfig(mode="dispatch", times=1),
    ChaosConfig(mode="compile", times=1),
    ChaosConfig(mode="hop", hop_k=0, times=1),
    ChaosConfig(mode="slow", slow_s=1.0, times=1),
], ids=lambda c: c.mode)
def test_transient_fault_recovers_bit_identical(chaos):
    vals = _vals()
    retry = RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                        deadline_s=0.5 if chaos.mode == "slow" else None)
    js, ps, out = _run_both(vals, retry=retry, chaos=chaos)
    _same_outcome(js, ps, out)
    assert out[1][1] == 6
    assert np.array_equal(results(out[1][0]), _reference(vals))
    res = ps.stats["resilience"]
    assert res["chaos_injected"] == 1 and res["retries"] == 1
    assert res["quarantined"] == 0 and res["dead_letter"] == ()
    assert res["deadline_hits"] == (1 if chaos.mode == "slow" else 0)


# ---------------------------------------------------------------------------
# Outcomes "bisected" / "quarantined": poison isolation, dead letter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dispatch", "hop"])
def test_poison_session_bisected_into_dead_letter(mode):
    vals = _vals()
    js, ps, out = _run_both(
        vals, chaos=ChaosConfig(mode=mode, hop_k=0, poison_sids=(3,)),
        retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0))
    _same_outcome(js, ps, out)
    ref = _reference(vals)
    for i, s in enumerate(out[1][0]):
        if i == 3:
            assert s.state is SessionState.FAILED
            assert "chaos" in s.failed_reason
        else:
            assert np.array_equal(np.asarray(s.result), ref[i])
    res = ps.stats["resilience"]
    assert res["bisections"] == 2 and res["quarantined"] == 1
    assert res["dead_letter"][0][0] == 3
    assert ps.stats["sessions"]["failed"] == 1


def test_whole_batch_quarantined_without_bisection():
    vals = _vals(S=4)
    # the reference raises its own ChaosError, the port its own
    js, ps = services(_params(), batching=BatchingConfig(max_batch=64,
                                                         max_age=1e9),
                      chaos=ChaosConfig(mode="dispatch"),
                      retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0,
                                        bisect=False))
    outs = []
    for svc, err in ((js, ChaosError), (ps, PC.ChaosError)):
        ss = feed(svc, vals)
        with pytest.raises(err):
            svc.pump(force=True)
        outs.append((ss, None))
        assert svc.pump(force=True) == 0
    _same_outcome(js, ps, outs)
    res = ps.stats["resilience"]
    assert res["bisections"] == 0 and res["quarantined"] == 4
    assert sorted(sid for sid, _ in res["dead_letter"]) == [0, 1, 2, 3]


def test_pump_isolates_poisoned_key_and_reraises_after_sweep():
    vals = _vals(S=2)
    js, ps = services(_params(), batching=BatchingConfig(max_batch=64,
                                                         max_age=1e9),
                      chaos=ChaosConfig(mode="dispatch", poison_sids=(0,)),
                      retry=RetryPolicy(max_attempts=1))
    got = []
    for svc, err in ((js, ChaosError), (ps, PC.ChaosError)):
        (sa,) = feed(svc, vals[:1])
        (sb,) = feed(svc, np.full((1, N, 100), 0.25, np.float32),
                     params=(_params(elems=100) if svc is js
                             else port_params(_params(elems=100))))
        with pytest.raises(err):
            svc.pump(force=True)
        assert svc.queue.depth() == 0
        got.append((sa.state.value, sb.state.value, np.asarray(sb.result)))
    assert got[0][:2] == got[1][:2] == ("failed", "revealed")
    assert np.array_equal(got[0][2], got[1][2])
    assert np.allclose(got[1][2], np.full(100, 0.25 * N), atol=1e-4)


# ---------------------------------------------------------------------------
# Chaos storm over the fixed seed sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_storm_matches_reference_and_replays(seed):
    """p = 0.4 storms: every session terminal, survivors equal to the
    fault-free run, quarantines dead-lettered — and the port's outcome
    (states, dead letter, injections) equals the reference's, twice."""
    vals = _vals(S=8)
    ref = _reference(vals)
    outcomes = []
    for _ in range(2):
        js, ps = services(_params(), batching=BatchingConfig(
            max_batch=64, max_age=1e9),
            chaos=ChaosConfig(mode="dispatch", p=0.4, seed=seed),
            retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0))
        outs = []
        for svc, err in ((js, ChaosError), (ps, PC.ChaosError)):
            ss = feed(svc, vals)
            try:
                svc.pump(force=True)
            except err:
                pass
            outs.append((ss, None))
        _same_outcome(js, ps, outs)
        dead = dict(ps.executor.dead_letter)
        for i, s in enumerate(outs[1][0]):
            assert s.state in (SessionState.REVEALED, SessionState.FAILED)
            if s.state is SessionState.REVEALED:
                assert np.array_equal(np.asarray(s.result), ref[i])
            else:
                assert "chaos" in dead[s.sid]
        outcomes.append((states(outs[1][0]),
                         ps.stats["resilience"]["chaos_injected"]))
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# Session deadlines and load shedding
# ---------------------------------------------------------------------------


def test_session_deadline_expires_at_pump_not_aggregates():
    vals = _vals(S=2)
    js, ps = services(_params(), batching=BatchingConfig(max_batch=64,
                                                         max_age=1e9))
    outs = []
    for svc in (js, ps):
        doomed = svc.open(now=0.0, ttl=5.0)
        live = svc.open(now=0.0)
        for slot in range(N):
            doomed.contribute(slot, vals[0, slot])
            live.contribute(slot, vals[1, slot])
        svc.seal(doomed.sid, now=0.0)
        svc.seal(live.sid, now=0.0)
        ran = svc.pump(now=10.0, force=True)
        outs.append((ran, doomed.state.value, doomed.failed_reason,
                     live.state.value, np.asarray(live.result),
                     svc.queue.metrics))
        svc.evict(doomed.sid)
        with pytest.raises(KeyError):
            svc.result(doomed.sid)
    assert outs[0][:4] == outs[1][:4] == (
        1, "expired", "deadline: session expired before aggregation",
        "revealed")
    assert np.array_equal(outs[0][4], outs[1][4])
    assert outs[0][5] == outs[1][5]


def test_default_ttl_comes_from_batching_config():
    js, ps = services(_params(), batching=BatchingConfig(
        max_batch=64, max_age=1e9, session_ttl=7.0))
    for svc in (js, ps):
        assert svc.open(now=1.0).expires_at == 8.0
        assert svc.open(now=1.0, ttl=2.0).expires_at == 3.0


def test_force_pump_drains_expired_keys_under_logical_ticks():
    js, ps = services(_params(), batching=BatchingConfig(max_batch=64,
                                                         max_age=1e9))
    outs = []
    for svc in (js, ps):
        doomed = [svc.open(now=0.0, ttl=1.0) for _ in range(3)]
        for s in doomed:
            for slot in range(N):
                s.contribute(slot, np.zeros(ELEMS, np.float32))
            svc.seal(s.sid, now=0.0)
        outs.append((svc.pump(now=50.0, force=True),
                     [s.state.value for s in doomed], svc.queue.depth(),
                     bool(svc.queue._pending), svc.queue.metrics,
                     svc.executor.batches_run))
    assert outs[0] == outs[1]
    assert outs[1][:4] == (0, ["expired"] * 3, 0, False)


@pytest.mark.parametrize("case", ["newest", "weighted_fair"])
def test_load_shedding(case):
    """Over ``max_pending_rows`` the newest arrivals are shed (EXPIRED,
    flush reason "shed"); across keys, victims come from the big young
    key, never from the old one — the port's states and queue metrics
    equal the reference's."""
    limit = 4 if case == "newest" else 3
    js, ps = services(_params(), batching=BatchingConfig(
        max_batch=64, max_age=1e9, max_pending_rows=limit))
    outs = []
    for svc in (js, ps):
        ss = []
        if case == "newest":
            for i in range(6):
                ss += feed(svc, np.zeros((1, N, ELEMS), np.float32),
                           now=float(i))
        else:
            ss += feed(svc, np.zeros((2, N, ELEMS), np.float32), now=0.0)
            p100 = (_params(elems=100) if svc is js
                    else port_params(_params(elems=100)))
            ss += feed(svc, np.zeros((3, N, 100), np.float32), now=10.0,
                       params=p100)
        before = (states(ss), [s.failed_reason for s in ss],
                  svc.queue.metrics)
        outs.append((before, svc.pump(force=True), states(ss)))
    assert outs[0] == outs[1]
    if case == "newest":
        assert outs[1][0][0] == ["sealed"] * 4 + ["expired"] * 2
        assert outs[1][0][2]["shed_sessions"] == 2
        assert outs[1][2] == ["revealed"] * 4 + ["expired"] * 2
    else:
        assert outs[1][0][0] == ["sealed"] * 3 + ["expired"] * 2


# ---------------------------------------------------------------------------
# Degrade ladder: circuit breaker falls back to the sim oracle
# ---------------------------------------------------------------------------


def test_breaker_trips_degrades_and_reprobes_single_host():
    """A mesh executor whose every mesh attempt dies of dispatch chaos
    before it touches the mesh (no process group: nothing to agree
    with): trip after k = 2, degraded sim batches equal the fault-free
    run, a probe after the cooloff fails and restarts it — the port's
    ladder equal to the reference's at every step."""
    clk = {"t": 0.0}
    vals = _vals()
    js, ps = services(
        _params(), batching=BatchingConfig(max_batch=64, max_age=1e9),
        transport="mesh", mesh=object(),
        retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0),
        breaker=dict(k=2, cooloff_s=50.0, clock=lambda: clk["t"]),
        chaos=ChaosConfig(mode="dispatch", only_backend="mesh"))
    steps = {}
    for side, svc in (("ref", js), ("port", ps)):
        clk["t"] = 0.0
        log = []
        ss = feed(svc, vals)
        log.append((svc.pump(force=True), results(ss),
                    svc.stats["resilience"]))
        ss = feed(svc, vals[:1])
        log.append((svc.pump(force=True), results(ss),
                    svc.stats["resilience"]))
        clk["t"] = 100.0
        ss = feed(svc, vals[1:2])
        log.append((svc.pump(force=True), results(ss),
                    svc.stats["resilience"]))
        steps[side] = log
    for (jn, jr, jres), (pn, pr, pres) in zip(steps["ref"], steps["port"]):
        assert jn == pn and np.array_equal(jr, pr) and jres == pres
    ref = _reference(vals)
    assert np.array_equal(steps["port"][0][1], ref)
    res = [r for _, _, r in steps["port"]]
    assert res[0]["breaker"]["state"] == "open" and res[0]["retries"] == 2
    assert [r["degraded_batches"] for r in res] == [1, 2, 3]
    assert res[2]["breaker"] == {"state": "open", "consecutive_failures": 3,
                                 "trips": 1, "probes": 1}


def test_facade_surfaces_degradation():
    brk = CircuitBreaker(k=1, cooloff_s=1e9)
    agg = PA.SecureAggregator(topology=PA.Topology(n_nodes=N), breaker=brk,
                              device="cpu")
    s = agg.open_session(4)
    for slot in range(N):
        s.contribute(slot, np.zeros(4, np.float32))
    agg.seal(s.sid)
    agg.drain()
    assert agg.stats()["degraded"] is False
    brk.record_failure()
    assert agg.stats()["degraded"] is True
    assert agg.stats()["service"]["resilience"]["breaker"]["trips"] == 1


# ---------------------------------------------------------------------------
# Unit pins: policy determinism, validation, chaos schedule, transport
# ---------------------------------------------------------------------------


def test_backoff_equals_reference_and_is_bounded():
    from repro.runtime import resilience as JR
    p = PR.RetryPolicy(base_backoff_s=0.1, backoff_factor=2.0, jitter=0.25)
    jp = JR.RetryPolicy(base_backoff_s=0.1, backoff_factor=2.0, jitter=0.25)
    for salt in (0, 1, 7, 2 ** 32 - 1):
        for attempt in (1, 2, 3):
            d = p.backoff_s(attempt, salt=salt)
            assert d == jp.backoff_s(attempt, salt=salt)
            base = 0.1 * 2.0 ** (attempt - 1)
            assert base * 0.75 <= d <= base * 1.25
    assert p.backoff_s(1, salt=1) != p.backoff_s(1, salt=2)
    assert PR.RetryPolicy(base_backoff_s=0.0).backoff_s(1) == 0.0
    for a, b in ((0, 0), (5, 9), (2 ** 32 - 1, 2 ** 31)):
        assert PR._mix32(a, b) == JR._mix32(a, b)


@pytest.mark.parametrize("cls,bad", [
    ("retry", dict(max_attempts=0)), ("retry", dict(base_backoff_s=-1.0)),
    ("retry", dict(backoff_factor=0.5)), ("retry", dict(jitter=2.0)),
    ("retry", dict(deadline_s=0.0)),
    ("chaos", dict(mode="nope")), ("chaos", dict(p=1.5)),
    ("chaos", dict(times=-1)), ("chaos", dict(hop_k=-1)),
    ("chaos", dict(slow_s=-0.1)), ("chaos", dict(only_backend="tpu")),
    ("breaker", dict(k=0)), ("breaker", dict(cooloff_s=-1.0)),
])
def test_knobs_validate_like_the_reference(cls, bad):
    from repro.runtime import chaos as JCh
    from repro.runtime import resilience as JR
    pairs = {"retry": (JR.RetryPolicy, PR.RetryPolicy),
             "chaos": (JCh.ChaosConfig, PC.ChaosConfig),
             "breaker": (JR.CircuitBreaker, PR.CircuitBreaker)}
    jcls, pcls = pairs[cls]
    with pytest.raises(JR.ResilienceError) as je:
        jcls(**bad)
    with pytest.raises(ResilienceError) as pe:
        pcls(**bad)
    assert str(pe.value) == str(je.value)


def test_breaker_snapshots():
    b = CircuitBreaker(k=2, cooloff_s=5.0, clock=lambda: 0.0)
    assert b.snapshot() == {"state": "closed", "consecutive_failures": 0,
                            "trips": 0, "probes": 0}


def test_chaos_schedule_decisions_equal_reference():
    from repro.runtime import chaos as JCh

    class _S:
        def __init__(self, sid):
            self.sid = sid

    def stream(mod, seed, **kw):
        sched = mod.ChaosSchedule(mod.ChaosConfig(mode="dispatch", p=0.5,
                                                  seed=seed, **kw))
        return tuple(sched.decide([_S(i % 3)], "sim") is not None
                     for i in range(64))

    for seed in (0, 5, 6):
        assert stream(PC, seed) == stream(JCh, seed)
    assert stream(PC, 5, poison_sids=(1,)) == stream(JCh, 5,
                                                     poison_sids=(1,))
    assert stream(PC, 5) != stream(PC, 6)
    cfg = C.chaos_from_fields(dataclasses.asdict(
        ChaosConfig(mode="hop", hop_k=2, times=3, poison_sids=(4,))))
    assert (cfg.mode, cfg.hop_k, cfg.times, cfg.poison_sids) == \
        ("hop", 2, 3, (4,))


def test_chaos_transport_delegates_everything_but_armed_hops():
    class Inner:
        impl = "torch"

        def hop(self, rnd, rnd_idx, meta, acc):
            return ("hopped", rnd_idx)

    tp = PC.ChaosTransport(Inner(), PC.ChaosConfig(mode="hop", hop_k=2))
    assert tp.impl == "torch"
    assert tp.hop(None, 1, None, None) == ("hopped", 1)
    with pytest.raises(PC.ChaosError):
        tp.hop(None, 2, None, None)
    assert PC.ChaosTransport(Inner(), None).hop(None, 2, None, None) \
        == ("hopped", 2)
    assert issubclass(DeadlineExceeded, RuntimeError)


# ---------------------------------------------------------------------------
# Streaming ring: fault in an overlapped in-flight batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dispatch", "hop"])
def test_streaming_inflight_fault_settles_retries_bit_identical(mode):
    vals = _vals(S=8)
    batching = BatchingConfig(max_batch=4, max_age=1e9)
    _, seq = services(_params(), batching=batching,
                      stream=StreamConfig(depth=1))
    ss = feed(seq, vals)
    assert seq.pump(force=True) == 8
    ref = results(ss)
    js, ps, out = _run_both(
        vals, batching=batching,
        retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0),
        chaos=ChaosConfig(mode=mode, hop_k=0, times=1, poison_sids=(5,)),
        stream=StreamConfig(depth=2))
    _same_outcome(js, ps, out)
    assert out[1][1] == 8
    assert np.array_equal(results(out[1][0]), ref)
    res = ps.stats["resilience"]
    assert res["chaos_injected"] == 1 and res["retries"] == 1
    assert res["quarantined"] == 0
    assert ps.metrics.snapshot()["gauges"]["executor.pipeline_depth"] == 2.0
