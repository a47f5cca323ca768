"""The port's multi-session service against ``repro.service`` on the CPU.

Every case builds the reference's and the port's service from one
description (``tests/torch_service_pair.py``: the reference's objects,
carried across by ``repro_torch.convert``), feeds both the same seeded
numpy payloads and holds the port to the reference: revealed results bit
for bit, session states, queue metrics and flush reasons, cache
counters, batch sizes.  The cases are the outcomes of
``tests/test_service.py``, the facade's session tests in
``tests/test_api.py`` and the digest-transport service cell of
``tests/test_conformance.py``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import overlay as JOV
from repro.core.byzantine import ByzantineSpec
from repro.core.engine import sim_batch as j_sim_batch
from repro.core.plan import AggConfig, SessionMeta as JMeta, compile_plan
from repro.runtime.fault import FaultPlanError, SessionFaultPlan
from repro.runtime.resilience import RetryPolicy
from repro.service import BatchingConfig, SessionParams, StreamConfig
from repro.service import EpochManager as JS_EpochManager
from repro.service.session import Session, derive_session_seed
from repro_torch import api as PA
from repro_torch import convert as C
from repro_torch.core import engine as PE
from repro_torch.core import plan as PP
from repro_torch.runtime import fault as PF
from repro_torch.service import (LifecycleError, SessionState)
from repro_torch.service import session as PSess
from torch_service_pair import (fault_for, feed, port_params, results,
                                services, states)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(11)


def _params(n=8, elems=16, c=4, **kw):
    return SessionParams(n_nodes=n, elems=elems, cluster_size=c,
                         redundancy=3, **kw)



# ---------------------------------------------------------------------------
# The batched engine path the service runs on
# ---------------------------------------------------------------------------


def _port_batch(cfg, xs, seeds=None, offsets=None, faults=None,
                reveal_only=False):
    pcfg = C.config_from_fields(dataclasses.asdict(cfg))
    S, n = xs.shape[:2]
    meta = PP.SessionMeta.build(S, n, device="cpu", seed=cfg.seed,
                                seeds=seeds, offsets=offsets, faults=[
                                    tuple(PF.ByzantineSpec(
                                        corrupt_ranks=sp.corrupt_ranks,
                                        mode=sp.mode) for sp in f)
                                    for f in faults] if faults else None)
    out, _ = PE.sim_batch(PP.compile_plan(pcfg), torch.from_numpy(xs), meta,
                          reveal_only=reveal_only)
    return out.numpy()


def _ref_batch(cfg, xs, seeds=None, offsets=None, faults=None,
               reveal_only=False):
    S, n = xs.shape[:2]
    meta = JMeta.build(S, n, seed=cfg.seed, seeds=seeds, offsets=offsets,
                       faults=faults)
    out, _ = j_sim_batch(compile_plan(cfg), xs, meta,
                         reveal_only=reveal_only)
    return np.asarray(out)


@pytest.mark.parametrize("schedule", ["ring", "butterfly"])
def test_batched_equals_monolithic_under_faults(schedule):
    """S = 8 sessions of n = 16 with a crash and a Byzantine session, per
    session pad keys: the port's batch == the reference's batch == the
    port's S monolithic runs, bit for bit."""
    S, n, T = 8, 16, 333
    xs = (RNG.normal(size=(S, n, T)) * 0.2).astype(np.float32)
    seeds = np.asarray([0x5EC0A66 + 977 * s for s in range(S)], np.uint32)
    faults = [() for _ in range(S)]
    faults[2] = (ByzantineSpec(corrupt_ranks=(5,), mode="drop"),)
    faults[5] = (ByzantineSpec(corrupt_ranks=(10,), mode="flip"),)
    cfg = AggConfig(n_nodes=n, cluster_size=4, redundancy=3,
                    schedule=schedule, clip=2.0)
    got = _port_batch(cfg, xs, seeds=seeds, faults=faults)
    assert np.array_equal(got, _ref_batch(cfg, xs, seeds=seeds,
                                          faults=faults))
    for s in range(S):
        scfg = dataclasses.replace(
            cfg, seed=int(seeds[s]),
            byzantine=faults[s][0] if faults[s] else ByzantineSpec())
        assert np.array_equal(got[s], _port_batch(scfg, xs[s:s + 1])[0]), s
    assert np.abs(got[:, 0] - xs.sum(1)).max() < 1e-4


@pytest.mark.parametrize("case", ["reveal_only", "offsets"])
def test_reveal_and_offsets_match_reference(case):
    """``reveal_only`` == member 0 of the full output, and a session at
    counter offset k == the tail of a longer session's stream: the port
    equals the reference in both."""
    cfg = AggConfig(n_nodes=16, cluster_size=4, redundancy=3)
    if case == "reveal_only":
        xs = (RNG.normal(size=(4, 16, 257)) * 0.2).astype(np.float32)
        seeds = np.arange(4, dtype=np.uint32) + 3
        full = _port_batch(cfg, xs, seeds=seeds)
        ro = _port_batch(cfg, xs, seeds=seeds, reveal_only=True)
        assert np.array_equal(full[:, 0], ro)
        assert np.array_equal(ro, _ref_batch(cfg, xs, seeds=seeds,
                                             reveal_only=True))
    else:
        k = 64
        x = (RNG.normal(size=(1, 16, 128)) * 0.2).astype(np.float32)
        seeds = np.asarray([42], np.uint32)
        whole = _port_batch(cfg, x, seeds=seeds)
        tail = _port_batch(cfg, x[:, :, k:].copy(), seeds=seeds,
                           offsets=np.asarray([k], np.uint32))
        assert np.array_equal(whole[:, :, k:], tail)
        assert np.array_equal(tail, _ref_batch(
            cfg, x[:, :, k:].copy(), seeds=seeds,
            offsets=np.asarray([k], np.uint32)))


# ---------------------------------------------------------------------------
# Session lifecycle
# ---------------------------------------------------------------------------


def test_lifecycle_enforced():
    _, ps = services(_params(), batching=BatchingConfig(max_batch=1))
    s = ps.open()
    assert s.state is SessionState.OPEN
    with pytest.raises(LifecycleError):
        _ = s.result
    s.contribute(0, np.ones(16, np.float32))
    with pytest.raises(ValueError):
        s.contribute(99, np.ones(16, np.float32))
    with pytest.raises(ValueError):
        s.contribute(1, torch.ones(5))
    ps.seal(s.sid)
    assert s.state is SessionState.SEALED
    with pytest.raises(LifecycleError):
        s.contribute(1, np.ones(16, np.float32))
    ps.pump(force=True)
    assert s.state is SessionState.REVEALED
    assert s.result.dtype == torch.float32 and s.result.device.type == "cpu"
    with pytest.raises(LifecycleError):
        s.seal()


def test_missing_contributions_count_as_zero_and_crash():
    vals = RNG.integers(0, 2, size=(1, 16, 8)).astype(np.float32)
    skip = {(0, i) for i in range(16) if i % 5 == 0}
    js, ps = services(_params(n=16, elems=8),
                      batching=BatchingConfig(max_batch=1))
    (sj,), (sp,) = (feed(svc, vals, skip=skip) for svc in (js, ps))
    assert tuple(sp.fault.crashed_slots) == tuple(sj.fault.crashed_slots) \
        == (0, 5, 10, 15)
    for svc in (js, ps):
        svc.pump(force=True)
    assert np.array_equal(np.asarray(sp.result), np.asarray(sj.result))
    want = vals[0, [i for i in range(16) if i % 5]].sum(0)
    assert np.allclose(np.asarray(sp.result), want, atol=1e-4)


def test_session_seeds_equal_reference():
    js, ps = services(_params())
    pj = [js.open().seed for _ in range(64)]
    pp = [ps.open().seed for _ in range(64)]
    assert pj == pp and len(set(pp)) == 64
    for base, sid in ((0, 0), (0xFFFFFFFF, 7), (0x5EC0A66, 2 ** 31 + 5)):
        assert PSess.derive_session_seed(base, sid) == \
            derive_session_seed(base, sid)


# ---------------------------------------------------------------------------
# Admission watermarks and batching
# ---------------------------------------------------------------------------


def test_size_watermark_flushes_full_batches():
    js, ps = services(_params(),
                      batching=BatchingConfig(max_batch=4, max_age=1e9))
    vals = np.full((10, 8, 16), 0.5, np.float32)
    out = []
    for svc in (js, ps):
        ss = feed(svc, vals)
        out.append((svc.pump(now=0.0), svc.stats["batches"]["sizes"],
                    svc.queue.depth(), states(ss)))
    assert out[0] == out[1] == (8, (4, 4), 2, ["revealed"] * 8
                                + ["sealed"] * 2)


def test_age_watermark_flushes_partial_batches():
    js, ps = services(_params(),
                      batching=BatchingConfig(max_batch=4, max_age=5.0))
    out = []
    for svc in (js, ps):
        feed(svc, np.full((1, 8, 16), 0.5, np.float32), now=0.0)
        feed(svc, np.full((1, 8, 16), 0.5, np.float32), now=2.0)
        out.append((svc.pump(now=3.0), svc.pump(now=5.0),
                    svc.stats["batches"]["sizes"]))
    assert out[0] == out[1] == (0, 2, (2,))


def test_incompatible_sessions_never_share_a_batch():
    js, ps = services(_params(),
                      batching=BatchingConfig(max_batch=8, max_age=1e9))
    other = _params(clip=2.0)
    vals = np.full((1, 8, 16), 0.5, np.float32)
    out = []
    for svc in (js, ps):
        a = feed(svc, vals)
        b = feed(svc, vals, params=other if svc is js else
                 port_params(other))
        out.append((svc.pump(force=True),
                    sorted(svc.stats["batches"]["sizes"]),
                    results(a + b)))
    assert out[0][:2] == out[1][:2] == (2, [1, 1])
    assert np.array_equal(out[0][2], out[1][2])


def test_pad_bucket_rounds_up_payload_length():
    pb = C.batching_from_fields(dataclasses.asdict(
        BatchingConfig(pad_buckets=(64, 256))))
    assert [pb.padded_elems(e) for e in (3, 64, 65, 1000)] == \
        [64, 64, 256, 1024]
    js, ps = services(_params(elems=33), batching=BatchingConfig(
        max_batch=1, pad_buckets=(64,)))
    vals = np.full((1, 8, 33), 0.5, np.float32)
    out = []
    for svc in (js, ps):
        (s,) = feed(svc, vals)
        svc.pump(force=True)
        out.append(np.asarray(s.result))
    assert out[1].shape == (33,)
    assert np.array_equal(out[0], out[1])
    assert np.allclose(out[1], np.full(33, 0.5 * 8), atol=1e-4)


@pytest.mark.parametrize("masking", ["global", "pairwise"])
def test_batched_service_matches_per_session_and_reference(masking):
    """12 (6 pairwise, one with a missing slot) sessions through one
    batch == the same sessions one by one (max_batch = 1) == the
    reference's batch, bit for bit."""
    S = 12 if masking == "global" else 6
    vals = (RNG.normal(size=(S, 8, 16)) * 0.3).astype(np.float32)
    params = _params(masking=masking, clip=2.0)
    skip = {(3, 2)} if masking == "pairwise" else set()
    got = {}
    for max_batch in (S, 1):
        js, ps = services(params, batching=BatchingConfig(
            max_batch=max_batch, max_age=1e9))
        for side, svc in (("ref", js), ("port", ps)):
            ss = feed(svc, vals, skip=skip)
            svc.pump(force=True)
            got[side, max_batch] = results(ss)
    assert np.array_equal(got["port", S], got["port", 1])
    assert np.array_equal(got["port", S], got["ref", S])
    want = vals.sum(1)
    for i, slot in skip:
        want[i] -= vals[i, slot]
    assert np.abs(got["port", S] - want).max() < 1e-4


def test_executor_failure_fails_batch_not_wedges(monkeypatch):
    vals = np.full((1, 8, 16), 0.5, np.float32)
    js, ps = services(_params(), batching=BatchingConfig(max_batch=4,
                                                         max_age=1e9),
                      retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0))

    def boom(*a, **k):
        raise RuntimeError("injected executor failure")

    out = []
    for svc in (js, ps):
        (s,) = feed(svc, vals)
        monkeypatch.setattr(svc.executor, "_compiled", boom)
        with pytest.raises(RuntimeError):
            svc.pump(force=True)
        assert "injected" in s.failed_reason
        out.append((s.state.value, svc.queue.depth(), svc.pump(force=True),
                    svc.stats["resilience"], svc.stats["sessions"]))
        svc.evict(s.sid)
    assert out[0] == out[1]
    assert out[1][0] == "failed" and out[1][2] == 0
    assert out[1][3]["retries"] == 1 and out[1][3]["quarantined"] == 1


def test_reveal_frees_payloads_and_evict_forgets():
    _, ps = services(_params(), batching=BatchingConfig(max_batch=1))
    (s,) = feed(ps, np.full((1, 8, 16), 0.5, np.float32))
    ps.pump(force=True)
    assert s.contributed_slots == tuple(range(8))
    assert not s._contrib
    assert tuple(ps.result(s.sid, evict=True).shape) == (16,)
    with pytest.raises(KeyError):
        ps.result(s.sid)


def test_fault_patterns_share_one_compiled_executable():
    vals = RNG.integers(0, 2, size=(16, 8)).astype(np.float32)
    js, ps = services(_params(n=16, elems=8),
                      batching=BatchingConfig(max_batch=1, max_age=1e9))
    got = []
    for svc in (js, ps):
        res = []
        for victim in (0, 5, 10):
            (s,) = feed(svc, vals[None], skip={(0, victim)})
            svc.pump(force=True)
            res.append(np.asarray(s.result))
        got.append(np.stack(res))
        assert len(svc.executor._fns) == 1
        assert svc.executor.cache_stats == {"hits": 2, "misses": 1,
                                            "bucket_hits": 0, "size": 1}
    assert np.array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# Streaming pipeline: overlapped dispatch == sequential, bucket fallback
# ---------------------------------------------------------------------------


def _stream_pair(vals, depth, **kw):
    params = SessionParams(n_nodes=8, elems=vals.shape[2], cluster_size=4,
                           redundancy=3)
    js, ps = services(params, batching=BatchingConfig(max_batch=4,
                                                      max_age=1e9),
                      stream=StreamConfig(depth=depth), **kw)
    out = []
    for svc in (js, ps):
        ss = feed(svc, vals)
        assert svc.pump(force=True) == len(vals)
        out.append(results(ss))
    return js, ps, out


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_depths_bit_identical_to_sequential(depth):
    vals = (RNG.normal(size=(12, 8, 16)) * 0.3).astype(np.float32)
    _, _, (ref1, _) = _stream_pair(vals, 1)
    js, ps, (jr, pr) = _stream_pair(vals, depth)
    assert np.array_equal(pr, ref1) and np.array_equal(pr, jr)
    g = ps.metrics.snapshot()["gauges"]["executor.pipeline_depth"]
    assert g == js.metrics.snapshot()["gauges"][
        "executor.pipeline_depth"] == float(depth)


def test_shape_bucket_fallback_pads_rows_bit_identical():
    vals = (RNG.normal(size=(7, 8, 16)) * 0.3).astype(np.float32)
    _, _, (ref, _) = _stream_pair(vals, 1)
    js, ps, (jr, pr) = _stream_pair(vals[:4], 2)
    assert np.array_equal(pr, ref[:4])
    out = []
    for svc in (js, ps):
        ss = feed(svc, vals[4:])
        assert svc.pump(force=True) == 3
        out.append(results(ss))
        ex = svc.executor
        assert ex.cache_stats["bucket_hits"] == 1
        for f in list(ex._warming.values()):
            f.result(timeout=60)
        ex._drain_warmed()
        assert any(k[1] == 3 for k in ex._fns)
    assert np.array_equal(out[1], ref[4:]) and np.array_equal(out[0], out[1])
    assert ps.executor.cache_stats == js.executor.cache_stats


def test_fill_payload_rows_matches_payload_rows():
    params = _params(elems=40)
    vals = RNG.normal(size=(8, 40)).astype(np.float32)
    bufs = []
    for mod, p in ((Session, params), (PSess.Session, port_params(params))):
        s = mod(3, p, derive_session_seed(9, 3))
        for slot in range(8):
            if slot != 5:
                s.contribute(slot, vals[slot])
        s.seal(0.0)
        k = s.n_rows(16)
        assert k == 3
        dirty = np.full((k + 1, 8, 16), np.nan, np.float32)
        assert s.fill_payload_rows(dirty, 1, 16) == k
        assert np.array_equal(dirty[1:], np.stack(s.payload_rows(16)))
        assert np.all(np.isnan(dirty[0]))
        bufs.append(dirty[1:])
    assert np.array_equal(bufs[0], bufs[1])


# ---------------------------------------------------------------------------
# Churn epochs: pinned sessions survive mid-flight churn
# ---------------------------------------------------------------------------


def _overlay_pair(n=256, tau=0.2, seed=3):
    ov = JOV.build_overlay(n, tau, seed=seed)
    return ov, C.overlay_from_fields(C.overlay_fields(ov))


def _epoch_services(max_batch=4):
    ovj, ovp = _overlay_pair()
    n = JS_EpochManager(ovj, cluster_size=4).current().n_nodes
    js, ps = services(
        _params(n=n, elems=8),
        batching=BatchingConfig(max_batch=max_batch, max_age=1e9),
        epochs=(dict(overlay=ovj, cluster_size=4),
                dict(overlay=ovp, cluster_size=4)))
    return (ovj, ovp), js, ps


def test_epoch_snapshot_is_stable_until_advance():
    _, js, ps = _epoch_services()
    for svc in (js, ps):
        em = svc.epochs
        assert em.current() is em.current()
    old_j, old_p = js.epochs.current(), ps.epochs.current()
    assert dataclasses.asdict(old_j) == dataclasses.asdict(old_p)
    assert C.epoch_snapshot_from_fields(dataclasses.asdict(old_j)) == old_p
    new_j = js.epochs.churn(joins=2, leaves=2)
    new_p = ps.epochs.churn(joins=2, leaves=2)
    assert new_p.epoch == old_p.epoch + 1 and ps.epochs.current() is new_p
    assert dataclasses.asdict(new_j) == dataclasses.asdict(new_p)
    assert js.epochs.observed_churn_rate() == ps.epochs.observed_churn_rate()


def test_epoch_pinned_sessions_survive_mid_flight_churn():
    (ovj, ovp), js, ps = _epoch_services()
    n = ps.default_params.n_nodes
    vals = RNG.integers(0, 2, size=(1, n, 8)).astype(np.float32)
    out = []
    for ov, svc in ((ovj, js), (ovp, ps)):
        em = svc.epochs
        old_snap = em.current()
        (s_old,) = feed(svc, vals, now=0.0)
        victims = [old_snap.slot_uids[cl * 4 + (cl % 4)]
                   for cl in range(old_snap.n_clusters)]
        for uid in dict.fromkeys(victims):
            ov.leave(uid)
        em.advance()
        (s_new,) = feed(svc, vals, now=1.0)
        assert s_new.epoch.epoch == old_snap.epoch + 1
        svc.pump(force=True)
        departed = set(em.departed_slots(old_snap))
        assert departed and departed <= set(s_old.fault.crashed_slots)
        out.append((results([s_old, s_new]), sorted(departed)))
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    assert np.allclose(out[1][0], vals[0].sum(0), atol=1e-4)


def test_mid_session_byzantine_flip_is_out_voted():
    _, js, ps = _epoch_services()
    n = ps.default_params.n_nodes
    vals = RNG.integers(0, 2, size=(1, n, 8)).astype(np.float32)
    out = []
    for svc in (js, ps):
        (s,) = feed(svc, vals,
                    fault={0: SessionFaultPlan(byzantine_slots=(1,))})
        svc.pump(force=True)
        out.append(np.asarray(s.result))
    assert np.array_equal(out[0], out[1])
    assert np.allclose(out[1], vals[0].sum(0), atol=1e-4)


# ---------------------------------------------------------------------------
# Long payloads: one session chunked across multiple batch rows
# ---------------------------------------------------------------------------


def test_long_payload_chunks_across_rows_pinned_to_monolithic():
    elems, n = 1000, 8
    vals = (RNG.normal(size=(1, n, elems)) * 0.3).astype(np.float32)
    params = _params(elems=elems, clip=2.0)
    got = {}
    for name, batching in (
            ("chunk", BatchingConfig(max_batch=8, pad_buckets=(256,),
                                     max_row_elems=256)),
            ("mono", BatchingConfig(max_batch=8, pad_buckets=(1024,)))):
        js, ps = services(params, batching=batching)
        for side, svc in (("ref", js), ("port", ps)):
            (s,) = feed(svc, vals)
            assert svc.pump(force=True) == 1
            got[side, name] = np.asarray(s.result)
        assert ps.get(0).n_rows(256 if name == "chunk" else 1024) == \
            (4 if name == "chunk" else 1)
    assert got["port", "chunk"].shape == (elems,)
    assert np.array_equal(got["port", "chunk"], got["port", "mono"])
    assert np.array_equal(got["port", "chunk"], got["ref", "chunk"])
    assert np.abs(got["port", "chunk"] - vals[0].sum(0)).max() < 1e-4


def test_row_watermark_counts_rows_not_sessions():
    js, ps = services(_params(elems=1000), batching=BatchingConfig(
        max_batch=8, max_age=1e9, pad_buckets=(256,), max_row_elems=256))
    vals = np.full((3, 8, 1000), 0.5, np.float32)
    out = []
    for svc in (js, ps):
        ss = feed(svc, vals)
        out.append((svc.pump(now=0.0), states(ss), svc.pump(force=True),
                    results(ss)))
    assert out[0][:3] == out[1][:3] == (2, ["revealed", "revealed",
                                            "sealed"], 1)
    assert np.array_equal(out[0][3], out[1][3])


# ---------------------------------------------------------------------------
# Admission telemetry: per-key watermarks, flush reasons, starvation
# ---------------------------------------------------------------------------


def test_queue_metrics_track_watermarks_and_flush_reasons():
    js, ps = services(_params(),
                      batching=BatchingConfig(max_batch=2, max_age=5.0))
    one = np.full((1, 8, 16), 0.5, np.float32)
    out = []
    for svc in (js, ps):
        q = svc.queue
        feed(svc, one, now=0.0)
        ages = list(q.oldest_ages(now=3.0).values())
        feed(svc, one, now=1.0)
        pumps = [svc.pump(now=1.0)]
        feed(svc, one, now=2.0)
        pumps += [svc.pump(now=4.0), svc.pump(now=20.0)]
        feed(svc, one, now=21.0)
        pumps.append(svc.pump(now=21.0, force=True))
        assert svc.stats["queue"] == q.metrics
        out.append((ages, pumps, q.metrics))
    assert out[0] == out[1]
    assert out[1][1] == [2, 0, 1, 1]
    assert out[1][2]["flush_reasons"] == {"size": 1, "age": 1, "force": 1,
                                          "shed": 0}
    assert out[1][2]["max_queue_age"] == 18.0
    assert out[1][2]["starved_sessions"] == 1


def test_pump_defaults_to_monotonic_clock():
    _, ps = services(_params(),
                     batching=BatchingConfig(max_batch=64, max_age=0.0))
    (s,) = feed(ps, np.full((1, 8, 16), 0.5, np.float32), now=None)
    assert ps.pump() == 1
    assert s.state is SessionState.REVEALED


def test_fault_plan_merge_keeps_groups_disjoint():
    a = SessionFaultPlan(byzantine_slots=(1, 2))
    b = SessionFaultPlan(crashed_slots=(2, 3))
    pa, pb = (C.fault_plan_from_fields(dataclasses.asdict(x))
              for x in (a, b))
    m, pm = a.merge(b), pa.merge(pb)
    assert (pm.crashed_slots, pm.byzantine_slots) == \
        (m.crashed_slots, m.byzantine_slots) == ((2, 3), (1,))
    assert [s.mode for s in pm.specs()] == [s.mode for s in m.specs()]
    with pytest.raises(FaultPlanError):
        SessionFaultPlan(crashed_slots=(1,), byzantine_slots=(1,))
    with pytest.raises(PF.FaultPlanError, match="disjoint"):
        PF.SessionFaultPlan(crashed_slots=(1,), byzantine_slots=(1,))
    with pytest.raises(PF.FaultPlanError, match="conflicting"):
        PF.SessionFaultPlan(byzantine_slots=(1,)).merge(
            PF.SessionFaultPlan(byzantine_slots=(2,),
                                byzantine_mode="garbage"))


def test_compile_plan_folds_epoch_and_fault():
    """``compile_plan(cfg, epoch=, fault=)``: the fault plan's specs join
    the static fault model (uncached), the epoch's layout is checked, a
    rank under two specs is refused — as in the reference."""
    from repro.core.plan import compile_plan as j_compile
    jcfg = AggConfig(n_nodes=8, cluster_size=4, redundancy=3,
                     byzantine=ByzantineSpec(corrupt_ranks=(6,),
                                             mode="garbage"))
    pcfg = C.config_from_fields(dataclasses.asdict(jcfg))
    fault = SessionFaultPlan(crashed_slots=(1,), byzantine_slots=(3,))
    snap = {"epoch": 0, "cluster_size": 4, "slot_uids": tuple(range(8)),
            "honest": (True,) * 8}
    before = PP.plan_cache_stats()
    pplan = PP.compile_plan(pcfg, epoch=C.epoch_snapshot_from_fields(snap),
                            fault=C.fault_plan_from_fields(
                                dataclasses.asdict(fault)))
    assert PP.plan_cache_stats() == before           # uncached
    jplan = j_compile(jcfg, fault=fault)
    assert [(s.corrupt_ranks, s.mode) for s in pplan.faults] == \
        [(s.corrupt_ranks, s.mode) for s in jplan.faults] == \
        [((6,), "garbage"), ((1,), "drop"), ((3,), "flip")]
    with pytest.raises(AssertionError):
        PP.compile_plan(pcfg, epoch=C.epoch_snapshot_from_fields(
            dict(snap, cluster_size=2)))
    with pytest.raises(AssertionError, match="multiple specs"):
        PP.compile_plan(pcfg, fault=PF.SessionFaultPlan(crashed_slots=(6,)))


# ---------------------------------------------------------------------------
# The facade's session verbs (tests/test_api.py's session cases)
# ---------------------------------------------------------------------------


def _facades(cfg, **kw):
    from repro.api import SecureAggregator
    pcfg = C.config_from_fields(dataclasses.asdict(cfg))
    pkw = {k: (C.batching_from_fields(dataclasses.asdict(v))
               if k == "batching" else v) for k, v in kw.items()}
    return (SecureAggregator(cfg, **kw),
            PA.SecureAggregator(pcfg, device="cpu", **pkw))


def test_session_params_derive_from_shared_config():
    cfg = AggConfig(n_nodes=8, cluster_size=4, redundancy=1,
                    schedule="tree", transport="digest", digest_words=8,
                    digest_backup=False, masking="pairwise", clip=4.0,
                    guard_bits=3)
    pcfg = C.config_from_fields(dataclasses.asdict(cfg))
    p = PSess.SessionParams.from_config(pcfg, elems=33)
    assert p.agg_config() == pcfg.replace(chunk_elems=1 << 16)
    assert dataclasses.asdict(p) == dataclasses.asdict(
        SessionParams.from_config(cfg, elems=33))


def test_facade_sessions_match_reference_and_direct_service():
    n, elems, S = 8, 20, 3
    vals = (RNG.normal(size=(S, n, elems)) * 0.3).astype(np.float32)
    cfg = AggConfig(n_nodes=n, cluster_size=4, redundancy=3, clip=2.0)
    ja, pa = _facades(cfg, batching=BatchingConfig(max_batch=S,
                                                   max_age=1e9))
    got = []
    for agg in (ja, pa):
        sids = []
        for i in range(S):
            s = agg.open_session(elems)
            for slot in range(n):
                if (i, slot) != (1, 2):
                    s.contribute(slot, vals[i, slot])
            agg.seal(s.sid, now=0.0)
            sids.append(s.sid)
        agg.pump(force=True)
        got.append(np.stack([np.asarray(agg.result(sid)) for sid in sids]))
    assert np.array_equal(got[0], got[1])
    _, direct = services(SessionParams.from_config(cfg, elems),
                         base_seed=cfg.seed,
                         batching=BatchingConfig(max_batch=S, max_age=1e9))
    ss = feed(direct, vals, skip={(1, 2)})
    direct.pump(force=True)
    assert np.array_equal(results(ss), got[1])
    st = pa.stats()
    assert st["service"]["sessions"]["run"] == S and pa.service is not None
    assert st["degraded"] is False
    assert set(st["metrics"]) == {"counters", "gauges", "histograms"}


def test_service_stats_schema_snapshot_is_pinned():
    from repro_torch.obs import (SVC_STATS_DEPRECATED, SVC_STATS_KEYS,
                                 SVC_STATS_VERSION)
    n, elems, S = 8, 20, 2
    vals = (RNG.normal(size=(S, n, elems)) * 0.3).astype(np.float32)
    ja, pa = _facades(AggConfig(n_nodes=n, cluster_size=4, redundancy=3,
                                clip=2.0))
    sts = []
    for agg in (ja, pa):
        for i in range(S):
            s = agg.open_session(elems)
            for slot in range(n):
                s.contribute(slot, vals[i, slot])
            agg.seal(s.sid, now=0.0)
        agg.pump(force=True)
        sts.append(agg.stats()["service"])
    st = sts[1]
    assert SVC_STATS_KEYS == ("schema", "sessions", "batches", "queue",
                              "caches", "resilience", "wire", "epoch",
                              "metrics")
    assert SVC_STATS_DEPRECATED == ()
    assert set(st) == set(SVC_STATS_KEYS) and st["schema"] == \
        SVC_STATS_VERSION == 2
    for k in ("sessions", "batches", "queue", "resilience", "wire", "epoch"):
        assert st[k] == sts[0][k], k
    assert st["caches"]["executor"] == sts[0]["caches"]["executor"]


def test_static_byzantine_config_reaches_sessions():
    n, elems = 8, 12
    cfg = AggConfig(n_nodes=n, cluster_size=4, redundancy=3, clip=2.0,
                    byzantine=ByzantineSpec(corrupt_ranks=(1, 5),
                                            mode="garbage"))
    vals = (RNG.normal(size=(n, elems)) * 0.3).astype(np.float32)
    ja, pa = _facades(cfg, batching=BatchingConfig(max_batch=1))
    got = []
    for agg in (ja, pa):
        s = agg.open_session(elems)
        assert tuple(s.fault.byzantine_slots) == (1, 5)
        for slot in range(n):
            s.contribute(slot, vals[slot])
        agg.seal(s.sid, now=0.0)
        agg.pump(force=True)
        got.append(np.asarray(agg.result(s.sid)))
    assert np.array_equal(got[0], got[1])
    want = pa.allreduce(torch.from_numpy(vals))[0].numpy()
    assert np.array_equal(got[1], want[:elems])


def test_manual_backend_rejects_sessions():
    agg = PA.SecureAggregator(PA.AggConfig(n_nodes=8), device="cpu",
                              runtime=PA.Runtime(backend="manual"))
    with pytest.raises(PA.ConfigError, match="manual"):
        agg.open_session(4)
    with pytest.raises(PA.ConfigError, match="open_session"):
        PA.SecureAggregator(PA.AggConfig(n_nodes=8), device="cpu").pump()


def test_service_digest_transport_sim_executor():
    """The digest transport through the batched service (pairwise
    masking, a missing slot, an equivocating and a mismatching node),
    the port equal to the reference; transports never share a batch."""
    n, elems, S = 8, 50, 4
    vals = (RNG.normal(size=(S, n, elems)) * 0.3).astype(np.float32)
    params = _params(elems=elems, masking="pairwise", transport="digest",
                     clip=2.0)
    pp = port_params(params)
    assert pp.batch_key(64) != dataclasses.replace(
        pp, transport="full").batch_key(64)
    js, ps = services(params, batching=BatchingConfig(max_batch=S,
                                                      max_age=1e9))
    fault = {2: SessionFaultPlan(byzantine_slots=(5,),
                                 byzantine_mode="equivocate"),
             3: SessionFaultPlan(byzantine_slots=(0,),
                                 byzantine_mode="mismatch")}
    got = []
    for svc in (js, ps):
        ss = feed(svc, vals, skip={(1, 2)}, fault=fault)
        assert svc.pump(force=True) == S
        got.append(results(ss))
    assert np.array_equal(got[0], got[1])
    want = vals.sum(1)
    want[1] -= vals[1, 2]
    assert np.abs(got[1] - want).max() < 1e-3
    assert fault_for(ps, fault[2]).byzantine_mode == "equivocate"


def test_service_imports_leave_jax_and_repro_out():
    code = ("import sys\n"
            "from repro_torch.service import (AggregationService, "
            "BatchingConfig, StreamConfig, SessionParams, EpochManager)\n"
            "import repro_torch.runtime.resilience, "
            "repro_torch.runtime.fault, repro_torch.runtime.chaos, "
            "repro_torch.obs, repro_torch.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_service_runs_on_the_card_unless_asked(monkeypatch):
    """``device=None`` means the card and raises without one."""
    from repro_torch.service import AggregationService as PSvc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSvc(port_params(_params()))
    assert PSvc(port_params(_params()), device="cpu").executor.device.type \
        == "cpu"
