"""The port's session service on the ``mesh`` transport, over gloo on the
CPU, against the JAX package's service.

One spawn of 8 rank processes (``tests/torch_mesh_workers.py``) runs
every case; every rank runs its own copy of the service over the same
calls (each decision a clock or a failure drives is agreed over the
group) and holds its revealed rows to the port's sim service by sha256;
this process holds them against ``repro.service.AggregationService`` on
the same payloads.  The cases are the reference's mesh grid
(``tests/test_resilience.py``: n = 8, every chaos mode recovered, a
poison session quarantined through the hop fault, the breaker's degrade
ladder, a fault in an overlapped depth-2 batch), plus the stale-wire
case: an attempt that posts its sends and fails before receiving, then
the retry, which must equal the sim.
"""
import dataclasses

import numpy as np
import pytest

import torch_mesh_workers as W
from repro.core.plan import AggConfig
from repro.runtime.chaos import ChaosConfig
from repro.runtime.resilience import RetryPolicy
from repro.service import (AggregationService, BatchingConfig,
                           SessionParams, StreamConfig)

RANKS, N, ELEMS, S, BLOCKS = 8, 8, 48, 4, 4
PARAMS = SessionParams(n_nodes=N, elems=ELEMS, cluster_size=4, redundancy=3)
BATCH = BatchingConfig(max_batch=64, max_age=1e9)
RECOVER = {
    "dispatch": ChaosConfig(mode="dispatch", times=1),
    "compile": ChaosConfig(mode="compile", times=1),
    "hop": ChaosConfig(mode="hop", hop_k=0, times=1),
    "slow": ChaosConfig(mode="slow", slow_s=1.5, times=1),
}


def _asdict(x):
    """JSON-able fields (a retry policy's ``sleep`` stays behind)."""
    if x is None:
        return None
    return {k: v for k, v in dataclasses.asdict(x).items() if k != "sleep"}


def _svc_case(name, blocks, *, batching=BATCH, stream=None, retry=None,
              chaos=None, breaker=None, clock=None, vals="vals"):
    return dict(kind="service", name=name, mesh=((N,), ("data",)),
                dp_axes=("data",), params=dataclasses.asdict(PARAMS),
                vals=vals, blocks=blocks, batching=_asdict(batching),
                stream=_asdict(stream), retry=_asdict(retry),
                chaos=_asdict(chaos), breaker=breaker, clock=clock)


def _cases():
    block = [(b * S, (b + 1) * S) for b in range(BLOCKS)]
    cases = []
    for mode, chaos in RECOVER.items():
        retry = RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                            deadline_s=1.0 if mode == "slow" else None)
        cases.append(_svc_case(f"recover-{mode}", block[:1], retry=retry,
                               chaos=chaos))
    cases.append(_svc_case(
        "quarantine", block[:1],
        retry=RetryPolicy(max_attempts=2, base_backoff_s=0.0),
        chaos=ChaosConfig(mode="hop", hop_k=0, poison_sids=(2,))))
    cases.append(_svc_case(
        "breaker", block,
        retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0),
        chaos=ChaosConfig(mode="dispatch", only_backend="mesh", times=3),
        breaker=dict(k=2, cooloff_s=50.0), clock=[0.0, 0.0, 100.0, 200.0]))
    cases.append(_svc_case(
        "stream", [(0, 8)], vals="vals8",
        batching=BatchingConfig(max_batch=4, max_age=1e9),
        stream=StreamConfig(depth=2),
        retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0),
        chaos=ChaosConfig(mode="dispatch", times=1, poison_sids=(5,))))
    for transport in ("full", "digest"):
        cfg = AggConfig(n_nodes=N, cluster_size=4, redundancy=3, clip=2.0,
                        transport=transport)
        cases.append(dict(kind="stale_wire", name=f"stale-{transport}",
                          cfg=dataclasses.asdict(cfg), xs="stale_xs",
                          seeds="stale_seeds", masks="none",
                          mesh=((N,), ("data",)), dp_axes=("data",)))
    return cases


CASES = _cases()


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "vals": (rng.normal(size=(BLOCKS * S, N, ELEMS)) * 0.3
                 ).astype(np.float32),
        "vals8": (rng.normal(size=(8, N, ELEMS)) * 0.3).astype(np.float32),
        "stale_xs": (rng.normal(size=(3, N, 96)) * 0.3).astype(np.float32),
        "stale_seeds": np.arange(3, dtype=np.uint32) + 5}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job(str(tmp_path_factory.mktemp("svc-mesh")), CASES,
                     inputs, RANKS, timeout_s=300)
    return inputs, outs


def _reference(vals, blocks, batching=BATCH):
    """The JAX package's fault-free sim service over the same sessions,
    block by block (the same sids, so the same pad keys)."""
    svc = AggregationService(PARAMS, batching=batching)
    out = []
    for lo, hi in blocks:
        ss = []
        for i in range(lo, hi):
            s = svc.open(now=0.0)
            for slot in range(N):
                s.contribute(slot, vals[i, slot])
            svc.seal(s.sid, now=0.0)
            ss.append(s)
        svc.pump(force=True)
        out += [np.asarray(s.result) for s in ss]
    return np.stack(out)


def _check_rows(outs, name, want, failed=()):
    for rank, out in enumerate(outs):
        rows, states = out[f"{name}/rows"], out[f"{name}/states"]
        for i, st in enumerate(states):
            if i in failed:
                assert st == "failed", (rank, i)
            else:
                assert st == "revealed", (rank, i)
                assert np.array_equal(rows[i], want[i]), (rank, i)
        # every rank took the same ladder
        for field in ("counts", "breaker", "states"):
            assert np.array_equal(out[f"{name}/{field}"],
                                  outs[0][f"{name}/{field}"]), (rank, field)


@pytest.mark.parametrize("mode", list(RECOVER))
def test_mesh_service_recovers_every_chaos_mode(run, mode):
    inputs, outs = run
    want = _reference(inputs["vals"], [(0, S)])
    _check_rows(outs, f"recover-{mode}", want)
    retries, _, quarantined, deadline, _, injected = \
        outs[0][f"recover-{mode}/counts"]
    assert injected == 1 and retries >= 1 and quarantined == 0
    assert deadline == (1 if mode == "slow" else 0)


def test_mesh_service_quarantines_the_poison_session(run):
    inputs, outs = run
    want = _reference(inputs["vals"], [(0, S)])
    _check_rows(outs, "quarantine", want, failed=(2,))
    _, bisections, quarantined, _, _, _ = outs[0]["quarantine/counts"]
    assert bisections >= 1 and quarantined == 1


def test_mesh_service_breaker_degrades_to_sim_and_recloses(run):
    """K = 2 mesh failures trip the breaker, the batch and the next run
    degraded on the sim, a post-cooloff probe fails, the next closes it:
    every row equal to the reference's sim service."""
    inputs, outs = run
    blocks = [(b * S, (b + 1) * S) for b in range(BLOCKS)]
    _check_rows(outs, "breaker", _reference(inputs["vals"], blocks))
    degraded = outs[0]["breaker/counts"][4]
    trips, probes = outs[0]["breaker/breaker"]
    assert degraded == 3 and trips == 1 and probes == 2


def test_mesh_service_streaming_inflight_fault(run):
    inputs, outs = run
    want = _reference(inputs["vals8"], [(0, 8)],
                      BatchingConfig(max_batch=4, max_age=1e9))
    _check_rows(outs, "stream", want)
    retries, _, quarantined, _, _, injected = outs[0]["stream/counts"]
    assert injected == 1 and retries == 1 and quarantined == 0
    assert float(outs[0]["stream/depth"]) == 2.0


@pytest.mark.parametrize("transport", ["full", "digest"])
def test_retry_after_posted_sends_equals_reference(run, transport):
    """The stale-wire case: sends of corrupted words posted on every
    copy stream and never received, then the retry on the same mesh —
    every rank's reveal equals the reference's sim."""
    from repro.core.engine import sim_batch
    from repro.core.plan import SessionMeta, compile_plan
    inputs, outs = run
    cfg = AggConfig(n_nodes=N, cluster_size=4, redundancy=3, clip=2.0,
                    transport=transport)
    xs = inputs["stale_xs"]
    meta = SessionMeta.build(3, N, seeds=inputs["stale_seeds"])
    want, _ = sim_batch(compile_plan(cfg), xs, meta, reveal_only=True)
    for rank, out in enumerate(outs):
        assert np.array_equal(out[f"stale-{transport}/reveal"],
                              np.asarray(want)), rank
