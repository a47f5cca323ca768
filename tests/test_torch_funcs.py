"""The port's secure-function layer (``repro_torch.funcs``, the facade's
function verbs, ``open_session(fn=...)``, ``cost(fn=...)``) against the
JAX package's ``repro.funcs`` on the same seeds and configs.

  * PLAN: ``compile_func_plan`` rounds, bytes and validation messages
    over a grid, field for field;
  * PAYLOADS: the builders and the domain / bin casts bit for bit, NaN
    and +-Inf values included;
  * PROTOCOL: ``FuncRun`` on the port's engine against ``FuncRun`` on
    the JAX engine (every round's payload, counts and the result), and
    the adversary grid of ``tests/adversary.py`` on the full and digest
    transports, each faulty session bit-identical to the honest one and
    to the reference;
  * FACADE: the verbs against the numpy oracle and the reference,
    ``cost(fn=...)`` equal to the executed bytes and to the reference's,
    the ``func_round`` TickClock JSONL equal to the reference's by
    sha256;
  * SERVICE: concurrent medians batched a round, histogram and top-k
    sessions, lifecycle errors and expiry, and the observed-churn
    retune, each against the reference's service.
"""
import dataclasses
import hashlib
import io

import numpy as np
import pytest
import torch

from adversary import ADVERSARIES, run_sim_batch, session_faults
from repro import api as J
from repro import funcs as JF
from repro.core.plan import compile_func_plan as j_compile_func_plan
from repro.funcs.run import quantile_rank
from repro.obs import TickClock as JTickClock
from repro.obs import TraceRecorder as JTraceRecorder
from repro.service import BatchingConfig as JBatchingConfig
from repro.service import EpochManager as JEpochManager
from repro_torch import api as P
from repro_torch import funcs as PF
from repro_torch.convert import (batching_from_fields, config_from_fields,
                                 func_plan_from_fields, overlay_fields,
                                 overlay_from_fields,
                                 value_domain_from_fields)
from repro_torch.core.byzantine import ByzantineSpec
from repro_torch.core.engine import sim_batch
from repro_torch.core.plan import (ConfigError, SessionMeta,
                                   compile_func_plan, compile_plan)
from repro_torch.obs import TickClock, TraceRecorder
from repro_torch.service import EpochManager

N, C, R = 16, 4, 3
JCFG = J.AggConfig(n_nodes=N, cluster_size=C, redundancy=R, clip=2.0)
CFG = config_from_fields(dataclasses.asdict(JCFG))


def _vals(seed: int, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed).random(n)


def _quantized(dom, vals) -> np.ndarray:
    return np.array([dom.value(int(i)) for i in dom.indices(vals)])


def _oracle_quantile(dom, vals, q: float) -> float:
    qs = np.sort(_quantized(dom, vals))
    return float(qs[quantile_rank(q, len(vals)) - 1])


def _pair(jcfg=JCFG, **kw):
    """(reference facade, port facade on the CPU) over one config."""
    jkw, pkw = dict(kw), dict(kw)
    if "batching" in kw:
        pkw["batching"] = batching_from_fields(
            dataclasses.asdict(kw["batching"]))
    return (J.SecureAggregator(jcfg, **jkw),
            P.SecureAggregator(config_from_fields(dataclasses.asdict(jcfg)),
                               device="cpu", **pkw))


def _same(a, b) -> bool:
    """Results of one function on both sides: counts, a float or a
    float array, equal bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# PLAN
# ---------------------------------------------------------------------------

PLAN_GRID = ([("histogram", dict(bins=b, lo=lo, hi=hi))
              for b in (1, 13, 1025) for lo, hi in ((0.0, 1.0), (-2.0, 5.5))]
             + [("quantile", dict(steps=s, q=q, lo=0.0, hi=hi))
                for s in (1, 2, 3, 1024, 65536) for q in (0.0, 0.5, 1.0)
                for hi in (0.0 if s == 1 else 1.0,)]
             + [("topk", dict(steps=s, k=k)) for s in (1, 100, 4096)
                for k in (1, N)])


@pytest.mark.parametrize("transport", ["full", "digest"])
def test_func_plans_equal_reference_over_grid(transport):
    jcfg = dataclasses.replace(JCFG, transport=transport)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    for fn, kw in PLAN_GRID:
        want = j_compile_func_plan(jcfg, fn, **kw)
        got = compile_func_plan(cfg, fn, **kw)
        wd, gd = dataclasses.asdict(want), dataclasses.asdict(got)
        wd.pop("cfg"), gd.pop("cfg")
        assert gd == wd, (fn, kw)
        assert got.n_allreduces == want.n_allreduces
        assert got.wire_bytes() == want.wire_bytes(), (fn, kw)
        assert got.wire_bytes(S=3) == want.wire_bytes(S=3)
        assert compile_func_plan(cfg, fn, **kw) is got       # memoised
        assert func_plan_from_fields(dataclasses.asdict(want)) is got
    assert isinstance(got, PF.FuncPlan)


@pytest.mark.parametrize("kw", [
    dict(fn="sum"), dict(fn="histogram", bins=0),
    dict(fn="histogram", bins=4, lo=1.0, hi=1.0),
    dict(fn="quantile", steps=0), dict(fn="quantile", steps=8, q=1.5),
    dict(fn="quantile", steps=4, lo=1.0, hi=0.0),
    dict(fn="topk", steps=8, k=0), dict(fn="topk", steps=8, k=N + 1),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_func_plan_validation_messages_equal_reference(kw):
    with pytest.raises(Exception) as want:
        j_compile_func_plan(JCFG, **kw)
    with pytest.raises(ConfigError) as got:
        compile_func_plan(CFG, **kw)
    assert str(got.value) == str(want.value)
    # clip < 1.0 cannot hold a count of n exactly: refused up front
    with pytest.raises(ConfigError, match="clip") as got:
        compile_func_plan(CFG.replace(clip=0.5), "histogram", bins=4)


# ---------------------------------------------------------------------------
# PAYLOADS
# ---------------------------------------------------------------------------

def test_payload_builders_and_domains_equal_reference():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.random(12) * 1.4 - 0.2,
                           [np.nan, np.inf, -np.inf, 1.0]])
    present = rng.random(vals.shape[0]) < 0.7
    for bins, lo, hi in ((1, 0.0, 1.0), (4, 0.0, 1.0), (127, -0.5, 2.0)):
        assert np.array_equal(PF.bin_edges(bins, lo, hi),
                              JF.bin_edges(bins, lo, hi))
        assert np.array_equal(PF.bin_index(vals, bins, lo, hi),
                              JF.bin_index(vals, bins, lo, hi))
        for pr in (None, present):
            got = PF.one_hot_payload(vals, bins, lo, hi, present=pr)
            want = JF.one_hot_payload(vals, bins, lo, hi, present=pr)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for lo, hi, steps in ((0.0, 1.0, 1), (0.0, 1.0, 256), (-3.0, 2.0, 77)):
        jd = JF.ValueDomain(lo, hi, steps)
        pd = value_domain_from_fields(dataclasses.asdict(jd))
        assert pd == PF.ValueDomain(lo, hi, steps)
        assert pd.bisect_rounds == jd.bisect_rounds
        idx = pd.indices(vals)
        assert np.array_equal(idx, jd.indices(vals))
        assert [pd.value(i) for i in range(steps)] \
            == [jd.value(i) for i in range(steps)]
        assert pd.index(0.37) == jd.index(0.37)
        for mid in (0, steps // 2, steps - 1):
            for pr in (None, present):
                assert np.array_equal(
                    PF.threshold_payload(idx, mid, present=pr),
                    JF.threshold_payload(idx, mid, present=pr))
                assert np.array_equal(
                    PF.thresholded_one_hot(idx, mid, steps, present=pr),
                    JF.thresholded_one_hot(idx, mid, steps, present=pr))
    from repro_torch.funcs.run import quantile_rank as p_rank
    assert [p_rank(q, n) for q in (0.0, 0.25, 0.5, 0.9, 1.0)
            for n in (0, 1, 10, 16)] \
        == [quantile_rank(q, n) for q in (0.0, 0.25, 0.5, 0.9, 1.0)
            for n in (0, 1, 10, 16)]
    with pytest.raises(ConfigError, match="steps"):
        PF.ValueDomain(0.0, 1.0, 0)


# ---------------------------------------------------------------------------
# PROTOCOL: FuncRun on each engine
# ---------------------------------------------------------------------------

def _port_sim(cfg, xs, faults=None):
    S, n = xs.shape[:2]
    meta = SessionMeta.build(S, n, device="cpu", seed=cfg.seed,
                             faults=faults)
    out, tp = sim_batch(compile_plan(cfg), torch.from_numpy(xs), meta)
    return out, tp.bytes_sent


FUNC_RUNS = [("histogram", dict(bins=13)), ("histogram", dict(bins=1)),
             *[("quantile", dict(steps=64, q=q)) for q in (0.0, 0.5, 0.9,
                                                          1.0)],
             ("quantile", dict(steps=1, lo=0.25, hi=0.25, q=0.5)),
             ("topk", dict(steps=64, k=3)), ("topk", dict(steps=1, k=2))]


@pytest.mark.parametrize("fn,kw", FUNC_RUNS,
                         ids=[f"{f}-{'-'.join(map(str, k.values()))}"
                              for f, k in FUNC_RUNS])
def test_func_run_equals_reference_engine(fn, kw):
    vals = _vals(5)
    vals[3] = vals[7] = vals[11]            # ties across clusters
    present = np.ones(N, bool)
    present[[2, 9, 13]] = False
    for pr in (None, present):
        jr = JF.FuncRun(j_compile_func_plan(JCFG, fn, **kw), vals, present=pr)
        pr_run = PF.FuncRun(compile_func_plan(CFG, fn, **kw),
                            torch.from_numpy(vals), present=pr)
        assert pr_run.done == jr.done and pr_run.n_rounds == jr.n_rounds
        while not jr.done:
            jp, pp = jr.next_payload(), pr_run.next_payload()
            assert pp.dtype == jp.dtype and np.array_equal(pp, jp)
            want, _ = run_sim_batch(JCFG, jp[None])
            got, _ = _port_sim(CFG, pp[None])
            assert np.array_equal(got.numpy(), want)
            jr.feed(want[0, 0])
            pr_run.feed(got[0, 0])            # a tensor, read once
            assert pr_run.round == jr.round
        assert pr_run.done and _same(pr_run.result, jr.result), (fn, kw)


def test_func_run_degenerate_corners_and_misuse():
    qp = compile_func_plan(CFG, "quantile", q=0.5, steps=16)
    r = PF.FuncRun(qp, np.zeros(N), present=np.zeros(N, bool))
    while not r.done:
        r.feed(torch.zeros(r.next_payload().shape[1]))
    assert r.result == 1.0
    tp = compile_func_plan(CFG, "topk", k=2, steps=16)
    r = PF.FuncRun(tp, np.zeros(N), present=np.zeros(N, bool))
    while not r.done:
        r.feed(np.zeros(r.next_payload().shape[1]))
    assert r.result.size == 0
    r = PF.FuncRun(compile_func_plan(CFG, "histogram", bins=4), np.zeros(N))
    jr = JF.FuncRun(j_compile_func_plan(JCFG, "histogram", bins=4),
                    np.zeros(N))
    for run in (r, jr):
        with pytest.raises(Exception, match="feed"):
            run.feed(np.zeros(4))
        run.next_payload()
        with pytest.raises(Exception, match="previous round"):
            run.next_payload()
        with pytest.raises(Exception, match="reveals 4 counts, got 3"):
            run.feed(np.zeros(3))
    with pytest.raises(ConfigError, match="one value per node"):
        PF.FuncRun(qp, np.zeros(N + 1))


def _port_faults(faults):
    return [[ByzantineSpec(corrupt_ranks=tuple(sp.corrupt_ranks),
                           mode=sp.mode) for sp in specs]
            for specs in faults]


@pytest.mark.parametrize("transport", ["full", "digest"])
def test_functions_survive_adversary_grid_bit_identical(transport):
    """Every round of every function runs once a strategy of
    ``tests/adversary.py`` (one batch, a session a strategy); each
    faulty session's counts equal the honest session's bit for bit, and
    the whole batch equals the reference's."""
    jcfg = dataclasses.replace(JCFG, transport=transport)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    S = len(ADVERSARIES)
    faults = session_faults(N, C, R)
    vals = _vals(11)
    dom = PF.ValueDomain(0.0, 1.0, 32)
    for fn, kw in (("histogram", dict(bins=13)),
                   ("quantile", dict(q=0.5, steps=32)),
                   ("topk", dict(k=3, steps=32))):
        r = PF.FuncRun(compile_func_plan(cfg, fn, **kw), vals)
        while not r.done:
            payload = r.next_payload()
            xs = np.broadcast_to(payload, (S,) + payload.shape).copy()
            got, sent = _port_sim(cfg, xs, _port_faults(faults))
            want, want_sent = run_sim_batch(jcfg, xs, faults=faults)
            assert np.array_equal(got.numpy(), want) and sent == want_sent
            honest = got[0, 0]
            for s, adv in enumerate(ADVERSARIES[1:], start=1):
                assert torch.equal(got[s, 0], honest), (fn, r.round,
                                                         adv.name)
            r.feed(honest)
        if fn == "histogram":
            assert np.array_equal(
                r.result, np.histogram(vals, bins=13, range=(0.0, 1.0))[0])
        elif fn == "quantile":
            assert r.result == _oracle_quantile(dom, vals, 0.5)
        else:
            assert np.array_equal(
                r.result, np.sort(_quantized(dom, vals))[::-1][:3])


# ---------------------------------------------------------------------------
# FACADE
# ---------------------------------------------------------------------------

def test_facade_verbs_match_oracle_and_reference():
    ja, pa = _pair()
    vals = _vals(13)
    dom = PF.ValueDomain(0.0, 1.0, 128)
    calls = [("histogram", (vals,), dict(bins=11)),
             ("histogram", (vals,), dict(bins=7, range=(0.2, 0.8))),
             ("quantile", (vals, 0.25), dict(domain=(0.0, 1.0, 128))),
             ("quantile", (vals, 0.9), dict(domain=(0.0, 1.0, 128))),
             ("median", (vals,), dict(domain=(0.0, 1.0, 128))),
             ("minimum", (vals,), dict(domain=(0.0, 1.0, 128))),
             ("maximum", (vals,), dict(domain=(0.0, 1.0, 128))),
             ("topk", (vals, 4), dict(domain=(0.0, 1.0, 128)))]
    for verb, args, kw in calls:
        want = getattr(ja, verb)(*args, **kw)
        got = getattr(pa, verb)(*args, **kw)
        assert _same(got, want), verb
    # the facade's callables and bytes moved as the reference's did
    assert pa.stats()["fn_cache"] == ja.stats()["fn_cache"]
    assert pa.stats()["bytes_sent"] == ja.stats()["bytes_sent"]
    assert np.array_equal(pa.histogram(torch.from_numpy(vals), bins=11),
                          np.histogram(vals, bins=11, range=(0.0, 1.0))[0])
    assert pa.quantile(vals, 0.25, domain=dom) \
        == _oracle_quantile(dom, vals, 0.25)
    assert pa.median(vals, domain=dom) == _oracle_quantile(dom, vals, 0.5)
    assert pa.minimum(vals, domain=dom) == _quantized(dom, vals).min()
    assert pa.maximum(vals, domain=dom) == _quantized(dom, vals).max()
    assert np.array_equal(pa.topk(vals, 4, domain=dom),
                          np.sort(_quantized(dom, vals))[::-1][:4])


def test_facade_verb_errors_equal_reference():
    ja, pa = _pair()
    bad = [dict(fn="histogram"), dict(fn="median"),
           dict(fn="topk", domain=(0.0, 1.0, 8)),
           dict(fn="mode", domain=(0.0, 1.0, 8)),
           dict(fn="median", domain=(0.0, 1.0, 8), elems=4)]
    for kw in bad:
        with pytest.raises(Exception) as want:
            ja.cost(**kw)
        with pytest.raises(ConfigError) as got:
            pa.cost(**kw)
        assert str(got.value) == str(want.value), kw
    for agg in (ja, pa):
        with pytest.raises(Exception, match="elems"):
            agg.open_session()
        with pytest.raises(Exception, match="don't pass elems"):
            agg.open_session(4, fn="median", domain=(0.0, 1.0, 8))
    manual = P.SecureAggregator(CFG, runtime=P.Runtime(backend="manual"),
                                device="cpu")
    with pytest.raises(ConfigError, match="manual"):
        manual.median(np.zeros(N), domain=(0.0, 1.0, 8))


def test_cost_fn_equals_executed_and_reference():
    dom = (0.0, 1.0, 256)
    ja, pa = _pair()
    for kw in (dict(fn="median", domain=dom),
               dict(fn="histogram", bins=64),
               dict(fn="topk", k=2, domain=(0.0, 1.0, 64)),
               dict(fn="quantile", q=0.9, domain=(0.0, 2.0, 4096))):
        assert pa.cost(**kw) == ja.cost(**kw), kw
    c = pa.cost(fn="median", domain=dom)
    assert c["allreduces"] == 8 and c["round_elems"] == (1,) * 8
    vals = _vals(17)
    fplan = compile_func_plan(CFG, "quantile", q=0.5, steps=256)
    r, executed = PF.FuncRun(fplan, vals), 0
    while not r.done:
        out, sent = _port_sim(CFG, r.next_payload()[None])
        executed += sent
        r.feed(out[0, 0])
    assert executed == c["bytes_total"] == fplan.wire_bytes()
    b0 = pa.stats()["bytes_sent"]
    assert pa.median(vals, domain=dom) == r.result
    assert pa.stats()["bytes_sent"] - b0 == c["bytes_total"]
    ct = pa.cost(fn="topk", k=2, domain=(0.0, 1.0, 64))
    b0 = pa.stats()["bytes_sent"]
    pa.topk(vals, 2, domain=(0.0, 1.0, 64))
    assert pa.stats()["bytes_sent"] - b0 == ct["bytes_total"]
    # the committed funcs_*_bytes rows of BENCH_secure_agg.json
    import json
    import pathlib
    rows = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "BENCH_secure_agg.json").read_text())
    agg = P.SecureAggregator(P.AggConfig(n_nodes=16, cluster_size=4,
                                         redundancy=3, clip=2.0),
                             device="cpu")
    assert agg.cost(fn="histogram", bins=64)["bytes_total"] \
        == rows["funcs_histogram_bins64_bytes"] \
        == agg.cost(64)["bytes_total"] == rows["funcs_sum_T64_bytes"]
    for steps in (256, 1024, 4096):
        assert agg.cost(fn="median", domain=(0.0, 1.0, steps))[
            "bytes_total"] == rows[f"funcs_median_steps{steps}_bytes"]


def _sha(buf: io.StringIO) -> str:
    return hashlib.sha256(buf.getvalue().encode()).hexdigest()


def test_func_round_trace_equals_reference_by_sha256():
    """The one-shot verbs under a TickClock: ``func_round`` spans
    summing to ``cost(fn=...)``, between the rounds' ``batch`` and
    ``round`` events, and the whole JSONL equal to the reference's."""
    bufs = (io.StringIO(), io.StringIO())
    jrec = JTraceRecorder(clock=JTickClock(), sink=bufs[0])
    prec = TraceRecorder(clock=TickClock(), sink=bufs[1])
    ja = J.SecureAggregator(JCFG, recorder=jrec)
    pa = P.SecureAggregator(CFG, device="cpu", recorder=prec)
    vals = _vals(19)
    for agg in (ja, pa):
        agg.median(vals, domain=(0.0, 1.0, 16))
        agg.histogram(vals, bins=5)
        agg.topk(vals, 2, domain=(0.0, 1.0, 8))
        agg.recorder.close()
    spans = prec.events("func_round")
    assert [e["round"] for e in spans[:4]] == [0, 1, 2, 3]
    assert all(e["fn"] == "quantile" and e["rounds"] == 4
               and e["elems"] == 1 and e["backend"] == "sim"
               for e in spans[:4])
    assert sum(e["bytes"] for e in spans[:4]) \
        == pa.cost(fn="median", domain=(0.0, 1.0, 16))["bytes_total"]
    assert len(prec.events("batch")) == len(spans) == 4 + 1 + 4
    assert bufs[1].getvalue() == bufs[0].getvalue()
    assert _sha(bufs[1]) == _sha(bufs[0])


# ---------------------------------------------------------------------------
# SERVICE
# ---------------------------------------------------------------------------

def _open_polls(agg, specs, now=0.0):
    out = []
    for kw, vals, slots in specs:
        fs = agg.open_session(now=now, **kw)
        for slot in slots:
            fs.contribute(slot, float(vals[slot]))
        fs.seal(now=now)
        out.append(fs)
    return out


def test_service_concurrent_medians_batch_each_round_together():
    """Five concurrent medians cost one batched dispatch a bisection
    round, unpadded, and equal the reference's sessions and trace."""
    bufs = (io.StringIO(), io.StringIO())
    jb = JBatchingConfig(max_batch=8, max_age=1e9)
    ja = J.SecureAggregator(JCFG, batching=jb, recorder=JTraceRecorder(
        clock=JTickClock(), sink=bufs[0]))
    pa = P.SecureAggregator(CFG, device="cpu",
                            batching=batching_from_fields(
                                dataclasses.asdict(jb)),
                            recorder=TraceRecorder(clock=TickClock(),
                                                   sink=bufs[1]))
    dom = PF.ValueDomain(0.0, 1.0, 64)       # 6 bisection rounds
    specs = [(dict(fn="median", domain=(0.0, 1.0, 64)), _vals(30 + i),
              range(N)) for i in range(5)]
    jpolls, ppolls = _open_polls(ja, specs), _open_polls(pa, specs)
    assert pa.drain() == ja.drain() > 0
    for jf, pf, (_, vals, _) in zip(jpolls, ppolls, specs):
        assert pf.done and pf.rounds_run == 6 == jf.rounds_run
        assert pf.result == jf.result == _oracle_quantile(dom, vals, 0.5)
    st = pa.stats()["service"]
    assert st["batches"]["sizes"] == (5,) * 6
    assert st["batches"]["sizes"] == ja.stats()["service"]["batches"]["sizes"]
    assert pa._tuned_rows[1] == 1 == ja._tuned_rows[1]
    pa.recorder.close(), ja.recorder.close()
    assert _sha(bufs[1]) == _sha(bufs[0])


def test_service_histogram_and_topk_sessions():
    jb = JBatchingConfig(max_batch=8, max_age=1e9)
    ja, pa = _pair(batching=jb)
    vals = _vals(41)
    half = np.zeros(N)
    specs = [(dict(fn="histogram", bins=10), vals, range(N)),
             (dict(fn="topk", k=3, domain=(0.0, 1.0, 32)), vals, range(N)),
             (dict(fn="median", domain=(0.0, 1.0, 32)), vals,
              range(0, N, 2)),
             (dict(fn="quantile", q=0.9, domain=(0.0, 1.0, 32)), half,
              range(N))]
    jf, pf = _open_polls(ja, specs), _open_polls(pa, specs)
    ja.drain(), pa.drain()
    for a, b in zip(jf, pf):
        assert b.done and _same(b.result, a.result)
    dom = PF.ValueDomain(0.0, 1.0, 32)
    assert np.array_equal(pf[0].result, np.histogram(
        vals, bins=10, range=(0.0, 1.0))[0])
    assert np.array_equal(pf[1].result,
                          np.sort(_quantized(dom, vals))[::-1][:3])
    qs = np.sort(_quantized(dom, vals[::2]))
    assert pf[2].result == qs[quantile_rank(0.5, N // 2) - 1]
    from repro_torch.service.executor import func_padded
    assert pa._tuned_rows == ja._tuned_rows
    assert pa._tuned_rows[10] == func_padded(10)
    assert pa._tuned_rows[32] == func_padded(32)
    assert pa.stats()["service"]["batches"]["sizes"] \
        == ja.stats()["service"]["batches"]["sizes"]


def test_service_func_session_lifecycle_errors_and_expiry():
    jb = JBatchingConfig(max_batch=64, max_age=1e9)
    ja, pa = _pair(batching=jb)
    out = []
    for agg in (ja, pa):
        fs = agg.open_session(fn="median", domain=(0.0, 1.0, 16), now=0.0,
                              ttl=5.0)
        with pytest.raises(Exception, match="out of range"):
            fs.contribute(N, 0.5)
        fs.contribute(0, 0.5)
        with pytest.raises(Exception, match="done"):
            _ = fs.result
        fs.seal(now=0.0)
        with pytest.raises(Exception, match="not open"):
            fs.contribute(1, 0.5)
        # the deadline passes while the first round is still queued
        agg.pump(now=10.0)
        assert fs.state == "failed" and "expired" in fs.failed_reason
        with pytest.raises(Exception, match="failed"):
            _ = fs.result
        assert agg._func_sessions == {}
        out.append(fs)
    assert isinstance(out[1], PF.FuncSession)
    assert out[1].failed_reason == out[0].failed_reason


def _leave(em, k: int) -> None:
    snap = em.current()
    for uid in list(dict.fromkeys(snap.slot_uids))[:k]:
        em.overlay.leave(uid)
    em.advance()


def test_observed_churn_retunes_like_reference():
    """The tuner reads the port's measured churn
    (``EpochManager.observed_churn_rate``) into the signature, and the
    facade resolves afresh when it moves, as the reference does."""
    from repro.core.overlay import build_overlay
    from repro.tune import clear_tuner_cache as j_clear
    from repro_torch.tune import clear_tuner_cache
    j_clear(), clear_tuner_cache()
    jov = build_overlay(64, 0.2, seed=5)
    jem = JEpochManager(jov, cluster_size=4)
    pem = EpochManager(overlay_from_fields(overlay_fields(jov)),
                       cluster_size=4)
    snap = pem.current()
    assert jem.current().n_nodes == snap.n_nodes
    aggs = []
    for mod, em in ((J, jem), (P, pem)):
        kw = {} if mod is J else {"device": "cpu"}
        aggs.append(mod.SecureAggregator(
            topology=mod.Topology(n_nodes=snap.n_nodes, cluster_size=4),
            security=mod.Security(redundancy=3), epochs=em, tune="auto",
            **kw))
    ja, pa = aggs
    from repro_torch.convert import decision_fields
    d1 = pa._tune_decision(8)
    assert decision_fields(d1) == decision_fields(ja._tune_decision(8))
    assert pa._tune_decision(8) is d1
    for em in (jem, pem):
        _leave(em, 2)
    assert pem.observed_churn_rate() == jem.observed_churn_rate() > 0.0
    d2 = pa._tune_decision(8)
    assert decision_fields(d2) == decision_fields(ja._tune_decision(8))
    assert {s.churn_rate for s in pa._tune_decisions} \
        == {0.0, pem.observed_churn_rate()}
    assert pa.stats()["tuner"]["decisions"] \
        == ja.stats()["tuner"]["decisions"] == 2
