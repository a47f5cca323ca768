"""The port's aggregation launchers on the CPU at small sizes:
``repro_torch.launch.serve_agg`` (additive and function loads, tuning,
chaos, the trace and metrics exports) and
``repro_torch.launch.secure_polling`` (the polling deployment, its own
asserts), each against the JAX package's run of the same load where the
reference has one."""
import numpy as np
import pytest

from repro import api as J
from repro.core.overlay import build_overlay as j_build_overlay
from repro.launch import serve_agg as JL
from repro.service import BatchingConfig as JBatchingConfig
from repro.service import EpochManager as JEpochManager
from repro_torch.launch import secure_polling, serve_agg
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.trace import read_jsonl

SMALL = ["--overlay-n", "64", "--device", "cpu", "--max-age", "1e9"]


def _reference_func_load(fn, sessions, batch, **kw):
    """The reference's ``run_func_load`` on the launcher's deployment."""
    em = JEpochManager(j_build_overlay(64, 0.2, seed=42), cluster_size=4)
    snap = em.current()
    agg = J.SecureAggregator(
        topology=J.Topology(n_nodes=snap.n_nodes, cluster_size=4),
        security=J.Security(redundancy=3), epochs=em,
        batching=JBatchingConfig(max_batch=batch, max_age=1e9))
    return JL.run_func_load(agg, em, sessions=sessions, fn=fn,
                            churn_every=0, **kw)


@pytest.mark.parametrize("fn", ["histogram", "median", "topk"])
def test_serve_agg_function_load_equals_reference(fn, capsys):
    out = serve_agg.main(SMALL + ["--fn", fn, "--sessions", "12",
                                  "--batch", "4", "--steps", "64",
                                  "--bins", "8", "--topk", "3"],
                         metrics=MetricsRegistry())
    assert out["revealed"] == out["exact"] == 12
    want = _reference_func_load(fn, 12, 4, bins=8, steps=64, k=3)
    assert out["stats"]["batches"]["sizes"] \
        == want["stats"]["batches"]["sizes"]
    assert out["stats"]["wire"] == want["stats"]["wire"]
    assert (want["revealed"], want["exact"]) == (12, 12)
    assert "exact results: 12/12" in capsys.readouterr().out


def test_serve_agg_tuned_chaos_and_exports(tmp_path, capsys):
    trace, prom = tmp_path / "trace.jsonl", tmp_path / "metrics.prom"
    out = serve_agg.main(SMALL + [
        "--sessions", "8", "--batch", "4", "--elems", "100", "--tune",
        "auto", "--chaos", "dispatch", "--chaos-times", "1",
        "--retry-backoff", "0", "--trace-out", str(trace),
        "--metrics-out", str(prom)], metrics=MetricsRegistry())
    assert out["revealed"] == out["exact"] == 8
    res = out["stats"]["resilience"]
    assert res["chaos_injected"] == 1 and res["retries"] == 1
    d = out["decision"]
    assert d is not None and out["stats"]["wire"]["bytes_sent"] \
        == 2 * d.predicted_bytes
    events = read_jsonl(str(trace))
    assert sum(e["kind"] == "batch" for e in events) >= 2
    text = prom.read_text()
    assert "repro_tuner_decisions 1" in text
    assert "repro_executor_batches_run 2" in text
    assert "tuner: " in capsys.readouterr().out


def test_secure_polling_runs_its_checks():
    out = secure_polling.main(["--n", "64", "--polls", "3", "--steps",
                               "64", "--bins", "5", "--device", "cpu"])
    n = out["n_slots"]
    # six bisection rounds of three concurrent polls: one batch a round
    assert out["batch_sizes"] == (3,) * 6
    assert out["histogram"].sum() == n
    assert out["da"] is not None and out["da"]["output"] \
        == out["da"]["expected"]
    # the same histogram as the reference's verb on the same ratings
    em = JEpochManager(j_build_overlay(64, 0.2, seed=42), cluster_size=4)
    ratings = np.random.default_rng(7).random(n)
    ref = J.SecureAggregator(topology=J.Topology(n_nodes=n, cluster_size=4),
                             security=J.Security(redundancy=3), epochs=em)
    assert np.array_equal(out["histogram"],
                          ref.histogram(ratings, bins=5, range=(0.0, 1.0)))
