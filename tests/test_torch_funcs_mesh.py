"""The port's secure functions on the ``mesh`` backend, over gloo on the
CPU, against the JAX package's sim: the counterpart of
``tests/test_funcs.py::test_funcs_mesh_backend_bit_identical_to_sim_8dev``.

One spawn of 8 rank processes (``tests/torch_mesh_workers.py``, kind
``funcs``) runs, on the full and the digest transport: the six function
verbs, ``cost(fn=...)``, three median polls and a histogram through the
mesh service, and a tuned one-shot, every rank holding each to the
port's sim backend; this process holds every rank's results against the
reference's facade on the same values.
"""
import dataclasses

import numpy as np
import pytest

import torch_mesh_workers as W
from repro import api as J

RANKS = N = 8
DOMAIN = (0.0, 1.0, 64)
TRANSPORTS = ("full", "digest")


def _cfg(transport):
    return J.AggConfig(n_nodes=N, cluster_size=4, redundancy=3, clip=2.0,
                       transport=transport)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(11)
    inputs = {"vals": rng.random(N),
              "xs": (rng.normal(size=(N, 600)) * 0.3).astype(np.float32)}
    cases = [dict(kind="funcs", name=f"funcs-{t}", mesh=((N,), ("data",)),
                  dp_axes=("data",), cfg=dataclasses.asdict(_cfg(t)),
                  vals="vals", xs="xs", domain=DOMAIN) for t in TRANSPORTS]
    outs = W.run_job(str(tmp_path_factory.mktemp("funcs-mesh")), cases,
                     inputs, RANKS, timeout_s=300)
    return inputs, outs


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_funcs_mesh_backend_equals_reference(run, transport):
    inputs, outs = run
    vals = inputs["vals"]
    ref = J.SecureAggregator(_cfg(transport))
    want = {"hist": ref.histogram(vals, bins=13),
            "median": ref.median(vals, domain=DOMAIN),
            "q90": ref.quantile(vals, 0.9, domain=DOMAIN),
            "min": ref.minimum(vals, domain=DOMAIN),
            "max": ref.maximum(vals, domain=DOMAIN),
            "topk": ref.topk(vals, 3, domain=DOMAIN)}
    assert np.array_equal(want["hist"], np.histogram(
        vals, bins=13, range=(0.0, 1.0))[0])
    for rank, out in enumerate(outs):
        for name, w in want.items():
            got = out[f"funcs-{transport}/{name}"]
            assert np.array_equal(got, np.asarray(w)), (rank, name)
        assert int(out[f"funcs-{transport}/bytes"]) \
            == ref.stats()["bytes_sent"], rank


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_funcs_mesh_sessions_and_tuned_one_shot_equal_reference(
        run, transport):
    from repro.service import BatchingConfig
    inputs, outs = run
    vals = inputs["vals"]
    agg = J.SecureAggregator(_cfg(transport), batching=BatchingConfig(
        max_batch=8, max_age=1e9))
    fss = [agg.open_session(fn="median", domain=DOMAIN, now=0.0)
           for _ in range(3)]
    fss.append(agg.open_session(fn="histogram", bins=13, now=0.0))
    for i, fs in enumerate(fss):
        for slot in range(N):
            fs.contribute(slot, float(vals[(slot + i) % N]))
        fs.seal(now=0.0)
    agg.drain()
    sizes = agg.stats()["service"]["batches"]["sizes"]
    tuned = J.SecureAggregator(_cfg(transport), tune="auto")
    want = np.asarray(tuned.allreduce(inputs["xs"]))
    for rank, out in enumerate(outs):
        key = f"funcs-{transport}"
        assert out[f"{key}/poll_medians"].tolist() \
            == [fs.result for fs in fss[:3]], rank
        assert np.array_equal(out[f"{key}/poll_hist"], fss[3].result)
        assert tuple(out[f"{key}/poll_batches"]) == sizes, rank
        assert np.array_equal(out[f"{key}/tuned"], want), rank
        assert int(out[f"{key}/tuned_bytes"]) \
            == tuned.stats()["bytes_sent"], rank
