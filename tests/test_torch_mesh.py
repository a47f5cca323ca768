"""The port's distributed transports against the JAX package, over gloo
on the CPU.

One spawn of 8 rank processes (``tests/torch_mesh_workers.py``) runs
every case: each rank checks ``MeshTransport`` / ``ManualTransport``
against the port's own sim oracle and writes its results, which this
process holds bit for bit against ``repro.core.engine.sim_batch`` and
``repro.api.SecureAggregator`` on the same numpy inputs.  The cases are
the reference's ``_MESH_EQUIV`` (``tests/test_engine.py``: n = 8, c = 4,
S = 5, T = 257, a crashed and a Byzantine session, every masking), every
schedule x wire transport (tree rounds leave ranks that receive nothing:
ppermute's zero fill; the digest transport's backup shares its pairs
with digest stream 1: the wire tags), a many-chunk ``tree_allreduce``,
the cluster sum's wrap mod 2^32 on extreme words, two 2-D ("pod",
"data") meshes, ``host_mesh`` / ``axis_size``, the ``wrap_inner`` hook
(passing through, and posting hops out of order) and the facade's
``mesh`` / ``manual`` backends.
"""
import dataclasses

import numpy as np
import pytest

import torch_mesh_workers as W
from repro import api as J
from repro.core.byzantine import ByzantineSpec
from repro.core.engine import sim_batch
from repro.core.plan import (AggConfig, SessionMeta, compile_plan,
                             fault_masks_of)
from repro.core.schedules import schedule_cost

RANKS, N, C, S, T = 8, 8, 4, 5, 257
SCHEDULES = [(s, t) for s in ("ring", "tree", "butterfly")
             for t in ("full", "digest")]
MASKINGS = ("global", "pairwise", "none")
TREE_WIRES = ("full", "digest")


def _cfg(**kw) -> AggConfig:
    return AggConfig(n_nodes=N, cluster_size=C, redundancy=3, clip=2.0, **kw)


def _faults():
    faults = [() for _ in range(S)]
    faults[1] = (ByzantineSpec(corrupt_ranks=(2,), mode="drop"),)   # crash
    faults[3] = (ByzantineSpec(corrupt_ranks=(6,), mode="flip"),)   # byzantine
    return faults


def _execute_cases():
    cases = []
    for masking in MASKINGS:
        cases.append(dict(name=f"equiv-{masking}", cfg=_cfg(masking=masking),
                          mesh=((N,), ("data",)), dp_axes=("data",)))
    for schedule, transport in SCHEDULES:
        cases.append(dict(name=f"sched-{schedule}-{transport}",
                          cfg=_cfg(schedule=schedule, transport=transport),
                          mesh=((N,), ("data",)), dp_axes=("data",)))
    for dp in (("pod", "data"), ("data", "pod")):
        cases.append(dict(name=f"mesh2d-{'-'.join(dp)}",
                          cfg=_cfg(transport="digest"),
                          mesh=((2, 4), ("pod", "data")), dp_axes=dp))
    cases.append(dict(name="wrap", cfg=_cfg(masking="pairwise"),
                      mesh=((N,), ("data",)), dp_axes=("data",), wrap=True))
    return cases


EXECUTE = _execute_cases()


def _job():
    rng = np.random.default_rng(5)
    xs = (rng.normal(size=(S, N, T)) * 0.2).astype(np.float32)
    inputs = {"xs": xs, "seeds": np.arange(S, dtype=np.uint32) + 11}
    for mode, m in fault_masks_of(_faults(), N).items():
        inputs[f"masks:{mode}"] = m
    cases = [dict(kind="execute", xs="xs", seeds="seeds", masks="masks",
                  **{k: v for k, v in c.items() if k != "cfg"},
                  cfg=dataclasses.asdict(c["cfg"])) for c in EXECUTE]
    inputs["tree_w"] = (rng.normal(size=(N, 5, 40)) * 0.3).astype(np.float32)
    inputs["tree_b"] = (rng.normal(size=(N, 137)) * 0.3).astype(np.float32)
    for transport in TREE_WIRES:
        cases.append(dict(kind="tree", name=f"tree-{transport}",
                          cfg=dataclasses.asdict(_cfg(transport=transport,
                                                      chunk_elems=64)),
                          mesh=((N,), ("data",)), dp_axes=("data",),
                          tree={"w": "tree_w", "b": "tree_b"}, single="b"))
    cases.append(dict(kind="reorder", name="reorder",
                      cfg=dataclasses.asdict(_cfg(transport="digest",
                                                  chunk_elems=64)),
                      mesh=((N,), ("data",)), dp_axes=("data",),
                      tree={"w": "tree_w", "b": "tree_b"}))
    cases.append(dict(kind="host_mesh", name="host-mesh",
                      mesh=((N,), ("data",)), dp_axes=("data",)))
    words = rng.integers(0, 2 ** 32, size=(N, 6), dtype=np.uint32)
    words[:, :4] = [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 1]
    inputs["words"] = words
    cases.append(dict(kind="cluster_sum", name="wrap-sum", words="words",
                      cfg=dataclasses.asdict(_cfg()),
                      mesh=((N,), ("data",)), dp_axes=("data",)))
    inputs["facade_xs"] = (rng.normal(size=(3, N, 100)) * 0.3
                           ).astype(np.float32)
    cases.append(dict(kind="facade", name="facade", xs="facade_xs",
                      cfg=dataclasses.asdict(_cfg(masking="pairwise")),
                      mesh=((N,), ("data",)), dp_axes=("data",)))
    cases.append(dict(kind="wrong_world", name="wrong-world",
                      mesh=((N,), ("data",)), dp_axes=("data",)))
    return cases, inputs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases, inputs = _job()
    outs = W.run_job(str(tmp_path_factory.mktemp("mesh")), cases, inputs,
                     RANKS, timeout_s=300)
    return inputs, outs


def _jax_sim(cfg, inputs, reveal_only=False):
    meta = SessionMeta.build(S, N, seed=cfg.seed, seeds=inputs["seeds"],
                             faults=_faults())
    out, tp = sim_batch(compile_plan(cfg), inputs["xs"], meta,
                        reveal_only=reveal_only)
    return np.asarray(out), tp.bytes_sent


@pytest.mark.parametrize("case", EXECUTE, ids=[c["name"] for c in EXECUTE])
def test_mesh_execute_equals_reference_sim(run, case):
    """Every rank's ``MeshTransport.execute`` == the port's sim (checked
    in the rank) == ``repro.core.engine.sim_batch``, bit for bit, with
    and without ``reveal_only``; every rank's wire account == the sim's
    == ``cost(T)`` per session."""
    inputs, outs = run
    cfg = case["cfg"]
    want, want_bytes = _jax_sim(cfg, inputs)
    want_ro, _ = _jax_sim(cfg, inputs, reveal_only=True)
    cost = schedule_cost(cfg.schedule, cfg.n_clusters, C, 3, 4 * T,
                         digest=cfg.transport == "digest",
                         digest_bytes=4 * cfg.digest_words,
                         digest_backup=cfg.digest_backup)["bytes_total"]
    assert want_bytes == S * cost
    for rank, out in enumerate(outs):
        assert np.array_equal(out[f"{case['name']}/out"], want), rank
        assert np.array_equal(out[f"{case['name']}/reveal"], want_ro), rank
        assert int(out[f"{case['name']}/bytes"]) == want_bytes, rank
    # the faults were vote-absorbed: the revealed sums stay exact
    assert np.abs(want_ro - inputs["xs"].sum(1)).max() < 1e-3
    if case.get("wrap"):
        assert int(outs[0]["wrap/hops"]) == 2 * len(compile_plan(cfg).rounds)


@pytest.mark.parametrize("transport", TREE_WIRES)
def test_tree_allreduce_many_chunks_equals_reference(run, transport):
    """A dict of 337 elements a rank at ``chunk_elems`` = 64 (6 chunks
    through the hop pipeline), by ``tree_allreduce``, ``manual_allreduce``
    and the facade's ``manual`` backend, == the reference facade's sim
    allreduce of all nodes' trees."""
    inputs, outs = run
    cfg = _cfg(transport=transport, chunk_elems=64)
    want = J.SecureAggregator(cfg).allreduce({"w": inputs["tree_w"],
                                              "b": inputs["tree_b"]})
    # the facade's account: 6 chunks of 64 elements, one digest set each
    want_bytes = compile_plan(cfg).wire_bytes(6 * 64, chunks=6)
    if transport == "full":
        assert want_bytes == J.SecureAggregator(cfg).cost(6 * 64)[
            "bytes_total"]
    for rank, out in enumerate(outs):
        for k in ("w", "b"):
            got = out[f"tree-{transport}/leaf.{k}"]
            assert np.array_equal(got, np.asarray(want[k])[rank]), (rank, k)
        assert int(out[f"tree-{transport}/bytes"]) == want_bytes, rank


def test_wrap_inner_reordered_hops_equal_reference(run):
    """A wrapper that posts each held hop newest first (chunk k+1's wires
    before chunk k's, 6 chunks, digest transport with its backup): every
    vote waits on the wires of the hop it is handed, so the result is
    the reference facade's, bit for bit."""
    inputs, outs = run
    cfg = _cfg(transport="digest", chunk_elems=64)
    want = J.SecureAggregator(cfg).allreduce({"w": inputs["tree_w"],
                                              "b": inputs["tree_b"]})
    for rank, out in enumerate(outs):
        assert int(out["reorder/inversions"]) > 0, rank
        for k in ("w", "b"):
            assert np.array_equal(out[f"reorder/leaf.{k}"],
                                  np.asarray(want[k])[rank]), (rank, k)


def test_host_mesh_and_axis_size(run):
    """``host_mesh(data=4, model=2)`` and ``host_mesh(2, 2, pod=2)`` over
    8 ranks: the reference's axis names, each rank at its row-major
    coordinates, ``axis_size`` of every axis."""
    _, outs = run
    for name, axes, shape in (("two", ("data", "model"), (4, 2)),
                              ("three", ("pod", "data", "model"),
                               (2, 2, 2))):
        for rank, out in enumerate(outs):
            assert tuple(out[f"host-mesh/{name}/axes"]) == axes, rank
            assert tuple(out[f"host-mesh/{name}/sizes"]) == shape, rank
            assert tuple(out[f"host-mesh/{name}/coords"]) == np.unravel_index(
                rank, shape), rank


def test_cluster_sum_wraps_mod_2_32(run):
    """The cluster all-reduce on the transport's own group, over words at
    the ends of the int32 range (2^31 - 1, 2^31, 2^32 - 1, 1, random)."""
    inputs, outs = run
    words = inputs["words"].astype(np.uint64)
    for rank, out in enumerate(outs):
        cl = rank // C
        want = (words[cl * C:(cl + 1) * C].sum(0) % 2 ** 32).astype(np.uint32)
        assert np.array_equal(out["wrap-sum/sum"], want), rank
    # the extreme columns really overflow int32 in every cluster
    assert (words[:C, :3].sum(0) >= 2 ** 32).all()


def test_facade_mesh_backend_equals_reference(run):
    """``SecureAggregator(runtime=Runtime(backend='mesh', mesh=...))``:
    allreduce and allreduce_batched (S = 3 sessions on 8 ranks: the
    distributed reveal's zero padding) == the reference facade; the
    ``stats()`` bytes == the reference's account."""
    inputs, outs = run
    jagg = J.SecureAggregator(_cfg(masking="pairwise"))
    xs = inputs["facade_xs"]
    want = np.asarray(jagg.allreduce(xs[0]))
    want_b = np.asarray(jagg.allreduce_batched(xs))
    want_bytes = jagg.stats()["bytes_sent"]
    for rank, out in enumerate(outs):
        assert np.array_equal(out["facade/out"], want), rank
        assert np.array_equal(out["facade/batched"], want_b), rank
        assert int(out["facade/bytes"]) == want_bytes, rank
        assert int(out["wrong-world/refused"]) == 1, rank
