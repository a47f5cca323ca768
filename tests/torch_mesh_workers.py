"""Rank workers of the port's multi-process tests.

    python tests/torch_mesh_workers.py JOB_DIR RANKS
    python tests/torch_mesh_workers.py --die

``JOB_DIR`` holds ``job.json`` (a list of cases) and ``inputs.npz`` (their
arrays, made by the test with numpy).  ``RANKS`` ranks are spawned over a
gloo group on the CPU; each runs every case in order (the same order on
every rank: subgroups are built collectively), checks the distributed
result against the port's own sim oracle, and writes ``rank{r}.npz``
with its results under ``"{case}/{field}"``.  The test then holds them
against the JAX package.  ``--die`` runs two ranks of which one dies.
This module imports torch and the port only.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.convert import (config_from_fields,  # noqa: E402
                                 session_meta_from_numpy, words_from_numpy,
                                 words_to_numpy)
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.plan import Runtime, compile_plan  # noqa: E402


class PassThrough:
    """A ``MeshTransport.wrap_inner`` wrapper that changes nothing and
    counts the hops it forwards."""

    def __init__(self, inner):
        self.inner = inner
        self.hops = 0

    def hop(self, *a, **kw):
        self.hops += 1
        return self.inner.hop(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Reorder:
    """A ``wrap_inner`` wrapper that holds every hop back and, when a vote
    needs one, posts the held hops newest first: under the chunk pipeline
    chunk k+1's wires go out before chunk k's.  Each vote must wait on
    the wires of the hop it is handed, whatever order they were posted
    in.  ``inversions`` counts the hops posted ahead of an older one."""

    def __init__(self, inner):
        self.inner = inner
        self.held = []
        self.inversions = 0

    def hop(self, *a):
        slot = {"args": a}
        self.held.append(slot)
        return slot

    def vote(self, rnd, slot, base):
        if "inflight" not in slot:
            for held in reversed(self.held):
                held["inflight"] = self.inner.hop(*held["args"])
            self.inversions += len(self.held) - 1
            self.held = []
        return self.inner.vote(rnd, slot["inflight"], base)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _meta(case, inputs):
    """Seeds ``inputs[case["seeds"]]``, zero offsets, and the fault masks
    stored as ``"{case['masks']}:{mode}"``."""
    seeds = inputs[case["seeds"]]
    prefix = case["masks"] + ":"
    masks = {k[len(prefix):]: v for k, v in inputs.items()
             if k.startswith(prefix)}
    return session_meta_from_numpy(seeds, np.zeros_like(seeds), masks,
                                   "cpu")


def run_execute(case, inputs, mesh) -> dict:
    """``MeshTransport.execute`` (and its reveal) against the port's sim."""
    cfg = config_from_fields(case["cfg"])
    plan = compile_plan(cfg)
    xs = torch.from_numpy(inputs[case["xs"]])
    meta = _meta(case, inputs)
    wrapped = []

    def wrap(tp):
        wrapped.append(PassThrough(tp))
        return wrapped[-1]

    mt = E.MeshTransport(mesh, case["dp_axes"],
                         wrap_inner=wrap if case.get("wrap") else None)
    got = mt.execute(plan, xs, meta)
    got_bytes = mt.last_bytes
    ro = mt.execute(plan, xs, meta, reveal_only=True)
    sim, tp = E.sim_batch(plan, xs, meta)
    sim_ro, _ = E.sim_batch(plan, xs, meta, reveal_only=True)
    assert torch.equal(got, sim), case["name"]
    assert torch.equal(ro, sim_ro), case["name"]
    assert got_bytes == mt.last_bytes == tp.bytes_sent, case["name"]
    out = {"out": got.numpy(), "reveal": ro.numpy(),
           "bytes": np.int64(got_bytes)}
    if wrapped:
        assert wrapped[0].hops == len(plan.rounds), wrapped[0].hops
        out["hops"] = np.int64(wrapped[0].hops + wrapped[1].hops)
    return out


def _local_tree(case, inputs, nid):
    return {k: torch.from_numpy(inputs[v][nid].copy())
            for k, v in case["tree"].items()}


def run_tree(case, inputs, mesh) -> dict:
    """``tree_allreduce`` / ``manual_allreduce`` of this rank's values and
    the facade's ``manual`` backend, against the sim of all nodes."""
    from repro_torch import SecureAggregator
    cfg = config_from_fields(case["cfg"])
    nid = E.flat_node_id(mesh, case["dp_axes"])
    local = _local_tree(case, inputs, nid)
    got = E.tree_allreduce(local, cfg, mesh, case["dp_axes"])
    rt = Runtime(backend="manual", mesh=mesh, dp_axes=case["dp_axes"])
    agg = SecureAggregator(cfg, runtime=rt, device="cpu")
    again = agg.allreduce(local)
    one = E.manual_allreduce(local[case["single"]], cfg, mesh,
                             case["dp_axes"])
    sim = SecureAggregator(cfg, runtime=Runtime(backend="sim"),
                           device="cpu")
    want = sim.allreduce({k: torch.from_numpy(inputs[v])
                          for k, v in case["tree"].items()})
    for k in got:
        assert torch.equal(got[k], want[k][nid]), (case["name"], k)
        assert torch.equal(again[k], got[k]), (case["name"], k)
    assert torch.equal(one, got[case["single"]]), case["name"]
    st = agg.stats()
    assert st["backend"] == "manual" and st["bytes_sent"] > 0
    return {**{f"leaf.{k}": v.numpy() for k, v in got.items()},
            "bytes": np.int64(st["bytes_sent"])}


def run_reorder(case, inputs, mesh) -> dict:
    """``execute_chunks`` of this rank's packed tree through a
    :class:`Reorder`-wrapped ``ManualTransport``, against
    ``tree_allreduce`` of the same tree (held to the sim by ``run_tree``
    and to JAX by the test)."""
    cfg = config_from_fields(case["cfg"])
    plan = compile_plan(cfg)
    nid = E.flat_node_id(mesh, case["dp_axes"])
    local = _local_tree(case, inputs, nid)
    leaves, rebuild = E.tree_flatten(local)
    chunks = E.pack_chunks(leaves, cfg.chunk_elems)
    tp = Reorder(E.ManualTransport(plan, mesh, case["dp_axes"],
                                   device="cpu", chunks=len(chunks)))
    outs = E.execute_chunks(plan, tp, [ch[None] for ch in chunks],
                            E.SessionMeta.single(cfg.seed, device="cpu"))
    got = rebuild(E.unpack_chunks([o[0] for o in outs], leaves))
    want = E.tree_allreduce(local, cfg, mesh, case["dp_axes"])
    for k in got:
        assert torch.equal(got[k], want[k]), (case["name"], k)
    return {**{f"leaf.{k}": v.numpy() for k, v in got.items()},
            "inversions": np.int64(tp.inversions)}


def run_host_mesh(case, inputs, mesh) -> dict:
    """``host_mesh`` and ``axis_size`` over the 8 ranks: a ("data",
    "model") and a ("pod", "data", "model") mesh, this rank's coordinates
    on each and every axis's size."""
    from repro_torch.runtime.compat import axis_size, host_mesh
    two = host_mesh(data=4, model=2)
    three = host_mesh(data=2, model=2, pod=2)
    return {"two/axes": np.array(two.axis_names),
            "two/coords": np.array(two.coords()),
            "two/sizes": np.array([axis_size(two, a)
                                   for a in two.axis_names]),
            "three/axes": np.array(three.axis_names),
            "three/coords": np.array(three.coords()),
            "three/sizes": np.array([axis_size(three, a)
                                     for a in three.axis_names])}


def run_cluster_sum(case, inputs, mesh) -> dict:
    """The cluster sum on the transport's own cluster group, on words at
    the ends of the int32 range: it must wrap mod 2^32."""
    cfg = config_from_fields(case["cfg"])
    plan = compile_plan(cfg)
    tp = E.ManualTransport(plan, mesh, case["dp_axes"], device="cpu")
    q = words_from_numpy(inputs[case["words"]][tp.node_id][None])
    got = words_to_numpy(tp.cluster_sum(q))[0]
    words = inputs[case["words"]].astype(np.uint64)
    cl = tp.node_id // plan.cluster_size
    want = (words[list(plan.groups[cl])].sum(0) % 2 ** 32).astype(np.uint32)
    assert np.array_equal(got, want), case["name"]
    return {"sum": got}


def run_facade(case, inputs, mesh) -> dict:
    """``SecureAggregator`` on the ``mesh`` backend: allreduce and the
    batched one-shot, against the sim backend."""
    from repro_torch import SecureAggregator
    cfg = config_from_fields(case["cfg"])
    rt = Runtime(backend="mesh", mesh=mesh, dp_axes=case["dp_axes"])
    agg = SecureAggregator(cfg, runtime=rt, device="cpu")
    sim = SecureAggregator(cfg, runtime=Runtime(backend="sim"),
                           device="cpu")
    xs = torch.from_numpy(inputs[case["xs"]])
    got = agg.allreduce(xs[0])
    assert torch.equal(got, sim.allreduce(xs[0])), case["name"]
    batched = agg.allreduce_batched(xs)
    assert torch.equal(batched, sim.allreduce_batched(xs)), case["name"]
    st = agg.stats()
    assert st["backend"] == "mesh", st
    assert st["bytes_sent"] == sim.stats()["bytes_sent"], st
    try:
        SecureAggregator(cfg, runtime=Runtime(backend="manual"),
                         device="cpu").allreduce_batched(xs)
        raise AssertionError("manual allreduce_batched did not raise")
    except E.ConfigError:
        pass
    return {"out": got.numpy(), "batched": batched.numpy(),
            "bytes": np.int64(st["bytes_sent"])}


def run_wrong_world(case, inputs, mesh) -> dict:
    """A mesh whose shape is not the group's size is refused."""
    from repro_torch.runtime.compat import node_mesh
    try:
        node_mesh(mesh.size + 1)
    except E.ConfigError as e:
        assert "ranks" in str(e)
        return {"refused": np.int64(1)}
    raise AssertionError("a mesh of the wrong size was accepted")


class SendThenRaise:
    """A ``wrap_inner`` wrapper whose first voted hop posts this rank's
    sends of every copy stream -- of corrupted words -- and raises before
    any receive is posted: a failed attempt that leaves wires in flight
    that nobody will receive."""

    def __init__(self, inner):
        self.inner = inner

    def hop(self, rnd, rnd_idx, meta, acc):
        from repro_torch.runtime.chaos import ChaosError
        tp = self.inner
        bad = torch.bitwise_xor(acc, torch.tensor(0x5A5A5A5A,
                                                  dtype=torch.int32))
        tp._wires = []                 # post, never wait
        for send_to, _ in tp._pairs[rnd][0]:
            tp._exchange(bad, (send_to, None))
        tp._wires = None
        raise ChaosError("chaos: sends posted, receives never")

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _sha(a) -> str:
    import hashlib
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def run_stale_wire(case, inputs, mesh) -> dict:
    """An attempt that posts a hop's sends and fails before receiving,
    then the retry on the same mesh: the retry equals the sim by
    sha256 (its wire tags never meet the failed attempt's)."""
    from repro_torch.runtime.chaos import ChaosError
    cfg = config_from_fields(case["cfg"])
    plan = compile_plan(cfg)
    xs = torch.from_numpy(inputs[case["xs"]])
    meta = _meta(case, inputs)
    try:
        E.MeshTransport(mesh, case["dp_axes"], wrap_inner=SendThenRaise
                        ).execute(plan, xs, meta, reveal_only=True)
        raise AssertionError("the failing attempt did not raise")
    except ChaosError:
        pass
    retry = E.MeshTransport(mesh, case["dp_axes"]).execute(
        plan, xs, meta, reveal_only=True)
    sim, _ = E.sim_batch(plan, xs, meta, reveal_only=True)
    assert _sha(retry) == _sha(sim), case["name"]
    return {"reveal": retry.numpy()}


def _svc_knobs(case):
    """The service knobs of a case, from the reference's fields."""
    from repro_torch import convert as C
    from repro_torch.runtime.resilience import CircuitBreaker
    kw = {}
    for name, fn in (("batching", C.batching_from_fields),
                     ("stream", C.stream_from_fields),
                     ("retry", C.retry_from_fields),
                     ("chaos", C.chaos_from_fields)):
        if case.get(name) is not None:
            kw[name] = fn(case[name])
    return kw, (CircuitBreaker(**case["breaker"])
                if case.get("breaker") else None)


def run_service(case, inputs, mesh) -> dict:
    """The service on the ``mesh`` transport, every rank its own copy
    over the same calls, against the port's sim service over the same
    sessions: each block of sessions is fed, pumped and its revealed
    rows held to the sim's by sha256.  ``clock`` sets the breaker's
    logical time before each block."""
    from repro_torch import convert as C
    from repro_torch.service import AggregationService
    params = C.session_params_from_fields(case["params"])
    vals = inputs[case["vals"]]
    kw, breaker = _svc_knobs(case)
    clk = {"t": 0.0}
    if breaker is not None:
        breaker.clock = lambda: clk["t"]
    svc = AggregationService(params, transport="mesh", mesh=mesh,
                             dp_axes=case["dp_axes"], breaker=breaker,
                             device="cpu", **kw)
    sim = AggregationService(params, device="cpu",
                             batching=kw.get("batching"))
    out, states = [], []
    for b, (lo, hi) in enumerate(case["blocks"]):
        clk["t"] = (case["clock"] or [0.0] * len(case["blocks"]))[b]
        got = []
        for s_vals in (svc, sim):
            ss = []
            for i in range(lo, hi):
                s = s_vals.open(now=0.0)
                for slot in range(params.n_nodes):
                    s.contribute(slot, vals[i, slot])
                s_vals.seal(s.sid, now=0.0)
                ss.append(s)
            s_vals.pump(force=True)
            got.append(ss)
        for sm, ss in zip(*got):
            states.append(sm.state.value)
            if sm.state.value == "revealed":
                assert _sha(sm.result) == _sha(ss.result), (case["name"],
                                                            sm.sid)
                out.append(sm.result.numpy())
            else:
                out.append(np.full(params.elems, np.nan, np.float32))
    res = svc.stats["resilience"]
    return {"rows": np.stack(out), "states": np.array(states),
            "counts": np.array([res[k] for k in (
                "retries", "bisections", "quarantined", "deadline_hits",
                "degraded_batches", "chaos_injected")], np.int64),
            "breaker": np.array([] if res["breaker"] is None else [
                res["breaker"][k] for k in ("trips", "probes")], np.int64),
            "depth": np.float64(svc.metrics.snapshot()["gauges"].get(
                "executor.pipeline_depth", 0.0))}


RUN = {"execute": run_execute, "tree": run_tree, "reorder": run_reorder,
       "host_mesh": run_host_mesh, "cluster_sum": run_cluster_sum,
       "facade": run_facade, "wrong_world": run_wrong_world,
       "stale_wire": run_stale_wire, "service": run_service}


def worker(rank: int, job_dir: str) -> None:
    from repro_torch.runtime.compat import make_mesh
    with open(os.path.join(job_dir, "job.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(job_dir, "inputs.npz")) as z:
        inputs = dict(z)
    meshes: dict = {}
    out = {}
    for case in cases:
        key = (tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        if key not in meshes:
            meshes[key] = make_mesh(*key)
        for field, v in RUN[case["kind"]](case, inputs, meshes[key]).items():
            out[f"{case['name']}/{field}"] = v
    np.savez(os.path.join(job_dir, f"rank{rank}.npz"), **out)


def run_job(job_dir: str, cases: list, inputs: dict, ranks: int,
            timeout_s: float) -> list:
    """Write the job, run it in a fresh interpreter (the test process has
    imported JAX; the ranks must not), and load every rank's results."""
    import subprocess
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump(cases, f)
    np.savez(os.path.join(job_dir, "inputs.npz"), **inputs)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           job_dir, str(ranks)], capture_output=True,
                          text=True, timeout=timeout_s)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-6000:]
    outs = []
    for r in range(ranks):
        with np.load(os.path.join(job_dir, f"rank{r}.npz")) as z:
            outs.append(dict(z))
    return outs


def die_on_rank_one(rank: int) -> None:
    """Rank 1 dies while rank 0 waits for it in a barrier."""
    import torch.distributed as dist
    if rank == 1:
        os._exit(3)
    dist.barrier()


def main() -> None:
    from repro_torch.runtime.compat import spawn_nodes
    if sys.argv[1] == "--die":
        spawn_nodes(die_on_rank_one, 2, timeout_s=60)
        return
    job_dir, ranks = sys.argv[1], int(sys.argv[2])
    spawn_nodes(worker, ranks, job_dir)


if __name__ == "__main__":
    main()
