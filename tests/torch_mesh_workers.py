"""Rank workers of the port's multi-process tests.

    python tests/torch_mesh_workers.py JOB_DIR RANKS
    python tests/torch_mesh_workers.py --die

``JOB_DIR`` holds ``job.json`` (a list of cases) and ``inputs.npz`` (their
arrays, made by the test with numpy).  ``RANKS`` ranks are spawned over a
gloo group on the CPU; each runs every case in order (the same order on
every rank: subgroups are built collectively), checks the distributed
result against the port's own sim oracle, and writes ``rank{r}.npz``
with its results under ``"{case}/{field}"``.  The test then holds them
against the JAX package.  A case whose mesh has fewer ranks than the
spawn runs on one of ``RANKS / size`` groups of its own: the ranks leave
the spawn's group, join their block's (rank r in block r // size, as its
rank r % size), share that mesh's cases out over the blocks, and come
back to the spawn's group after them; such a case's fields carry its
mesh rank as ``"{case}/r{i}/{field}"``.  ``--die`` runs two ranks of
which one dies.  This module imports torch and the port only.
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


def run_funcs(case, inputs, mesh) -> dict:
    """The secure-function verbs, ``cost(fn=...)``, function sessions
    through the service and a tuned one-shot, all on the ``mesh``
    backend, each against the same call on the sim backend."""
    from repro_torch import SecureAggregator
    from repro_torch.service import BatchingConfig
    cfg = config_from_fields(case["cfg"])
    rt = Runtime(backend="mesh", mesh=mesh, dp_axes=case["dp_axes"])
    vals = inputs[case["vals"]]
    dom = tuple(case["domain"])
    calls = {
        "hist": lambda a: a.histogram(vals, bins=13),
        "median": lambda a: a.median(vals, domain=dom),
        "q90": lambda a: a.quantile(vals, 0.9, domain=dom),
        "min": lambda a: a.minimum(vals, domain=dom),
        "max": lambda a: a.maximum(vals, domain=dom),
        "topk": lambda a: a.topk(vals, 3, domain=dom)}
    dist = SecureAggregator(cfg, runtime=rt, device="cpu")
    sim = SecureAggregator(cfg, runtime=Runtime(backend="sim"),
                           device="cpu")
    out = {}
    for name, call in calls.items():
        got, want = np.asarray(call(dist)), np.asarray(call(sim))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        out[name] = got
    assert dist.stats()["bytes_sent"] == sim.stats()["bytes_sent"]
    assert dist.stats()["fn_cache"] == sim.stats()["fn_cache"]
    assert dist.cost(fn="median", domain=dom) == sim.cost(fn="median",
                                                          domain=dom)
    out["bytes"] = np.int64(dist.stats()["bytes_sent"])

    polls = {}
    for name, rtm in (("mesh", rt), ("sim", Runtime(backend="sim"))):
        agg = SecureAggregator(cfg, runtime=rtm, device="cpu",
                               batching=BatchingConfig(max_batch=8,
                                                       max_age=1e9))
        fss = [agg.open_session(fn="median", domain=dom, now=0.0)
               for _ in range(3)]
        fss.append(agg.open_session(fn="histogram", bins=13, now=0.0))
        for i, fs in enumerate(fss):
            for slot in range(cfg.n_nodes):
                fs.contribute(slot, float(vals[(slot + i) % cfg.n_nodes]))
            fs.seal(now=0.0)
        agg.drain()
        assert all(fs.done for fs in fss), name
        polls[name] = ([fs.result for fs in fss[:3]], fss[3].result,
                       agg.stats()["service"]["batches"]["sizes"])
    assert polls["mesh"][0] == polls["sim"][0]
    assert np.array_equal(polls["mesh"][1], polls["sim"][1])
    assert polls["mesh"][2] == polls["sim"][2]
    out["poll_medians"] = np.asarray(polls["mesh"][0])
    out["poll_hist"] = polls["mesh"][1]
    out["poll_batches"] = np.asarray(polls["mesh"][2])

    xs = torch.from_numpy(inputs[case["xs"]])
    tuned = SecureAggregator(cfg, runtime=rt, device="cpu", tune="auto")
    tsim = SecureAggregator(cfg, runtime=Runtime(backend="sim"),
                            device="cpu", tune="auto")
    got = tuned.allreduce(xs)
    assert torch.equal(got, tsim.allreduce(xs))
    assert tuned.stats()["bytes_sent"] == tsim.stats()["bytes_sent"] \
        == tuned.cost(xs.shape[1])["bytes_total"]
    out["tuned"] = got.numpy()
    out["tuned_bytes"] = np.int64(tuned.stats()["bytes_sent"])
    return out


def run_moe(case, inputs, mesh) -> dict:
    """Expert parallelism over the mesh's one axis: this rank's tokens
    through ``moe_forward`` under an expert-axis context, on its own
    experts (rank r holds experts r E_loc .. (r + 1) E_loc - 1 of
    ``inputs[case["params"] + "/..."]``): ``moe_distributed`` for its
    own (B, S) tokens, ``moe_distributed_replicated`` for one token held
    by every rank, and the distributed path with the dispatch in
    float8.  Each beside ``moe_local`` over every expert on this rank."""
    import dataclasses

    from repro_torch.convert import model_config_from_fields
    from repro_torch.models import layers as L
    from repro_torch.runtime.context import DistCtx, use_ctx
    cfg = model_config_from_fields(case["cfg"])
    ax = mesh.axis_names[0]
    n, r = mesh.shape[ax], mesh.coord(ax)
    full: dict = {}
    for key, v in inputs.items():
        path = key.split("/")
        if path[0] == case["params"]:
            node = full
            for part in path[1:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = torch.from_numpy(v)
    E_loc = cfg.moe.n_experts // n
    # the expert stacks split on their leading axis; the router and the
    # shared expert replicated
    mine = {k: (v[r * E_loc:(r + 1) * E_loc]
                if isinstance(v, torch.Tensor) and v.dim() == 3 else v)
            for k, v in full.items()}
    ctx = DistCtx(mesh=mesh, dp_axes=(ax,), ep_axis=ax)
    x = torch.from_numpy(inputs[case["x"]][r])
    x1 = torch.from_numpy(inputs[case["x1"]])
    fp8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_dtype="float8_e4m3fn"))
    with use_ctx(ctx):
        dist = L.moe_forward(cfg, mine, x)
        rep = L.moe_forward(cfg, mine, x1)
        dist8 = L.moe_forward(fp8, mine, x)
    return {"dist": dist.numpy(), "rep": rep.numpy(),
            "dist_fp8": dist8.numpy(),
            "local": L.moe_local(cfg, full, x).numpy(),
            "local1": L.moe_local(cfg, full, x1).numpy()}


def run_train_moe(case, inputs, mesh) -> dict:
    """MoE training with the experts split over the mesh's ``"data"``
    axis: from the full parameter tree ``inputs[case["params"] + "/i"]``
    (its leaves in ``tree_flatten`` order), either ``case["steps"]`` steps
    of ``build_train_step`` / ``build_secure_train_step`` on this rank's
    rows of the synthetic stream's global batches, from this rank's
    expert slice (``sharding.shard_tree``), or ``train_loop`` from the full
    tree (which slices it itself).  Returns the losses, the grad norms
    (steps only), this rank's final parameter leaves and how many times
    each expert-parallel path ran."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import (model_config_from_fields,
                                     opt_config_from_fields)
    from repro_torch.core.engine import tree_flatten
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import default_agg, train_loop
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = model_config_from_fields(case["cfg"])
    opt = opt_config_from_fields(case["opt"])
    gb, S, n_steps = case["global_batch"], case["seq_len"], case["steps"]
    shape = ShapeConfig("t", S, gb, "train")
    leaves, rebuild = tree_flatten(
        M.init_params(cfg, torch.Generator().manual_seed(0)))
    # copies: the steps update the parameters in place
    full = rebuild([torch.from_numpy(inputs[f"{case['params']}/{i}"].copy())
                    for i in range(len(leaves))])
    calls = {"moe_distributed": 0, "moe_distributed_replicated": 0}
    originals = {name: getattr(L, name) for name in calls}

    def counted(name):
        def wrap(*a, **kw):
            calls[name] += 1
            return originals[name](*a, **kw)
        return wrap

    for name in calls:
        setattr(L, name, counted(name))
    try:
        out = {}
        if case["loop"]:
            run = train_loop(cfg, mesh, steps=n_steps, shape=shape,
                             secure=case["secure"], opt_cfg=opt,
                             log_every=1000, device="cpu", params=full)
            params, losses = run["params"], run["losses"]
        else:
            n, r = mesh.shape["data"], mesh.coord("data")
            rows = gb // n
            params = SH.shard_tree(cfg, full, mesh)
            state = adamw.init_opt_state(opt, params)
            if case["secure"]:
                step, _ = ST.build_secure_train_step(
                    cfg, mesh, default_agg(n), opt_cfg=opt, shape=shape)
            else:
                step, _ = ST.build_train_step(cfg, opt, shape, mesh)
            stream = SyntheticStream(DataConfig(seq_len=S, global_batch=gb,
                                                seed=0), cfg)
            losses, norms = [], []
            for t in range(n_steps):
                batch = {k: torch.from_numpy(
                    v[r * rows:(r + 1) * rows].copy())
                    for k, v in stream.global_batch(t).items()}
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            out["grad_norms"] = np.array(norms)
    finally:
        for name, fn in originals.items():
            setattr(L, name, fn)
    out["losses"] = np.array(losses)
    out.update({f"p{i}": t.detach().numpy()
                for i, t in enumerate(tree_flatten(params)[0])})
    out.update({f"calls_{k}": np.int64(v) for k, v in calls.items()})
    return out


def to_reference(params):
    """The port's parameter tree as numpy in the reference's layout: the
    list of unit dicts stacked into one dict of (n_units, ...) leaves."""
    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.numpy()

    def stack(units):
        if isinstance(units[0], dict):
            return {k: stack([u[k] for u in units]) for k in units[0]}
        return np.stack(units)

    out = {k: np_tree(v) for k, v in params.items() if k != "units"}
    out["units"] = stack([np_tree(u) for u in params["units"]])
    return out


def _full_params(case, inputs):
    """The full parameter tree ``inputs[case["params"] + "/i"]`` (its
    leaves in ``tree_flatten`` order), as copies."""
    from repro_torch.core.engine import tree_flatten
    from repro_torch.models import model as M
    leaves, rebuild = tree_flatten(
        M.init_params(_cfg(case), torch.device("meta")))
    return rebuild([torch.from_numpy(inputs[f"{case['params']}/{i}"].copy())
                    for i in range(len(leaves))])


def _cfg(case):
    from repro_torch.convert import model_config_from_fields
    return model_config_from_fields(case["cfg"])


class _Taps:
    """Records, while active, the router's expert ids and every unit's
    output (the residual stream), as sha256 digests of their bytes, so
    that the ranks of a model slice can be held equal bit for bit."""

    def __init__(self):
        import hashlib
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        self.router = hashlib.sha256()
        self.resid = hashlib.sha256()
        self.saved = [(L, "_router", L._router)]
        self.saved += [(M, n, getattr(M, n)) for n in
                       ("_unit_forward", "_unit_prefill", "_unit_decode")]

        def router(*a, **kw):
            idx, w = self.saved[0][2](*a, **kw)
            self.router.update(idx.numpy().tobytes())
            return idx, w

        def unit(fn):
            def wrap(*a, **kw):
                out = fn(*a, **kw)
                x = out[0] if isinstance(out, tuple) else out
                self.resid.update(x.detach().float().numpy().tobytes())
                return out
            return wrap

        L._router = router
        for mod, name, fn in self.saved[1:]:
            setattr(mod, name, unit(fn))

    def close(self) -> dict:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return {"router_sha": np.array(self.router.hexdigest()),
                "resid_sha": np.array(self.resid.hexdigest())}


def run_tp_serve(case, inputs, mesh) -> dict:
    """The tensor-parallel serve on this rank's slice of the full tree:
    the prefill step on the prompts ``inputs[case["prompts"] + "/..."]``
    (an encoder: its forward), then ``case["steps"]`` decode steps fed
    the tokens ``inputs[case["forced"]]`` (B, steps), each step's whole
    logits kept; with ``case["serve"]`` also ``serve`` (greedy tokens).
    Also the digests of the router's ids and of the residual stream, the
    prefill's and the decode steps' collective calls by kind
    (``prefill_calls_<kind>``, ``decode_calls_<kind>``) and the shapes
    of the rank's cache leaves (``cache_shapes``, JSON: a unit's
    ``layer/leaf`` -> shape).
    ``case["fsdp"]`` (``"data"``) cuts the FSDP leaves of the slice too."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.runtime import context as C
    cfg = _cfg(case)
    B, PL, steps = case["batch"], case["prompt_len"], case["steps"]
    full = _full_params(case, inputs)
    params = SH.shard_tree(cfg, full, mesh, fsdp=case.get("fsdp"))
    rows = SV._rows(B, mesh)
    prompts = {k[len(case["prompts"]) + 1:]: torch.from_numpy(v[rows].copy())
               for k, v in inputs.items()
               if k.startswith(case["prompts"] + "/")}
    out = {}
    taps = _Taps()
    try:
        # the cache's length rounded up to split over the cut, as serve's
        max_seq = ST.cache_len(PL + steps, B, mesh)
        pre, _ = ST.build_prefill_step(
            cfg, mesh, ShapeConfig("p", PL, B, "prefill"), max_seq=max_seq)
        if not cfg.decoder:
            out["logits"] = pre(params, prompts).numpy()
            return {**out, **taps.close()}
        C.reset_collective_counts()
        logits, cache = pre(params, prompts)
        out.update({f"prefill_calls_{k}": np.int64(v["calls"])
                    for k, v in C.collective_counts().items()})
        dec, _ = ST.build_decode_step(
            cfg, mesh, ShapeConfig("d", max_seq, B, "decode"))
        out["cache_shapes"] = np.array(json.dumps(
            [{f"{name}/{k}": list(t.shape) for name, layer in u.items()
              for k, t in layer.items()} for u in cache]))
        got = [logits]
        forced = torch.from_numpy(inputs[case["forced"]][rows].copy())
        C.reset_collective_counts()
        for i in range(steps):
            logits, cache = dec(params, cache, forced[:, i:i + 1], PL + i)
            got.append(logits)
        out.update({f"decode_calls_{k}": np.int64(v["calls"])
                    for k, v in C.collective_counts().items()})
        # a bfloat16 model's logits widened (exactly) for numpy
        out["logits"] = torch.cat(got, dim=1).float().numpy()
    finally:
        out.update(taps.close())
    if case["serve"]:
        res = SV.serve(cfg, mesh, batch=B, prompt_len=PL, gen=steps + 1,
                       params=params, device="cpu")
        out["tokens"] = res["tokens"]
    return out


def run_tp_train(case, inputs, mesh) -> dict:
    """``train_loop`` on the (data, model) mesh from the full tree (each
    rank cuts its slice), ``case["steps"]`` steps of the synthetic
    stream, secure or baseline: the losses and this rank's final slice.
    With ``case["restart"]``: the same run crashed at its last step after
    a checkpoint a step (``ckpt_dir/tp<j>``, or ``ep<i>/tp<j>``), then
    resumed; ``restart_equal`` says whether its final slice equals the
    uninterrupted run's bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import opt_config_from_fields
    from repro_torch.core.engine import tree_flatten
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.fault import FailurePlan, InjectedCrash
    cfg = _cfg(case)
    opt = opt_config_from_fields(case["opt"])
    steps = case["steps"]
    kw = dict(steps=steps, secure=case["secure"], opt_cfg=opt,
              shape=ShapeConfig("t", case["seq_len"], case["global_batch"],
                                "train"),
              log_every=1000, device="cpu")
    run = train_loop(cfg, mesh, params=_full_params(case, inputs), **kw)
    leaves = tree_flatten(run["params"])[0]
    out = {"losses": np.array(run["losses"])}
    out.update({f"p{i}": t.detach().numpy() for i, t in enumerate(leaves)})
    if case["restart"]:
        ck = case["ckpt_dir"]
        try:
            train_loop(cfg, mesh, params=_full_params(case, inputs),
                       ckpt_dir=ck, ckpt_every=1,
                       failure_plan=FailurePlan(crash_at_steps=(steps - 1,)),
                       **kw)
        except InjectedCrash:
            pass
        # a restart is a new job: every slice's checkpoint is written
        dist.barrier()
        again = train_loop(cfg, mesh, params=_full_params(case, inputs),
                           ckpt_dir=ck, ckpt_every=1, **kw)
        out["resumed_from"] = np.int64(again["resumed_from"])
        out["restart_equal"] = np.array(all(
            torch.equal(a, b) for a, b in
            zip(leaves, tree_flatten(again["params"])[0])))
    return out


def run_tp_grads(case, inputs, mesh) -> dict:
    """One baseline step's loss and synced gradients (no update) on this
    rank's slice and rows of the global batch ``inputs[case["batch"] +
    "/..."]``, under the step's context; with the collective calls by
    kind of that loss and backward (``calls_<kind>``)."""
    from repro_torch.core.engine import flat_node_id, tree_flatten
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import dp_axes_of
    from repro_torch.runtime import context as C
    cfg = _cfg(case)
    params = SH.shard_tree(cfg, _full_params(case, inputs), mesh)
    full = {k[len(case["batch"]) + 1:]: v for k, v in inputs.items()
            if k.startswith(case["batch"] + "/")}
    gb, S = full["tokens"].shape
    rows = gb // SH.dp_extent(mesh)
    i = flat_node_id(mesh, dp_axes_of(mesh))
    batch = {k: torch.from_numpy(v[i * rows:(i + 1) * rows].copy())
             for k, v in full.items()}
    C.reset_collective_counts()
    with C.use_ctx(ST.dist_ctx(cfg, mesh, sharded_batch=True)):
        loss, grads = ST.local_grads(cfg, params, batch, gb * S)
    out = {f"calls_{k}": np.int64(v["calls"])
           for k, v in C.collective_counts().items()}
    ST.sync_grads_(cfg, loss, grads, mesh)
    out["loss"] = loss.numpy()
    out.update({f"g{j}": t.numpy()
                for j, t in enumerate(tree_flatten(grads)[0])})
    return out


RUN = {"execute": run_execute, "tree": run_tree, "reorder": run_reorder,
       "host_mesh": run_host_mesh, "cluster_sum": run_cluster_sum,
       "facade": run_facade, "wrong_world": run_wrong_world,
       "stale_wire": run_stale_wire, "service": run_service,
       "funcs": run_funcs, "moe": run_moe, "train_moe": run_train_moe,
       "tp_serve": run_tp_serve, "tp_train": run_tp_train,
       "tp_grads": run_tp_grads}


def _regroup(job_dir: str, tag: str, rank: int, world: int) -> None:
    """Leave the current default group and join a new one of ``world``
    ranks as ``rank`` (a ``FileStore`` no earlier group used)."""
    import torch.distributed as dist

    from repro_torch.runtime.compat import init_node_group
    dist.destroy_process_group()
    init_node_group(rank, world, os.path.join(job_dir, f"store-{tag}"))


def worker(rank: int, job_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.runtime.compat import make_mesh
    with open(os.path.join(job_dir, "job.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(job_dir, "inputs.npz")) as z:
        inputs = dict(z)
    world = dist.get_world_size()
    meshes: dict = {}
    out = {}
    # runs of consecutive cases on one mesh
    runs: list = []
    for case in cases:
        key = (tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        if runs and runs[-1][0] == key:
            runs[-1][1].append(case)
        else:
            runs.append((key, [case]))
    for n_run, (key, run) in enumerate(runs):
        size = int(np.prod(key[0]))
        if size == world:
            if key not in meshes:
                meshes[key] = make_mesh(*key)
            for case in run:
                for field, v in RUN[case["kind"]](case, inputs,
                                                  meshes[key]).items():
                    out[f"{case['name']}/{field}"] = v
            continue
        # a smaller mesh: this rank's block runs every blocks-th case
        blocks, block = world // size, rank // size
        _regroup(job_dir, f"{n_run}-{block}", rank % size, size)
        meshes.clear()
        mesh = make_mesh(*key)
        for case in run[block::blocks]:
            for field, v in RUN[case["kind"]](case, inputs, mesh).items():
                out[f"{case['name']}/r{mesh.rank}/{field}"] = v
        _regroup(job_dir, f"{n_run}-all", rank, world)
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
