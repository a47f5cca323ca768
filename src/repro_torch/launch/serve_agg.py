"""Aggregation-service driver: many concurrent secure-aggregation
sessions under synthetic load, batched by the admission scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve_agg --sessions 64 \
        --batch 16 --elems 1024 --overlay-n 256 --churn-every 16

Counterpart of ``repro/launch/serve_agg.py``, driving everything through
the ``repro_torch.SecureAggregator`` facade (one config, the
``open_session`` / ``seal`` / ``pump`` / ``result`` verbs).  It opens
``--sessions`` sessions against a cuckoo-overlay network, feeds every
slot's contribution, seals them as load arrives and lets the admission
queue's size / age watermarks decide when batches flush.
``--churn-every`` applies a join/leave burst (advancing the epoch) every
that many sessions.  Prints sessions/s and the batch-size histogram.

``--fn histogram|median|min|max|topk`` (with ``--bins`` / ``--steps`` /
``--topk``) switches the load to secure functions (``repro_torch.funcs``):
each session is a chain of count-payload allreduces driven across pump
cycles by the same scheduler, checked against the numpy oracle on the
quantized domain.  ``--tune auto|probe`` turns on the self-tuning
planner.

Resilience: ``--ttl``, ``--max-pending-rows``, ``--retry-attempts`` /
``--retry-backoff`` / ``--deadline`` and ``--chaos MODE`` (with
``--chaos-p`` / ``--chaos-seed`` / ``--chaos-times``).  Observability:
``--trace-out FILE`` streams the flight recorder's JSONL, ``--metrics-out
FILE`` writes the final Prometheus-style snapshot, ``--stats-interval N``
prints the metrics table every N sessions.

``--device`` is where batches run (default the card; ``cpu`` on request)
and ``--impl torch`` asks for the plain versions instead of the CUDA
kernels; there is no environment override.

``--transport mesh`` runs the service on a process group: one rank
process a protocol slot (``runtime.compat.spawn_nodes``, gloo), each
with its own copy of the service over ``compat.node_mesh(n)`` driven by
the same calls, on the card's device 0 for every rank (or the CPU with
``--device cpu``).  Rank 0 prints the summary and its report is
``main``'s; a rank that raises ends the others and makes ``main`` raise.
The loads pass no ``now``: the service's clock decides the watermarks,
the host's monotonic clock on the sim and the agreed one (rank 0's) on a
mesh, so every rank flushes the same batches.

    PYTHONPATH=src python -m repro_torch.launch.serve_agg \
        --transport mesh --overlay-n 64 --device cpu

``--data`` / ``--model`` shape the host mesh the ``mesh:`` line reports
(``launch.mesh.make_host_mesh``); the launcher runs it on one rank, so
both stay 1.
"""
from __future__ import annotations

import argparse
import collections
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api import (ConfigError, Runtime, SecureAggregator,
                             Security, Topology)
from repro_torch.core.overlay import build_overlay
from repro_torch.kernels.backend import launch_counts, resolve_device
from repro_torch.launch.mesh import make_host_mesh, single_rank_mesh
from repro_torch.obs import DEFAULT_REGISTRY, TraceRecorder, stats_table
from repro_torch.obs.export import prometheus_text
from repro_torch.runtime import compat
from repro_torch.runtime.chaos import CHAOS_MODES, ChaosConfig
from repro_torch.service import (BatchingConfig, EpochManager, RetryPolicy,
                                 StreamConfig)
from repro_torch.service.session import SessionState


def run_func_load(agg: SecureAggregator, em: EpochManager, *,
                  sessions: int, fn: str, bins: int, steps: int, k: int,
                  churn_every: int, seed: int = 0) -> dict:
    """Drive ``sessions`` secure-function sessions (histogram /
    bisection quantile / top-k) through the service, each a chain of
    additive sessions advanced by the same ``pump`` that flushes the
    queue.  Exactness is checked against the numpy oracle on the
    quantized domain; churn in flight can cost a multi-round function
    its exactness (each round pins to the epoch current at its open)."""
    from repro_torch.funcs import ValueDomain
    from repro_torch.funcs.run import quantile_rank

    rng = np.random.default_rng(seed)
    n = agg.cfg.n_nodes
    dom = ValueDomain(0.0, 1.0, steps)
    t0 = time.monotonic()
    handles: list[tuple] = []
    for i in range(sessions):
        if churn_every and i and i % churn_every == 0:
            em.churn(joins=4, leaves=4, honest_join_frac=1.0)
        if fn == "histogram":
            fs = agg.open_session(fn=fn, bins=bins)
        elif fn == "topk":
            fs = agg.open_session(fn=fn, k=k, domain=dom)
        else:
            fs = agg.open_session(fn=fn, domain=dom)
        vals = rng.random(n)
        for slot in range(n):
            fs.contribute(slot, float(vals[slot]))
        fs.seal()
        handles.append((fs, vals))
        agg.pump()
    agg.drain()
    wall = time.monotonic() - t0

    exact = done = 0
    for fs, vals in handles:
        if not fs.done:
            continue
        done += 1
        if fn == "histogram":
            want = np.histogram(np.clip(vals, 0.0, 1.0), bins=bins,
                                range=(0.0, 1.0))[0]
            exact += bool(np.array_equal(fs.result, want))
        elif fn == "topk":
            quant = np.array([dom.value(int(i))
                              for i in dom.indices(vals)])
            want = np.sort(quant)[::-1][:k]
            exact += bool(np.array_equal(np.asarray(fs.result), want))
        else:
            qq = {"median": 0.5, "min": 0.0, "max": 1.0}[fn]
            quant = np.sort([dom.value(int(i))
                             for i in dom.indices(vals)])
            want = quant[quantile_rank(qq, n) - 1]
            exact += bool(fs.result == want)
    return {"wall_s": wall, "sessions": sessions,
            "sessions_per_s": sessions / max(wall, 1e-9),
            "revealed": done, "exact": exact,
            "degraded": agg.stats().get("degraded", False),
            "stats": agg.stats()["service"]}


def run_load(agg: SecureAggregator, em: EpochManager, *, sessions: int,
             elems: int, churn_every: int, seed: int = 0,
             stats_interval: int = 0) -> dict:
    """Drive ``sessions`` additive sessions of ``elems`` {0, 1} values a
    slot; a revealed session is exact within 1e-3 of its plain sum."""
    rng = np.random.default_rng(seed)
    n = agg.cfg.n_nodes
    expected: dict[int, np.ndarray] = {}
    t0 = time.monotonic()
    for i in range(sessions):
        if churn_every and i and i % churn_every == 0:
            em.churn(joins=4, leaves=4, honest_join_frac=1.0)
        s = agg.open_session(elems)
        vals = rng.integers(0, 2, size=(n, elems)).astype(np.float32)
        for slot in range(n):
            s.contribute(slot, vals[slot])
        expected[s.sid] = vals.sum(0)
        agg.seal(s.sid)
        agg.pump()                       # watermark-driven flushes
        if stats_interval and (i + 1) % stats_interval == 0:
            print(stats_table(agg.metrics,
                              title=f"metrics @ {i + 1} sessions"))
    agg.drain()
    wall = time.monotonic() - t0
    svc = agg.service
    revealed = [sid for sid in expected
                if svc.get(sid).state is SessionState.REVEALED]
    exact = sum(
        bool(np.allclose(agg.result(sid).cpu().numpy(), expected[sid],
                         atol=1e-3))
        for sid in revealed)
    return {"wall_s": wall, "sessions": sessions,
            "sessions_per_s": sessions / max(wall, 1e-9),
            "revealed": len(revealed), "exact": exact,
            "degraded": agg.stats().get("degraded", False),
            "stats": agg.stats()["service"]}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-age", type=float, default=0.05)
    ap.add_argument("--elems", type=int, default=1024)
    ap.add_argument("--overlay-n", type=int, default=256)
    ap.add_argument("--tau", type=float, default=0.2)
    ap.add_argument("--cluster-size", type=int, default=4)
    ap.add_argument("--redundancy", type=int, default=3)
    ap.add_argument("--schedule", default="ring")
    ap.add_argument("--tune", choices=("auto", "probe"), default=None,
                    help="self-tuning planner (repro_torch.tune): resolve "
                         "schedule/transport/digest/chunk/pad per "
                         "workload signature with the exact wire-byte "
                         "oracle ('probe' adds one measured dispatch "
                         "per finalist); --schedule becomes a hint")
    ap.add_argument("--churn-every", type=int, default=0)
    ap.add_argument("--fn", default=None,
                    choices=("histogram", "median", "min", "max", "topk"),
                    help="drive secure-function sessions instead of "
                         "additive sums: a histogram / bisection "
                         "quantile / top-k over one scalar per slot")
    ap.add_argument("--bins", type=int, default=16,
                    help="--fn histogram: bucket count over [0, 1)")
    ap.add_argument("--steps", type=int, default=256,
                    help="--fn median/min/max/topk: value-domain grid "
                         "(bisection runs ceil(log2(steps)) rounds)")
    ap.add_argument("--topk", type=int, default=4, metavar="K",
                    help="--fn topk: how many largest values to reveal")
    ap.add_argument("--device", default=None,
                    help="torch device the batches run on; default the "
                         "card ('cuda'), 'cpu' on request")
    ap.add_argument("--impl", choices=("cuda", "torch"), default=None,
                    help="kernel engine: the CUDA kernels (default on the "
                         "card) or the plain torch versions")
    ap.add_argument("--transport", choices=("sim", "mesh"), default="sim",
                    help="executor backend: the sim oracle, or one gloo "
                         "rank process per protocol slot ('mesh')")
    ap.add_argument("--data", type=int, default=1,
                    help="host mesh data extent (1 until the sharded "
                         "serve)")
    ap.add_argument("--model", type=int, default=1,
                    help="host mesh model extent (1 until the sharded "
                         "serve)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight streaming batch slots (1 = "
                         "sequential dispatch; 2 = double-buffered "
                         "pack/device overlap)")
    # resilience: deadlines, shedding, retry, deterministic chaos
    ap.add_argument("--ttl", type=float, default=None,
                    help="session deadline in seconds (EXPIRED past it)")
    ap.add_argument("--max-pending-rows", type=int, default=None,
                    help="load-shedding high-watermark in batch rows")
    ap.add_argument("--retry-attempts", type=int, default=3)
    ap.add_argument("--retry-backoff", type=float, default=0.02)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-attempt wall deadline (retriable)")
    ap.add_argument("--chaos", choices=CHAOS_MODES, default=None,
                    help="inject deterministic runtime faults")
    ap.add_argument("--chaos-p", type=float, default=1.0)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-times", type=int, default=None,
                    help="cap total injections (default unbounded)")
    # observability: flight recorder + metrics export
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="stream the flight-recorder JSONL event log to "
                         "FILE")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the final Prometheus-style metrics "
                         "snapshot to FILE")
    ap.add_argument("--stats-interval", type=int, default=0, metavar="N",
                    help="print the human metrics table every N "
                         "sessions (0 = off)")
    return ap


def _deployment(args) -> tuple:
    """(epoch manager, its first snapshot): the overlay of ``--overlay-n``
    nodes drawn from seed 42, every rank the same."""
    em = EpochManager(build_overlay(args.overlay_n, args.tau, seed=42),
                      cluster_size=args.cluster_size)
    return em, em.current()


def _aggregator(args, em, snap, runtime: Runtime, *, metrics, recorder,
                device) -> SecureAggregator:
    return SecureAggregator(
        topology=Topology(n_nodes=snap.n_nodes,
                          cluster_size=args.cluster_size,
                          schedule=args.schedule),
        security=Security(redundancy=args.redundancy),
        runtime=runtime, epochs=em,
        batching=BatchingConfig(max_batch=args.batch, max_age=args.max_age,
                                max_pending_rows=args.max_pending_rows,
                                session_ttl=args.ttl),
        retry=RetryPolicy(max_attempts=args.retry_attempts,
                          base_backoff_s=args.retry_backoff,
                          deadline_s=args.deadline),
        chaos=None if args.chaos is None else ChaosConfig(
            mode=args.chaos, p=args.chaos_p, seed=args.chaos_seed,
            times=args.chaos_times),
        metrics=metrics, recorder=recorder,
        stream=StreamConfig(depth=args.pipeline_depth),
        device=device, tune=args.tune)


def _serve(args, agg: SecureAggregator, em, snap, lead: bool = True
           ) -> dict:
    """Run the load on ``agg``.  Only the ``lead`` process (the sim's, or
    the mesh's rank 0) prints the summary and writes the metrics file.
    The report's ``launches`` are this process's CUDA kernel launches
    during the load."""
    def say(line: str) -> None:
        if lead:
            print(line)

    before = launch_counts()
    say(f"service: g={snap.n_clusters} clusters x c={args.cluster_size} "
        f"-> {snap.n_nodes} slots, T={args.elems}, r={args.redundancy}, "
        f"transport={args.transport}, device={agg.device}")

    if args.fn is not None:
        cost_kw = (dict(bins=args.bins) if args.fn == "histogram" else
                   dict(domain=(0.0, 1.0, args.steps),
                        **({"k": args.topk} if args.fn == "topk" else {})))
        c = agg.cost(fn=args.fn, **cost_kw)
        say(f"func: {args.fn} -> {c['allreduces']} allreduce(s)/session "
            f"(round elems {c['round_elems']}), "
            f"{c['bytes_total']} wire bytes/session")
        out = run_func_load(agg, em, sessions=args.sessions, fn=args.fn,
                            bins=args.bins, steps=args.steps, k=args.topk,
                            churn_every=args.churn_every)
    else:
        out = run_load(agg, em, sessions=args.sessions, elems=args.elems,
                       churn_every=args.churn_every,
                       stats_interval=args.stats_interval if lead else 0)
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    out["slots"] = snap.n_nodes
    hist = collections.Counter(out["stats"]["batches"]["sizes"])
    say(f"{out['sessions']} sessions in {out['wall_s']:.2f}s "
        f"({out['sessions_per_s']:.1f} sessions/s), "
        f"revealed {out['revealed']}/{out['sessions']}, "
        f"exact results: {out['exact']}/{out['revealed']}")
    say(f"batches: {out['stats']['batches']['run']} "
        f"(size histogram {dict(sorted(hist.items()))}), "
        f"final epoch: {out['stats']['epoch']}")
    res, qm = out["stats"]["resilience"], out["stats"]["queue"]
    say(f"resilience: retries={res['retries']} "
        f"bisections={res['bisections']} "
        f"quarantined={res['quarantined']} "
        f"chaos_injected={res['chaos_injected']} "
        f"degraded_batches={res['degraded_batches']} "
        f"shed={qm['shed_sessions']} expired={qm['expired_sessions']} "
        f"degraded={out['degraded']}")
    say(f"wire: {out['stats']['wire']['bytes_sent']} modeled bytes "
        f"over {out['stats']['batches']['run']} batches")
    out["decision"] = None
    if args.tune is not None:
        ts = agg.stats()["tuner"]
        d = agg._tune_decision(args.elems, args.batch)
        c = d.config
        out["decision"] = d
        say(f"tuner: {c.schedule}/{c.transport} words={c.digest_words} "
            f"backup={c.digest_backup} pad={d.padded_elems} "
            f"predicted={d.predicted_bytes}B/batch "
            f"(-{100 * d.saving_vs_default:.1f}% vs ring/full default; "
            f"{ts['decisions']} decisions, {ts['cache_hits']} cache "
            f"hits, {ts['probes']} probes)")
    if agg.recorder is not None:
        agg.recorder.close()
        say(f"trace: {agg.recorder.events_recorded} events -> "
            f"{args.trace_out}")
    if args.metrics_out is not None and lead:
        with open(args.metrics_out, "w") as f:
            f.write(prometheus_text(agg.metrics))
        say(f"metrics: snapshot -> {args.metrics_out}")
    return out


def _mesh_rank(rank: int, args: argparse.Namespace, device: str,
               out_dir: str) -> None:
    """One rank of ``--transport mesh``: its own copy of the service over
    the group's node mesh; rank 0 prints and writes its report."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    em, snap = _deployment(args)
    lead = rank == 0
    agg = _aggregator(
        args, em, snap,
        Runtime(kernel_impl=args.impl, backend="mesh",
                mesh=compat.node_mesh(snap.n_nodes)),
        metrics=DEFAULT_REGISTRY,
        recorder=(TraceRecorder(sink=args.trace_out)
                  if lead and args.trace_out is not None else None),
        device=dev)
    out = _serve(args, agg, em, snap, lead)
    if lead:
        with open(os.path.join(out_dir, "report.pkl"), "wb") as f:
            pickle.dump(out, f)


def _run_mesh(args, dev: torch.device) -> dict:
    """Spawn one rank a protocol slot and return rank 0's report.  Every
    rank runs on ``dev`` (the card's device 0 unless one is named); any
    rank that raises or dies ends the others and raises here."""
    _, snap = _deployment(args)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    out_dir = tempfile.mkdtemp(prefix="repro-serve-agg-")
    try:
        compat.spawn_nodes(_mesh_rank, snap.n_nodes, args, str(dev),
                           out_dir)
        with open(os.path.join(out_dir, "report.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None, metrics=None) -> dict:
    """Run the load the arguments describe; returns the run report
    (``run_load`` / ``run_func_load``'s dict, with ``decision`` set to
    the tuner's pick when ``--tune`` is on; on the mesh, rank 0's).
    ``metrics`` is the registry (default: the process-wide one; each
    mesh rank uses its own process's)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if (args.data, args.model) != (1, 1):
        raise ConfigError(
            f"--data {args.data} --model {args.model}: the launcher runs "
            "its host mesh on one rank; larger ones come with the sharded "
            "serve (ROADMAP Queue 1 item 10.9)")
    with single_rank_mesh():
        mesh = make_host_mesh(data=args.data, model=args.model)
        print(f"mesh: {dict(mesh.shape)} on {dev.type}")
    if args.transport == "mesh":
        return _run_mesh(args, dev)
    em, snap = _deployment(args)
    agg = _aggregator(
        args, em, snap, Runtime(kernel_impl=args.impl, backend="sim"),
        metrics=DEFAULT_REGISTRY if metrics is None else metrics,
        recorder=(None if args.trace_out is None
                  else TraceRecorder(sink=args.trace_out)),
        device=args.device)
    return _serve(args, agg, em, snap)


if __name__ == "__main__":
    main()
