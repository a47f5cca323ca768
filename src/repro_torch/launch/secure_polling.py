"""The paper's own application, distributed polling, through the secure
function layer on the ``SecureAggregator`` facade: the server learns a
histogram of ratings and the median rating, and nothing else.

    PYTHONPATH=src python -m repro_torch.launch.secure_polling \
        [--n 256] [--tau 0.2] [--polls 6] [--bins 8] [--steps 256] \
        [--device cpu]

Counterpart of ``examples/secure_polling.py``, with the same checks:

  * the one-shot ``histogram`` verb, one one-hot count allreduce
    revealing only the bucket totals, equal to ``np.histogram``;
  * service-hosted ``median`` polls, each a chain of
    ``ceil(log2(steps))`` threshold-count bisection rounds riding
    ordinary aggregation sessions, advanced by ``pump`` / ``drain`` and
    batched across polls by the admission scheduler, with overlay churn
    striking after the second round (sessions stay pinned to their
    epoch's committees; departures are vote-absorbed crashes); every
    poll equal to the numpy oracle on the quantized domain;
  * one run of the node-scale DA protocol with real threshold Paillier,
    Step 4 on the Montgomery kernels of ``--device``, as the
    protocol-level cross-check.

``--device`` defaults to the card; ``cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import SecureAggregator, Security, Topology
from repro_torch.core.overlay import build_overlay
from repro_torch.core.protocol import Adversary, DAProtocol
from repro_torch.funcs import ValueDomain
from repro_torch.funcs.run import quantile_rank
from repro_torch.service import BatchingConfig, EpochManager


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--tau", type=float, default=0.2)
    ap.add_argument("--polls", type=int, default=6)
    ap.add_argument("--bins", type=int, default=8)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--key-bits", type=int, default=32)
    ap.add_argument("--skip-paillier", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda')")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the polling deployment; every check is an assert.  Returns
    the histogram, the polls' results and the service's batch sizes."""
    args = parser().parse_args(argv)
    print(f"== building cuckoo overlay: n={args.n}, tau={args.tau} ==")
    ov = build_overlay(args.n, args.tau, seed=42)
    inv = ov.check_invariants()
    print(f"clusters: g={inv['g']}, sizes [{inv['min_size']}.."
          f"{inv['max_size']}], honest-majority clusters: "
          f"{inv['honest_majority_frac'] * 100:.0f}%")

    em = EpochManager(ov, cluster_size=4)
    snap = em.current()
    agg = SecureAggregator(
        topology=Topology(n_nodes=snap.n_nodes, cluster_size=4),
        security=Security(redundancy=3), epochs=em,
        batching=BatchingConfig(max_batch=args.batch, max_age=1e9),
        device=args.device)
    n_slots = snap.n_nodes
    rng = np.random.default_rng(7)

    # -- one-shot verb: rating histogram ---------------------------------
    print(f"== rating histogram: {n_slots} voters -> {args.bins} buckets "
          f"(one one-hot count allreduce) on {agg.device} ==")
    c = agg.cost(fn="histogram", bins=args.bins)
    ratings = rng.random(n_slots)
    hist = agg.histogram(ratings, bins=args.bins, range=(0.0, 1.0))
    want = np.histogram(ratings, bins=args.bins, range=(0.0, 1.0))[0]
    print(f"buckets: {hist.tolist()} ({c['bytes_total']} wire bytes; "
          f"server never sees a single rating)")
    assert np.array_equal(hist, want)

    # -- service: concurrent median polls under mid-flight churn ---------
    dom = ValueDomain(0.0, 1.0, args.steps)
    c = agg.cost(fn="median", domain=dom)
    print(f"== {args.polls} concurrent median polls: steps={args.steps} "
          f"-> {c['allreduces']} bisection rounds each, "
          f"{c['bytes_total']} wire bytes/poll ==")
    polls = []
    for i in range(args.polls):
        fs = agg.open_session(fn="median", domain=dom, now=float(i))
        vals = rng.random(n_slots)
        for slot in range(n_slots):
            fs.contribute(slot, float(vals[slot]))
        fs.seal(now=float(i))
        polls.append((fs, vals))
    # two bisection rounds flush, then churn strikes: in-flight rounds
    # stay pinned to their epoch; later rounds pin to the new committees
    agg.pump(force=True)
    agg.pump(force=True)
    em.churn(joins=8, leaves=8, honest_join_frac=1.0)
    print(f"  churn mid-bisection: epoch -> {em.current().epoch}, "
          f"overlay n={len(ov.nodes)}")
    agg.drain()

    exact = 0
    for fs, vals in polls:
        assert fs.done, fs
        quant = np.sort([dom.value(int(i)) for i in dom.indices(vals)])
        want = quant[quantile_rank(0.5, n_slots) - 1]
        exact += bool(fs.result == want)
    st = agg.stats()["service"]
    print(f"median polls exact: {exact}/{args.polls} "
          f"(batches: {st['batches']['run']}, sizes "
          f"{st['batches']['sizes']}, final epoch: {st['epoch']})")
    assert exact == args.polls

    da = None
    if not args.skip_paillier:
        print("== protocol-level cross-check: one DA poll with real "
              "threshold Paillier (Step 4 on the Montgomery kernels) ==")
        proto = DAProtocol(ov, key_bits=args.key_bits,
                           adversary=Adversary(drop_rate=0.2,
                                               corrupt_ring=True,
                                               bad_inputs=True),
                           seed=7, kernel_crypto=True, device=agg.device)
        r = proto.run()
        print(f"poll result: {r.output} yes of {len(ov.nodes)} voters "
              f"(expected {r.expected}) — exact={r.exact}")
        print(f"communication: {r.stats.messages} msgs, "
              f"{r.stats.bytes / 1e6:.2f} MB total")
        assert r.exact
        da = {"output": r.output, "expected": r.expected,
              "messages": r.stats.messages, "bytes": r.stats.bytes}

    print("OK")
    return {"histogram": hist, "medians": [fs.result for fs, _ in polls],
            "batch_sizes": st["batches"]["sizes"], "da": da,
            "n_slots": n_slots}


if __name__ == "__main__":
    main()
