"""One caller in a closed loop of secure allreduces through the port's
facade (``repro_torch.SecureAggregator.allreduce`` on the ``sim``
backend: every party on the one card).

Set-up makes the payload sets from the seed, builds the facade and runs
one call (every shape the window uses).  The window then makes
back-to-back calls over the sets in turn, each timed on the host clock
from the call to a ``torch.cuda.synchronize()``; a sample of the calls,
drawn from the seed, keeps its output.  After the window the plain
reference sums each set exactly and every node's row of each kept output
is compared with it.  Two guarantees that honest traffic cannot show
are checked besides: the kernels the window launched a call (the mask
before the first hop, the unmask of the sum, a vote a voted round)
against the cell's plan, and one call of a facade built the same way
with a faulty member in each cluster, drawn from the seed, whose rows
still have to equal the exact sum.
"""
import random
import time

import torch
from torch.profiler import record_function

from chipbench import harness
from chipbench.reference import secagg as ref
from chipbench.traffic import payloads


def corrupt_members(cell: harness.Cell) -> tuple:
    """The check call's faulty members: ``corrupt_per_cluster`` of each
    cluster, drawn from the seed."""
    p = cell.config["protocol"]
    c, k = p["cluster_size"], cell.workload["byzantine_check"][
        "corrupt_per_cluster"]
    rng = random.Random(cell.seed)
    return tuple(sorted(cl * c + m for cl in range(p["n_nodes"] // c)
                        for m in rng.sample(range(c), k)))


def build(cell: harness.Cell, corrupt: tuple = ()):
    from repro_torch import Runtime, SecureAggregator, Security, Topology, Wire
    from repro_torch.core.byzantine import ByzantineSpec
    p, t = cell.config["protocol"], cell.traffic
    byz = ByzantineSpec(corrupt_ranks=corrupt,
                        mode=cell.workload["byzantine_check"]["mode"])
    return SecureAggregator(
        topology=Topology(n_nodes=p["n_nodes"],
                          cluster_size=p["cluster_size"],
                          schedule=p["schedule"]),
        security=Security(redundancy=p["redundancy"], masking=p["masking"],
                          clip=p["clip"], guard_bits=p["guard_bits"],
                          byzantine=byz),
        wire=Wire(transport=t["transport"],
                  digest_words=t.get("digest_words", 16),
                  digest_backup=t.get("digest_backup", True)),
        runtime=Runtime(kernel_impl=cell.impl, backend=p["backend"]),
        device=cell.device)


def _sync(cell: harness.Cell) -> None:
    if cell.device.startswith("cuda"):
        torch.cuda.synchronize()


class Sample:
    """A uniform sample of ``k`` calls' outputs, drawn from the seed
    (reservoir sampling over however many calls the window makes)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: list = []

    def offer(self, i: int, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = item


def mismatches(want: torch.Tensor, out: torch.Tensor, n: int) -> int:
    """Elements of the n nodes' rows of ``out`` that differ from the
    exact sum ``want`` (every element, where the shape is wrong)."""
    exp = want.expand(n, -1)
    if tuple(out.shape) != tuple(exp.shape):
        return exp.numel()
    return int((out != exp).sum())


def compare(sets: list, kept: list, p: dict) -> dict:
    """Mismatched elements over every node's row of each kept output,
    against the exact sum of its payload set."""
    want = {}
    bad = 0
    for s, out in kept:
        if s not in want:
            want[s] = ref.exact_sum(sets[s], p["clip"], p["guard_bits"])
        bad += mismatches(want[s], out, p["n_nodes"])
    return {"mismatched_elements": bad,
            "rows_compared": p["n_nodes"] * len(kept)}


def launch_gap(before: dict, after: dict, plan: dict, calls: int) -> int:
    """How far the kernels' launches over ``calls`` calls lie from the
    plan's launches a call, summed over the plan's kernels."""
    return sum(abs(after[k] - before[k] - per * calls)
               for k, per in plan.items())


def run(cell: harness.Cell, fault=None) -> harness.Outcome:
    """``fault`` (tests only) wraps the facade's call to break it."""
    from repro_torch.kernels import backend
    dev = torch.device(cell.device)
    p, t = cell.config["protocol"], cell.traffic
    n, T = p["n_nodes"], cell.config["payload"]["elems_per_node"]
    sets = payloads.node_payloads(cell.seed, n, T, t, dev)

    def facade(corrupt=()):
        agg = build(cell, corrupt)
        return agg.allreduce if fault is None else fault(agg.allreduce)

    call = facade()
    call(sets[0])                       # set-up: build, plan, warm up
    _sync(cell)

    sample = Sample(int(t["sampled_calls"]), cell.seed)
    launched = backend.launch_counts()
    lat = []
    win = harness.Window(cell)
    win.start()
    i = 0
    while True:
        s = i % len(sets)
        t0 = time.perf_counter()
        with record_function("bench.call"):
            out = call(sets[s])
        _sync(cell)
        lat.append(time.perf_counter() - t0)
        sample.offer(i, (s, out))
        del out
        i += 1
        if not win.tick():
            break
    win.stop()
    setup_s = win.t0 - cell.t_start
    res = {"launch_gap": launch_gap(launched, backend.launch_counts(),
                                    cell.workload["launches_per_call"], i)}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del call
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    res.update(compare(sets, sample.kept, p))
    res["corrupt_members"] = corrupt_members(cell)
    out = facade(res["corrupt_members"])(sets[0])
    res["byzantine_mismatched"] = mismatches(
        ref.exact_sum(sets[0], p["clip"], p["guard_bits"]), out, n)
    del out
    e2e = {"allreduce_p95_ms": harness.percentile(lat, 95) * 1e3,
           "allreduce_gelem_per_s": n * T * i / win.seconds / 1e9,
           "setup_s": setup_s}
    checks = [(k, res[k], cell.limits[k])
              for k in ("mismatched_elements", "byzantine_mismatched",
                        "launch_gap")]
    return harness.Outcome(attempted=i, failed=0, e2e=e2e, checks=checks,
                           memory_peak_bytes=peak, window=win, details=res)
