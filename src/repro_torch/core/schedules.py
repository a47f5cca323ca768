"""Cluster-level aggregation schedules (pure Python; a copy of
``repro/core/schedules.py``, which the port may not import).

A schedule is a list of *rounds*; each round says, for every cluster, which
cluster it receives a partial aggregate from (or None).  Schedules operate
at cluster granularity — the member-level fan-out (redundancy ``r`` copies
for the majority vote) is applied by ``core.plan.compile_plan`` when turning a
round into permutations and gathers.

  * ring      — the paper's Step 3 executed as a concurrent rotation
                (g-1 rounds; every cluster ends with the total).
  * tree      — the paper's own suggested binary-tree variant: reduce up
                (log2 g rounds) then broadcast down (log2 g rounds).
  * butterfly — beyond-paper recursive doubling: log2 g rounds, all
                clusters end with the total, same per-round volume as ring.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional


class ConfigError(ValueError):
    """An invalid protocol-config knob (or knob combination).

    Raised eagerly at construction time by the config sections in
    ``core.plan`` (:class:`Topology` / :class:`Security` / :class:`Wire`
    / :class:`Runtime` / :class:`AggConfig`) and by the schedule
    builders below — a real exception, not an ``assert``, so the checks
    survive ``python -O`` and the message always says which knob to fix.
    Defined here (the import root of the config stack) and re-exported
    by ``core.plan`` / ``repro.api``, so programmatic callers like the
    tuner's candidate enumeration can catch one exception type
    everywhere."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ConfigError(msg)


@dataclasses.dataclass(frozen=True)
class Round:
    # recv_from[i] = cluster that cluster i receives from (None = idle)
    recv_from: tuple[Optional[int], ...]
    # how receivers combine the received value v with their accumulator a:
    #   "add"        a + v       (tree reduce / butterfly: disjoint coverage)
    #   "replace"    v           (tree broadcast-down)
    #   "local_plus" local + v   (ring rotation: partial_i = L_i + partial_{i-1})
    combine: str = "add"


def ring_schedule(g: int) -> list[Round]:
    return [Round(tuple((i - 1) % g for i in range(g)), combine="local_plus")
            for _ in range(g - 1)]


def tree_schedule(g: int) -> list[Round]:
    _require(g >= 1 and g & (g - 1) == 0,
             f"schedule='tree' needs a power-of-two cluster count, got "
             f"g={g} (= n_nodes/cluster_size); use 'ring', or adjust "
             "n_nodes/cluster_size so their ratio is a power of two")
    k = int(math.log2(g))
    rounds = []
    # reduce: at level l, cluster i with i % 2^(l+1) == 2^l sends to i - 2^l
    for l in range(k):
        recv = [None] * g
        for i in range(g):
            src = i + (1 << l)
            if i % (1 << (l + 1)) == 0 and src < g:
                recv[i] = src
        rounds.append(Round(tuple(recv), combine="add"))
    # broadcast: reverse order, parent pushes the total back down
    for l in reversed(range(k)):
        recv = [None] * g
        for i in range(g):
            src = i - (1 << l)
            if i % (1 << (l + 1)) == (1 << l) and src >= 0:
                recv[i] = src
        rounds.append(Round(tuple(recv), combine="replace"))
    return rounds


def butterfly_schedule(g: int) -> list[Round]:
    _require(g >= 1 and g & (g - 1) == 0,
             f"schedule='butterfly' needs a power-of-two cluster count, "
             f"got g={g} (= n_nodes/cluster_size); use 'ring', or adjust "
             "n_nodes/cluster_size so their ratio is a power of two")
    k = int(math.log2(g))
    return [Round(tuple(i ^ (1 << l) for i in range(g)), combine="add")
            for l in range(k)]


SCHEDULES = {
    "ring": ring_schedule,
    "tree": tree_schedule,
    "butterfly": butterfly_schedule,
}


def get_schedule(name: str, g: int) -> list[Round]:
    if g == 1:
        return []
    return SCHEDULES[name](g)


def schedule_cost(name: str, g: int, c: int, r: int, payload_bytes: int,
                  digest: bool = False, digest_ratio: Optional[int] = None,
                  digest_bytes: Optional[int] = None,
                  digest_backup: bool = False,
                  digest_words: int = 16) -> dict:
    """Analytic per-step communication cost of the cluster phase (per node
    and total), used by benchmarks and napkin math in EXPERIMENTS §Perf.

    The digest term is EXACT by default: each voted copy ships
    ``digest_words * 4`` bytes (``AggConfig.digest_words``, default 16),
    the same account the engine's ``Transport.bytes_sent`` accumulates —
    so the analytic total equals the executed plan bit for bit (the
    conformance suite pins that equality).  ``digest_bytes`` pins the
    digest size directly (overrides ``digest_words``); ``digest_backup``
    adds the compiled shift-1 backup payload each receiving member
    fetches eagerly (``AggConfig.digest_backup``).

    ``digest_ratio`` is the legacy payload-proportional approximation
    (``d = payload_bytes // digest_ratio``); it silently diverged from
    the engine's fixed-width digests and is deprecated — passing it
    emits a ``DeprecationWarning`` and the tuner refuses to score with
    it (``tests/test_tune.py`` pins both)."""
    rounds = get_schedule(name, g)
    active_recv = sum(sum(1 for s in rnd.recv_from if s is not None)
                      for rnd in rounds)  # cluster-level receives
    if digest:
        # each receiving member: 1 full payload + r digest copies to vote
        # on (+ the eager backup payload when compiled in)
        if digest_bytes is not None:
            d = digest_bytes
        elif digest_ratio is not None:
            warnings.warn(
                "schedule_cost(digest_ratio=...) is the legacy "
                "payload-proportional digest approximation and diverges "
                "from the engine's exact digest_words * 4 account; pass "
                "digest_words= (or digest_bytes=) instead",
                DeprecationWarning, stacklevel=2)
            d = payload_bytes // digest_ratio
        else:
            d = 4 * digest_words
        per_member = payload_bytes + r * d
        if digest_backup:
            per_member += payload_bytes
    else:
        # each receiving member: r full redundant copies
        per_member = r * payload_bytes
    total = active_recv * c * per_member
    return {
        "rounds": len(rounds),
        "cluster_receives": active_recv,
        "bytes_total": total,
        "bytes_per_node": total / (g * c),
    }
