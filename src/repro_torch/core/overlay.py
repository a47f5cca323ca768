"""Cluster overlay with the (distributed) cuckoo rule of [AS09]/[AS07].

The port's own copy of ``repro/core/overlay.py`` (pure Python), so the
same seed builds the same overlay on both sides.

Protocol-scale simulation (Python, deterministic RNG): nodes occupy
positions in [0,1); clusters are the g equal segments; joins trigger
cuckoo churn (all nodes in a k/n-segment around the chosen position are
re-inserted at fresh random positions); leaves trigger the [AS07]
replacement rule.  Message accounting matches the distributed version
described in the paper (§4.2): position draws use cluster-level random
number generation (secure broadcasts within the cluster), and every move
informs the Chord neighbours.

The invariants the paper needs (and that tests assert):
  * every cluster has Θ(log n) members,
  * every cluster has an honest majority w.h.p. for τ <= 1/2 - ε.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional


@dataclasses.dataclass
class Node:
    uid: int
    pos: float
    honest: bool


@dataclasses.dataclass
class MsgStats:
    messages: int = 0
    bytes: int = 0

    def add(self, n_msgs: int, n_bytes: int) -> None:
        self.messages += n_msgs
        self.bytes += n_bytes


class Overlay:
    """n_target: nominal network size used to size clusters (g = n/(a*log n))."""

    def __init__(self, n_target: int, tau: float = 0.3, k: float = 4.0,
                 cluster_log_factor: float = 6.0, seed: int = 0,
                 msg_size: int = 64):
        # cluster size ~ cluster_log_factor * log2(n): the w.h.p. honest-
        # majority constant; the paper's Emulab deployment used 20*log n
        # for tau=3/10 — 6*log2(n) keeps P(any cluster malicious-majority)
        # well under 1% for tau <= 0.3 at simulated sizes.
        self.rng = random.Random(seed)
        self.n_target = n_target
        self.tau = tau
        self.k = k  # cuckoo churn segment length = k/n
        self.msg_size = msg_size
        logn = max(1.0, math.log2(n_target))
        self.g = max(2, int(n_target / (cluster_log_factor * logn)))
        self.nodes: dict[int, Node] = {}
        self._next_uid = 0
        self.stats = MsgStats()

    # -- bookkeeping ------------------------------------------------------
    def cluster_of(self, pos: float) -> int:
        return min(self.g - 1, int(pos * self.g))

    def clusters(self) -> list[list[Node]]:
        out: list[list[Node]] = [[] for _ in range(self.g)]
        for nd in self.nodes.values():
            out[self.cluster_of(nd.pos)].append(nd)
        return out

    def cluster_size_log(self) -> float:
        return len(self.nodes) / self.g

    # -- paper subroutine: cluster random number generation ----------------
    def _cluster_random(self, cluster_idx: int) -> float:
        """Commit-reveal randomness among cluster members: each member
        secure-broadcasts a commit then a reveal -> O(c^2) messages each."""
        c = max(1, len(self.clusters()[cluster_idx]))
        self.stats.add(2 * c * c, 2 * c * c * self.msg_size)
        return self.rng.random()

    # -- churn rules --------------------------------------------------------
    def _insert(self, node: Node, pos: float) -> None:
        node.pos = pos
        self.nodes[node.uid] = node
        # inform both adjacent clusters' members (Chord neighbour updates)
        c = max(1, int(self.cluster_size_log()))
        self.stats.add(2 * c, 2 * c * self.msg_size)

    def join(self, honest: bool) -> int:
        """Cuckoo rule: random position + churn of the surrounding k/n
        segment."""
        uid = self._next_uid
        self._next_uid += 1
        node = Node(uid, 0.0, honest)
        n = max(len(self.nodes) + 1, 8)
        # contacted cluster runs the random draw for the newcomer
        pos = self._cluster_random(self.rng.randrange(self.g))
        # cuckoo churn: everyone within the k/n segment moves to new
        # random positions (their destination clusters run more draws)
        lo = math.floor(pos * n / self.k) * self.k / n
        hi = lo + self.k / n
        moved = [nd for nd in self.nodes.values() if lo <= nd.pos < hi]
        for nd in moved:
            nd.pos = self._cluster_random(self.cluster_of(nd.pos))
            cmem = max(1, int(self.cluster_size_log()))
            self.stats.add(2 * cmem, 2 * cmem * self.msg_size)
        self._insert(node, pos)
        return uid

    def leave(self, uid: int) -> None:
        """[AS07] leave rule: replace a random k/n sub-segment of the
        departed node's cluster with nodes from a random segment, and
        re-insert the displaced ones at random positions."""
        node = self.nodes.pop(uid, None)
        if node is None:
            return
        n = max(len(self.nodes), 8)
        lo = self.rng.random() * (1.0 - self.k / n)
        hi = lo + self.k / n
        displaced = [nd for nd in self.nodes.values() if lo <= nd.pos < hi]
        for nd in displaced:
            nd.pos = self._cluster_random(self.cluster_of(nd.pos))
            cmem = max(1, int(self.cluster_size_log()))
            self.stats.add(2 * cmem, 2 * cmem * self.msg_size)

    # -- invariants ---------------------------------------------------------
    def check_invariants(self) -> dict:
        sizes = [len(cl) for cl in self.clusters()]
        majorities = [sum(nd.honest for nd in cl) > len(cl) / 2
                      for cl in self.clusters() if cl]
        return {
            "n": len(self.nodes),
            "g": self.g,
            "min_size": min(sizes),
            "max_size": max(sizes),
            "mean_size": sum(sizes) / len(sizes),
            "honest_majority_frac": sum(majorities) / max(1, len(majorities)),
            "all_honest_majority": all(majorities),
        }


def build_overlay(n: int, tau: float, seed: int = 0, **kw) -> Overlay:
    """Paper initialisation: honest nodes join first (trusted bootstrap),
    then the adversary's nodes join."""
    ov = Overlay(n_target=n, tau=tau, seed=seed, **kw)
    n_bad = int(tau * n)
    for _ in range(n - n_bad):
        ov.join(honest=True)
    for _ in range(n_bad):
        ov.join(honest=False)
    return ov
