"""Monte-Carlo reproduction of the Theorem 1 lower-bound mechanics.

Port of ``repro/core/lower_bound.py`` (pure Python, no kernel): the same
seeds give the same estimates.

Setting: n nodes, εn malicious.  Every honest node sends its messages to
``w_plus`` recipients chosen uniformly at random.  Theorem 1: if
w⁺ = o(log n) (and the receive side is bounded), then w.h.p. SOME node
sends ALL its messages to malicious nodes — the adversary can erase its
input, so no o(n log n) balanced protocol can be exact w.h.p.

``surround_probability`` estimates P(∃ surrounded node) empirically, and
``predicted`` gives the analytic 1-(1-ε^w)^n approximation (independent
recipient sets; the paper's greedy disjointification makes this rigorous).
The experiment shows the phase transition: probability -> 1 for constant
or sub-logarithmic w⁺, -> 0 for w⁺ = Θ(log n) with a large enough
constant.
"""
from __future__ import annotations

import math
import random


def surround_probability(n: int, eps: float, w_plus: int, trials: int = 200,
                         seed: int = 0) -> float:
    """Empirical P(at least one node has all recipients malicious)."""
    rng = random.Random(seed)
    n_bad = int(eps * n)
    hits = 0
    for _ in range(trials):
        bad = set(rng.sample(range(n), n_bad))
        surrounded = False
        for node in range(n):
            if node in bad:
                continue
            # recipients chosen uniformly at random among other nodes
            ok = False
            for _ in range(w_plus):
                if rng.randrange(n - 1) >= n_bad:  # recipient honest
                    ok = True
                    break
            if not ok:
                surrounded = True
                break
        hits += surrounded
    return hits / trials


def predicted(n: int, eps: float, w_plus: int) -> float:
    """Analytic approximation 1 - (1 - eps^w)^(n_honest)."""
    p_one = eps ** w_plus
    return 1.0 - (1.0 - p_one) ** (n - int(eps * n))


def phase_table(eps: float = 0.25, trials: int = 100,
                ns=(128, 256, 512, 1024, 2048, 4096)) -> list[dict]:
    """Rows for EXPERIMENTS.md: constant w+, sqrt-log w+, and c*log n."""
    rows = []
    for n in ns:
        logn = math.log(n)
        for label, w in (
            ("w=2 (const)", 2),
            ("w=log n/4", max(1, int(logn / 4))),
            ("w=3 log n", int(3 * logn)),
        ):
            rows.append({
                "n": n, "regime": label, "w_plus": w,
                "empirical": surround_probability(n, eps, w, trials=trials),
                "predicted": predicted(n, eps, w),
            })
    return rows
