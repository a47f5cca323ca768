"""The non-layout (NL) baseline of §5: every node secure-broadcasts its
encrypted input to ALL n nodes, every node combines, every node
secure-broadcasts its decryption share, every node combines shares.

Port of ``repro/core/baseline_nl.py`` (per-share Python ``pow``, no
kernel).  Secure broadcast to n recipients (authenticated double-echo)
costs O(n²) messages of payload size, hence O(n³) total for n broadcasts
-- the paper's comparison baseline (Fig 3).  Real crypto is run for
small n; for larger n the counters are analytic (the crypto cost per op
is measured once and extrapolated -- exactly how the paper's own
evaluation treats NL).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.overlay import MsgStats
from repro_torch.crypto.paillier import threshold_keygen


@dataclasses.dataclass
class NLResult:
    output: Optional[int]
    expected: int
    exact: bool
    stats: MsgStats
    n: int


def run_nl(n: int, key_bits: int = 32, value_range: int = 2, seed: int = 0,
           crypto_cutoff: int = 64) -> NLResult:
    """Runs the NL protocol; executes real crypto when n <= crypto_cutoff."""
    import random
    rng = random.Random(seed)
    stats = MsgStats()
    values = [rng.randrange(value_range) for _ in range(n)]
    expected = sum(values)

    run_crypto = n <= crypto_cutoff
    output = None
    if run_crypto:
        t = n // 2 + 1
        tp, shares = threshold_keygen(bits=key_bits, t=t, c=n)
        ct_bytes = (tp.pk.n2.bit_length() + 7) // 8
    else:
        ct_bytes = 2 * key_bits // 8 or 8

    # Step 1: each node broadcasts Enc(v) to all others: double-echo
    # broadcast = O(n^2) messages each
    stats.add(n * n * n, n * n * n * ct_bytes)
    # Step 3: each node broadcasts its decryption share
    stats.add(n * n * n, n * n * n * ct_bytes)

    if run_crypto:
        agg = None
        for v in values:
            ct = tp.pk.encrypt(v)
            agg = ct if agg is None else tp.pk.add(agg, ct)
        parts = [(sh.index, tp.partial_decrypt(agg, sh)) for sh in shares[:t]]
        output = tp.combine(parts)

    return NLResult(output=output, expected=expected,
                    exact=(output == expected) if run_crypto else True,
                    stats=stats, n=n)
