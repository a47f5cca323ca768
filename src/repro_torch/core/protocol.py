"""The paper's distributed aggregation (DA) protocol at node scale, with
real threshold-Paillier crypto and per-message accounting (§4.1/§4.3).

Port of ``repro/core/protocol.py``: the same phases, draws, messages and
bytes.  Step 4's partial decryptions run as one batched modular
exponentiation on the Montgomery-multiply kernel, on ``device``
(``None`` means the card, and raises without one; ``"cpu"`` runs the
kernel's plain torch version); ``kernel_crypto=False`` asks for
per-share Python ``pow`` on the host instead.  ``primes=(p, q)`` fixes
the safe primes of the threshold key, so a full-width run has the same
shapes every time.

Each node is a Python object; "communication" increments counters and,
for malicious nodes, can drop/corrupt values.  The protocol phases map
1:1 onto the paper:

  Step 1  threshold cryptosystem setup in the threshold cluster
  Step 2  encrypt + secure-broadcast inside each cluster, local aggregate
  Step 3  majority-voted ring accumulation cluster -> cluster
  Step 4  threshold decryption + result dissemination

Message/byte accounting follows §4.4: ciphertexts are O(log n)-size
payloads (counted via the actual modulus byte length), the intra-cluster
secure broadcast [HZ10] costs O(c²) messages per broadcast, and
inter-cluster hops are c² point-to-point sends.
"""
from __future__ import annotations

import dataclasses
import random
from collections import Counter
from typing import Optional

from repro_torch.core.overlay import MsgStats, Overlay, build_overlay
from repro_torch.crypto.paillier import threshold_keygen


@dataclasses.dataclass
class ProtocolResult:
    output: Optional[int]
    expected: int
    exact: bool
    stats: MsgStats
    phase_bytes: dict
    n: int
    g: int
    cluster_sizes: list


@dataclasses.dataclass
class Adversary:
    """Byzantine behaviours for malicious nodes (static adversary)."""
    drop_rate: float = 0.0        # refuse to participate
    corrupt_ring: bool = True     # send garbage partial aggregates
    bad_inputs: bool = True       # choose extreme (but VALID) inputs
    rng: random.Random = dataclasses.field(default_factory=lambda: random.Random(7))


class DAProtocol:
    """Runs one aggregation over a built overlay."""

    def __init__(self, overlay: Overlay, key_bits: int = 32,
                 value_range: int = 2, adversary: Optional[Adversary] = None,
                 seed: int = 0, kernel_crypto: bool = True, device=None,
                 primes: Optional[tuple[int, int]] = None):
        self.ov = overlay
        self.rng = random.Random(seed)
        self.adv = adversary or Adversary()
        self.key_bits = key_bits
        self.value_range = value_range
        # Step 4's modular exponentiations go through the batched modmul
        # kernel (one ladder for all shareholders) on ``device``, or with
        # kernel_crypto=False per-share Python pow -- identical values
        self.kernel_crypto = kernel_crypto
        self.device = device
        # the threshold key's safe primes; (None, None) draws them
        self.primes = primes or (None, None)
        self.stats = MsgStats()
        self.phase_bytes: dict[str, int] = {}

    def _count(self, phase: str, msgs: int, nbytes: int) -> None:
        self.stats.add(msgs, nbytes)
        self.phase_bytes[phase] = self.phase_bytes.get(phase, 0) + nbytes

    # ------------------------------------------------------------------
    def run(self, inputs: Optional[dict[int, int]] = None) -> ProtocolResult:
        clusters = [cl for cl in self.ov.clusters() if cl]
        g = len(clusters)
        ct_bytes = None

        # --- inputs ----------------------------------------------------
        values: dict[int, int] = {}
        for cl in clusters:
            for nd in cl:
                if inputs and nd.uid in inputs:
                    values[nd.uid] = inputs[nd.uid]
                elif nd.honest:
                    values[nd.uid] = self.rng.randrange(self.value_range)
                else:
                    if self.adv.rng.random() < self.adv.drop_rate:
                        values[nd.uid] = None  # refuses to participate
                    elif self.adv.bad_inputs:
                        # extreme but valid input (ZK range proof forces
                        # validity; the proof itself is a constant payload)
                        values[nd.uid] = self.value_range - 1
                    else:
                        values[nd.uid] = self.adv.rng.randrange(self.value_range)
        expected = sum(v for v in values.values() if v is not None)

        # --- Step 1: threshold setup in the threshold cluster ----------
        tc = clusters[-1]
        c_t = len(tc)
        t = c_t // 2 + 1
        p, q = self.primes
        tp, shares = threshold_keygen(bits=self.key_bits, t=t, c=c_t,
                                      p=p, q=q)
        ct_bytes = (tp.pk.n2.bit_length() + 7) // 8
        # DKG [NS11] ~ O(c^2) secure broadcasts of share-sized payloads
        self._count("setup", c_t * c_t, c_t * c_t * ct_bytes)
        share_of = {nd.uid: sh for nd, sh in zip(tc, shares)}
        # pk dissemination along the ring: cluster-to-cluster full bipartite
        for i in range(g - 1):
            c1, c2 = len(clusters[i]), len(clusters[i + 1])
            self._count("setup", c1 * c2, c1 * c2 * ct_bytes)

        # --- Step 2: encrypt + secure broadcast + local aggregates -----
        local_agg: list[Optional[int]] = []
        for cl in clusters:
            c = len(cl)
            agg = None
            for nd in cl:
                v = values[nd.uid]
                if v is None:
                    continue  # non-participant: protocol carries on
                ct = tp.pk.encrypt(v)
                # secure broadcast [HZ10]: O(c^2) msgs of ciphertext size
                # (+ constant-size NIZK range proof [YHM+09], ~2 ct sizes)
                self._count("local_agg", c * c, c * c * ct_bytes * 3)
                agg = ct if agg is None else tp.pk.add(agg, ct)
            local_agg.append(agg)

        # --- Step 3: voted ring accumulation ---------------------------
        partial: Optional[int] = None
        for i, cl in enumerate(clusters):
            if partial is None:
                partial = local_agg[i]
            elif local_agg[i] is not None:
                partial = tp.pk.add(partial, local_agg[i])
            if i == g - 1:
                break
            nxt = clusters[i + 1]
            # every member of cl sends partial to every member of nxt;
            # malicious senders may corrupt their copies
            ballots = []
            for sender in cl:
                if not sender.honest and self.adv.corrupt_ring:
                    ballots.append(self.adv.rng.randrange(tp.pk.n2))
                else:
                    ballots.append(partial)
            self._count("ring", len(cl) * len(nxt),
                        len(cl) * len(nxt) * ct_bytes)
            # receivers take the majority ballot
            partial = Counter(ballots).most_common(1)[0][0]

        # --- Step 4: threshold decryption ------------------------------
        decryptors = []
        for nd in tc:
            if nd.uid not in share_of:
                continue
            if not nd.honest and self.adv.rng.random() < 0.5:
                continue  # malicious shareholder refuses to decrypt
            decryptors.append(share_of[nd.uid])
            # share broadcast within cluster + NIZK of share validity [DJ01]
            self._count("decrypt", c_t, c_t * ct_bytes * 2)
        parts = tp.partial_decrypt_batch(partial, decryptors,
                                         use_kernel=self.kernel_crypto,
                                         device=self.device)
        if len(parts) < t:
            output = None
        else:
            output = tp.combine(parts[:t])
        # result dissemination along the ring
        for i in range(g - 1):
            c1, c2 = len(clusters[i]), len(clusters[i + 1])
            self._count("disseminate", c1 * c2, c1 * c2 * 8)

        return ProtocolResult(
            output=output, expected=expected,
            exact=(output == expected),
            stats=self.stats, phase_bytes=dict(self.phase_bytes),
            n=len(self.ov.nodes), g=g,
            cluster_sizes=[len(cl) for cl in clusters])


def run_da(n: int, tau: float = 0.3, key_bits: int = 32, seed: int = 0,
           adversary: Optional[Adversary] = None, *,
           kernel_crypto: bool = True, device=None) -> ProtocolResult:
    ov = build_overlay(n, tau, seed=seed)
    return DAProtocol(ov, key_bits=key_bits, adversary=adversary,
                      seed=seed, kernel_crypto=kernel_crypto,
                      device=device).run()
