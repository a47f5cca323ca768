"""Workload signatures: what the self-tuning planner keys its
decisions on.

Counterpart of ``repro/tune/signature.py``.  A
:class:`WorkloadSignature` is the minimal description of an aggregation
workload that changes which protocol config is cheapest: the committee
size, the payload length, the batch width, and the two fault-pressure
knobs (expected churn and the static byzantine budget) that drive the
adaptive digest-backup tradeoff.  It is a small frozen hashable
dataclass, the key of the module-wide tuner decision cache, as
:class:`~repro_torch.core.plan.AggConfig` keys the plan cache.

Everything else about a run (masking mode, clip, seeds, kernel engine)
is *policy*, not workload: the tuner never touches those knobs, it
copies them from the base config it is resolving.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.schedules import _require


@dataclasses.dataclass(frozen=True)
class WorkloadSignature:
    """One tunable workload: ``(n_nodes, T, S, churn_rate,
    byzantine_budget)``.

    ``T`` is the per-node payload length in float32 elements (pre-pad;
    the tuner picks the pad), ``S`` the number of concurrent sessions
    per dispatch (1 for the one-shot verbs, the batch watermark for the
    service), ``churn_rate`` the expected fraction of nodes departing
    mid-session, and ``byzantine_budget`` the number of statically
    corrupt ranks the run must absorb."""
    n_nodes: int
    T: int
    S: int = 1
    churn_rate: float = 0.0
    byzantine_budget: int = 0

    def __post_init__(self):
        _require(self.n_nodes >= 1,
                 f"signature n_nodes must be >= 1, got {self.n_nodes}")
        _require(self.T >= 1,
                 f"signature T (payload elems) must be >= 1, got {self.T}")
        _require(self.S >= 1,
                 f"signature S (sessions per dispatch) must be >= 1, "
                 f"got {self.S}")
        _require(0.0 <= self.churn_rate <= 1.0,
                 f"signature churn_rate must be in [0, 1], got "
                 f"{self.churn_rate}")
        _require(0 <= self.byzantine_budget <= self.n_nodes,
                 f"signature byzantine_budget must be in [0, n_nodes="
                 f"{self.n_nodes}], got {self.byzantine_budget}")

    @classmethod
    def of(cls, cfg, T: int, S: int = 1, churn_rate: float = 0.0,
           epochs=None) -> "WorkloadSignature":
        """Signature of running ``cfg``'s committee at payload length
        ``T`` and batch width ``S`` — the byzantine budget is read off
        the config's static fault model.

        ``epochs`` (an :class:`~repro_torch.service.EpochManager`) switches
        the churn component from the static ``churn_rate`` hint to the
        manager's MEASURED departure rate
        (``EpochManager.observed_churn_rate``, already quantized for
        signature stability): as the observed rate moves, the signature
        changes and the memoized tuner decision re-resolves for the
        pressure the network is actually under."""
        if epochs is not None:
            churn_rate = epochs.observed_churn_rate()
        return cls(n_nodes=cfg.n_nodes, T=int(T), S=int(S),
                   churn_rate=churn_rate,
                   byzantine_budget=len(cfg.byzantine.corrupt_ranks))

    def corruption_rate(self) -> float:
        """Probability that any given hop's primary payload stream is
        bad: a statically corrupt sender (``byzantine_budget / n``) or a
        mid-session departure (``churn_rate``).  Both are detected by
        the digest vote; both need the backup stream (or a retransmission
        round) to recover in-band."""
        return min(1.0, self.byzantine_budget / self.n_nodes
                   + self.churn_rate)
