"""Churn-epoch integration: pin in-flight sessions to overlay snapshots.

Counterpart of ``repro/service/epochs.py`` over the port's ``Overlay``
(whose churn draws replay the reference's: ``convert.overlay_fields``
carries one overlay across, so both managers snapshot the same
committees).

The cuckoo overlay (``core/overlay.py``) churns continuously — joins and
leaves move nodes between clusters.  The tensor path, however, needs a
*fixed* (g clusters x c members) committee layout for the whole life of
an aggregation session.  The bridge is the epoch:

  * ``EpochManager.current()`` snapshots the overlay's cluster
    assignments into an :class:`EpochSnapshot` — for each of g clusters,
    a committee of ``cluster_size`` members (protocol slots), with their
    overlay uids and honesty flags.
  * Sessions opened under epoch e stay pinned to e's snapshot even if
    the overlay churns while they are in flight — their hop layout and
    pad streams never change mid-session.
  * At execute time, any pinned slot whose overlay node has since *left*
    is injected as a mid-session crash via
    ``runtime.fault.SessionFaultPlan`` (mode "drop") — the dropped
    contribution is resolved by the vote path's r-redundant majority,
    exactly like the paper's Byzantine tolerance, with no retry round.

``churn`` applies a join/leave burst to the overlay and advances the
epoch, so new sessions see the new committees while old sessions drain
on the old ones.
"""
from __future__ import annotations

import collections
import dataclasses
import random
from typing import Optional

from repro_torch.core.overlay import Overlay
from repro_torch.runtime.fault import SessionFaultPlan


@dataclasses.dataclass(frozen=True)
class EpochSnapshot:
    """Frozen committee layout: slot s belongs to cluster s // cluster_size
    and is played by overlay node ``slot_uids[s]``."""
    epoch: int
    cluster_size: int
    slot_uids: tuple[int, ...]
    honest: tuple[bool, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.slot_uids)

    @property
    def n_clusters(self) -> int:
        return self.n_nodes // self.cluster_size

    def slots_of(self, uid: int) -> tuple[int, ...]:
        return tuple(s for s, u in enumerate(self.slot_uids) if u == uid)


class EpochManager:
    """Owns the overlay's epoch counter and committee snapshots."""

    def __init__(self, overlay: Overlay, cluster_size: int = 4,
                 n_clusters: Optional[int] = None):
        self.overlay = overlay
        self.cluster_size = cluster_size
        self.n_clusters = n_clusters or overlay.g
        self._epoch = 0
        self._snap: Optional[EpochSnapshot] = None
        # measured churn: departed-slot fraction of each retiring
        # snapshot, sampled at advance() — what the tuner's workload
        # signature reads instead of a static churn_rate hint
        self._observed: collections.deque = collections.deque(maxlen=8)

    # -- snapshots ----------------------------------------------------------
    def _committee(self) -> tuple[list[int], list[bool]]:
        """Pick ``cluster_size`` members per cluster (lowest uids — a
        deterministic stand-in for the paper's intra-cluster selection).
        Short clusters cycle their members; empty clusters borrow from
        the nearest non-empty one (both only occur at tiny sizes)."""
        clusters = self.overlay.clusters()[: self.n_clusters]
        non_empty = [sorted(nd.uid for nd in cl) for cl in clusters if cl]
        assert non_empty, "overlay has no members to snapshot"
        uids, honest = [], []
        for ci in range(self.n_clusters):
            members = (sorted(nd.uid for nd in clusters[ci])
                       if ci < len(clusters) and clusters[ci]
                       else non_empty[ci % len(non_empty)])
            for m in range(self.cluster_size):
                uid = members[m % len(members)]
                uids.append(uid)
                honest.append(self.overlay.nodes[uid].honest)
        return uids, honest

    def current(self) -> EpochSnapshot:
        if self._snap is None:
            uids, honest = self._committee()
            self._snap = EpochSnapshot(
                epoch=self._epoch, cluster_size=self.cluster_size,
                slot_uids=tuple(uids), honest=tuple(honest))
        return self._snap

    def advance(self) -> EpochSnapshot:
        """Start a new epoch with a fresh committee snapshot.  The
        retiring snapshot's departed-slot fraction is sampled into the
        observed-churn window first (see :meth:`observed_churn_rate`)."""
        prev = self._snap
        if prev is not None:
            self._observed.append(
                len(self.departed_slots(prev)) / prev.n_nodes)
        self._epoch += 1
        self._snap = None
        return self.current()

    # -- churn --------------------------------------------------------------
    def churn(self, joins: int = 0, leaves: int = 0,
              honest_join_frac: float = 1.0,
              rng: Optional[random.Random] = None) -> EpochSnapshot:
        """Apply a join/leave burst to the overlay, then advance the
        epoch.  Sessions opened before this call stay pinned to the old
        snapshot; their departed members surface via ``departed_plan``."""
        rng = rng or random.Random(self._epoch * 7919 + 13)
        self.current()     # snapshot BEFORE the burst so advance()
        uids = list(self.overlay.nodes)   # measures these leaves
        for uid in rng.sample(uids, min(leaves, len(uids))):
            self.overlay.leave(uid)
        for _ in range(joins):
            self.overlay.join(honest=rng.random() < honest_join_frac)
        return self.advance()

    # -- observed churn ------------------------------------------------------
    def observed_churn_rate(self) -> float:
        """The MEASURED departure pressure: mean departed-slot fraction
        over the last few epoch advances (window of 8), quantized to
        1/1024 so the value is a stable workload-signature component
        (``WorkloadSignature.of(..., epochs=...)``) — the tuner
        re-resolves its memoized decision exactly when the observed
        rate moves a whole quantum, not on every float wiggle.  0.0
        until the first advance."""
        if not self._observed:
            return 0.0
        mean = sum(self._observed) / len(self._observed)
        return min(1.0, round(mean * 1024) / 1024)

    # -- fault integration --------------------------------------------------
    def departed_slots(self, snap: EpochSnapshot) -> tuple[int, ...]:
        """Slots of ``snap`` whose overlay node has left since the
        snapshot was taken."""
        alive = self.overlay.nodes
        return tuple(s for s, uid in enumerate(snap.slot_uids)
                     if uid not in alive)

    def departed_plan(self, snap: EpochSnapshot) -> SessionFaultPlan:
        """Mid-session crash injection for a pinned session: every
        departed slot stops forwarding; the vote absorbs it."""
        return SessionFaultPlan(crashed_slots=self.departed_slots(snap))
