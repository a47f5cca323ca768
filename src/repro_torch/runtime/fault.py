"""Mid-session fault injection for the multi-session aggregation service.

Counterpart of the session half of ``repro/runtime/fault.py``:
``SessionFaultPlan`` names protocol slots that crash (their forwarded
ring copies drop to zeros) or turn Byzantine (copies are flipped) while
the session is in flight.  Both lower to the vote path's
``ByzantineSpec`` -- a dropped or corrupted contribution is out-voted by
the r-redundant majority, never retried.  (The reference's driver-level
``FailurePlan`` / ``StepGuard`` belong to its training driver, which the
port does not carry.)
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.byzantine import ByzantineSpec


class FaultPlanError(ValueError):
    """An invalid session fault plan (overlapping slot groups,
    conflicting Byzantine modes).  A real exception in the
    ``core.plan.ConfigError`` style — raised eagerly, survives
    ``python -O``, and the message says which slots to fix."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise FaultPlanError(msg)


@dataclasses.dataclass(frozen=True)
class SessionFaultPlan:
    """Injected faults for one aggregation session, by protocol slot.

    ``crashed_slots``: members that die mid-session — they stop forwarding
    (mode "drop"; the epoch layer also adds slots whose overlay node left
    after the session's epoch snapshot).  ``byzantine_slots``: members
    whose outgoing copies are corrupted (``byzantine_mode`` — any engine
    fault mode, including the digest adversaries "equivocate"/"mismatch"
    and round-gated "<mode>@k" crash-at-hop-k forms).  Slots must be
    disjoint across the two groups; the batched executor applies each
    group as one masked pass."""
    crashed_slots: tuple[int, ...] = ()
    byzantine_slots: tuple[int, ...] = ()
    byzantine_mode: str = "flip"   # flip | garbage | equivocate | ... | m@k

    def __post_init__(self):
        overlap = set(self.crashed_slots) & set(self.byzantine_slots)
        _require(not overlap,
                 f"slot(s) {sorted(overlap)} appear in both crashed_slots "
                 "and byzantine_slots — the fault groups must be disjoint "
                 "(a slot either crashes or corrupts, not both); put each "
                 "slot in exactly one group")

    def specs(self) -> tuple[ByzantineSpec, ...]:
        """Lower to the vote path's per-mode corruption specs."""
        out = []
        if self.crashed_slots:
            out.append(ByzantineSpec(
                corrupt_ranks=tuple(sorted(self.crashed_slots)), mode="drop"))
        if self.byzantine_slots:
            out.append(ByzantineSpec(
                corrupt_ranks=tuple(sorted(self.byzantine_slots)),
                mode=self.byzantine_mode))
        return tuple(out)

    def merge(self, other: "SessionFaultPlan") -> "SessionFaultPlan":
        _require(other.byzantine_mode == self.byzantine_mode
                 or not (self.byzantine_slots and other.byzantine_slots),
                 f"cannot merge fault plans with conflicting byzantine "
                 f"modes {self.byzantine_mode!r} vs "
                 f"{other.byzantine_mode!r} while both have byzantine "
                 "slots — one merged plan carries one mode; inject the "
                 "second mode as a separate session fault")
        mode = (self.byzantine_mode if self.byzantine_slots
                else other.byzantine_mode)
        crashed = tuple(sorted(set(self.crashed_slots)
                               | set(other.crashed_slots)))
        byz = tuple(sorted((set(self.byzantine_slots)
                            | set(other.byzantine_slots)) - set(crashed)))
        return SessionFaultPlan(crashed_slots=crashed, byzantine_slots=byz,
                                byzantine_mode=mode)

    @property
    def empty(self) -> bool:
        return not (self.crashed_slots or self.byzantine_slots)
