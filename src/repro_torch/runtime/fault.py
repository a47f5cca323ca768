"""Failure injection: at the training driver, and mid-session for the
multi-session aggregation service.

Counterpart of ``repro/runtime/fault.py``:

  * ``FailurePlan`` -- deterministic injected failures for the training
    driver (``launch/train.py``): a process crash at given steps
    (``InjectedCrash``, handled by restart from the last checkpoint) and
    Byzantine gradient corruption from a step on (handled inside the
    step by the paper's vote);
  * ``StepGuard`` -- a wall-clock deadline a step: a step that overruns
    raises ``StragglerTimeout``, so the driver can retry from the last
    checkpoint (per-member straggling is absorbed by the vote redundancy;
    this guards whole-step stalls);
  * ``SessionFaultPlan`` -- protocol slots that crash (their forwarded
    ring copies drop to zeros) or turn Byzantine (copies are flipped)
    while a service session is in flight.  Both lower to the vote path's
    ``ByzantineSpec`` -- a dropped or corrupted contribution is out-voted
    by the r-redundant majority, never retried.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.core.byzantine import ByzantineSpec


class InjectedCrash(RuntimeError):
    pass


class StragglerTimeout(RuntimeError):
    pass


class FaultPlanError(ValueError):
    """An invalid session fault plan (overlapping slot groups,
    conflicting Byzantine modes).  A real exception in the
    ``core.plan.ConfigError`` style — raised eagerly, survives
    ``python -O``, and the message says which slots to fix."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise FaultPlanError(msg)


@dataclasses.dataclass
class FailurePlan:
    crash_at_steps: tuple[int, ...] = ()
    byzantine_from_step: Optional[int] = None
    byzantine_ranks: tuple[int, ...] = ()

    def maybe_crash(self, step: int) -> None:
        if step in self.crash_at_steps:
            raise InjectedCrash(f"injected crash at step {step}")

    def byzantine_active(self, step: int) -> bool:
        return (self.byzantine_from_step is not None
                and step >= self.byzantine_from_step)


@dataclasses.dataclass
class StepGuard:
    deadline_s: float = 300.0

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and time.monotonic() - self.t0 > self.deadline_s:
            raise StragglerTimeout(
                f"step exceeded {self.deadline_s}s deadline")
        return False


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
