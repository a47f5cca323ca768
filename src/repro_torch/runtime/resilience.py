"""Retry/backoff, batch bisection, and the mesh->sim degrade ladder.

Counterpart of ``repro/runtime/resilience.py``, copied with its
validation (pure Python: nothing here touches a tensor).

The paper's protocol tolerates (1/2-eps)n malicious *nodes* per vote;
this module gives the *service runtime* the matching tolerance for
runtime faults — an executor exception, a stalled dispatch, a flaky
distributed backend — none of which the vote can absorb because they
kill the whole dispatch rather than corrupting one copy stream.

Three pieces, consumed by ``repro_torch.service.executor.BatchedExecutor``:

  * :class:`RetryPolicy` — per-(sub)batch attempt budget with
    exponential backoff and *deterministic* jitter (splitmix-derived
    from the unit counter, so a replayed failure schedule produces the
    same sleep sequence), an optional per-attempt wall deadline
    (:class:`DeadlineExceeded` makes a slow dispatch a retriable
    failure), and the ``bisect`` switch: when a batch exhausts its
    attempts, it is split in half and each half retried independently,
    so a single poison session is quarantined into the executor's
    dead-letter list instead of failing all S rows.
  * :class:`CircuitBreaker` — the degrade ladder for the distributed
    backend: after ``k`` consecutive mesh-transport failures the
    breaker opens and the executor falls back to the sim transport
    (bit-identical by construction — both run the same compiled
    ``AggPlan``), then re-probes the mesh once per ``cooloff_s`` until
    a probe succeeds and the breaker closes again.
  * :class:`DeadlineExceeded` — typed, retriable "too slow" failure.

Everything is injectable for tests: the policy's ``sleep`` and the
breaker's ``clock`` are plain callables.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

_MASK32 = 0xFFFFFFFF


def _mix32(a: int, b: int) -> int:
    """splitmix32-style mixer (the kernels' pad-key derivation idiom)
    -> uint32; used for deterministic backoff jitter."""
    x = (a ^ (b * 0x85EBCA6B)) & _MASK32
    x = (x + 0x9E3779B9) & _MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _MASK32
    return (x ^ (x >> 16)) & _MASK32


class DeadlineExceeded(RuntimeError):
    """A batch attempt ran past ``RetryPolicy.deadline_s`` — treated as
    a (retriable) runtime failure, exactly like a raising dispatch."""


class ResilienceError(ValueError):
    """An invalid resilience knob (matching ``core.plan.ConfigError``
    style: raised eagerly at construction, survives ``python -O``,
    message says which knob to fix)."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ResilienceError(msg)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + backoff for one executor (sub)batch.

    ``max_attempts`` counts dispatch attempts per retry *unit* (the
    whole batch first; after bisection, each sub-batch gets its own
    fresh budget).  Backoff before attempt a+1 is
    ``base_backoff_s * backoff_factor**(a-1)`` scaled by a
    deterministic jitter in ``[1-jitter, 1+jitter]`` derived from the
    (unit, attempt) pair — reproducible, but de-synchronized across
    units.  ``deadline_s`` bounds one attempt's wall time (checked
    after the dispatch completes, *before* any session reveals, so a
    too-slow attempt is retriable).  ``bisect=False`` restores the
    pre-resilience behavior of quarantining the whole batch at once."""
    max_attempts: int = 3
    base_backoff_s: float = 0.02
    backoff_factor: float = 2.0
    jitter: float = 0.25                  # fraction of the backoff
    deadline_s: Optional[float] = None    # per-attempt wall budget
    bisect: bool = True
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        _require(self.max_attempts >= 1,
                 f"max_attempts must be >= 1, got {self.max_attempts}")
        _require(self.base_backoff_s >= 0,
                 f"base_backoff_s must be >= 0, got {self.base_backoff_s}")
        _require(self.backoff_factor >= 1,
                 f"backoff_factor must be >= 1, got {self.backoff_factor}")
        _require(0 <= self.jitter <= 1,
                 f"jitter must be in [0, 1] (a backoff fraction), got "
                 f"{self.jitter}")
        _require(self.deadline_s is None or self.deadline_s > 0,
                 f"deadline_s must be > 0 (or None), got {self.deadline_s}")

    def backoff_s(self, attempt: int, salt: int = 0) -> float:
        """Sleep before attempt ``attempt + 1`` (attempt is 1-based).
        Deterministic: same (salt, attempt) -> same jittered delay."""
        base = self.base_backoff_s * self.backoff_factor ** (attempt - 1)
        if base <= 0:
            return 0.0
        u = _mix32(salt, attempt) / float(1 << 32)        # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))


@dataclasses.dataclass
class CircuitBreaker:
    """Mesh-transport circuit breaker (the degrade ladder).

    CLOSED: every batch dispatches on the primary (mesh) backend; each
    failure bumps ``consecutive_failures`` and the ``k``-th consecutive
    one trips the breaker OPEN.  OPEN: batches dispatch on the sim
    fallback (bit-identical by construction) until ``cooloff_s`` has
    elapsed, then ONE batch probes the mesh again — success closes the
    breaker, failure restarts the cooloff.  ``clock`` is injectable so
    tests drive the cooloff with logical time."""
    k: int = 3
    cooloff_s: float = 30.0
    clock: Callable[[], float] = time.monotonic
    # -- state --
    state: str = "closed"                 # closed | open
    consecutive_failures: int = 0
    opened_at: Optional[float] = None
    trips: int = 0                        # closed -> open transitions
    probes: int = 0                       # post-cooloff mesh re-probes

    def __post_init__(self):
        _require(self.k >= 1, f"breaker k must be >= 1, got {self.k}")
        _require(self.cooloff_s >= 0,
                 f"cooloff_s must be >= 0, got {self.cooloff_s}")

    def allow_primary(self) -> bool:
        """Should the next dispatch try the primary (mesh) backend?"""
        if self.state == "closed":
            return True
        if self.clock() - self.opened_at >= self.cooloff_s:
            self.probes += 1              # half-open: one probe dispatch
            return True
        return False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == "closed":
            if self.consecutive_failures >= self.k:
                self.state = "open"
                self.opened_at = self.clock()
                self.trips += 1
        else:                             # failed probe: restart cooloff
            self.opened_at = self.clock()

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == "open":
            self.state = "closed"
            self.opened_at = None

    def snapshot(self) -> dict:
        """Introspection view surfaced via ``svc.stats`` /
        ``SecureAggregator.stats()``."""
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips, "probes": self.probes}
