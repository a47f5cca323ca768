"""Multi-session secure-aggregation service.

Counterpart of ``repro/service``.  Three layers on top of the batched
engine path (the three CUDA kernels on the card):

  * ``session``  — per-query lifecycle (open -> contribute -> seal ->
    aggregate -> reveal) with per-session pad key / offset /
    quantization / redundancy;
  * ``executor`` — packs S compatible sessions into one (S, T) batched
    pass, streamed through pinned host buffers and CUDA events, plus the
    admission queue with size/age watermarks;
  * ``epochs``   — overlay churn epochs: sessions stay pinned to their
    epoch's committee snapshot, departures become vote-absorbed crashes.

plus the resilience layer from ``runtime.resilience`` /
``runtime.chaos``: retry/backoff with batch bisection and a dead-letter
quarantine in the executor, session deadlines and load shedding in the
admission queue, and the mesh->sim circuit-breaker degrade ladder.

:class:`AggregationService` is the facade gluing them together.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from repro_torch.core.plan import plan_cache_stats
from repro_torch.runtime.resilience import CircuitBreaker, RetryPolicy
from repro_torch.service.epochs import EpochManager, EpochSnapshot
from repro_torch.service.executor import (AdmissionQueue, BatchedExecutor,
                                          BatchingConfig, StreamConfig,
                                          _AgreedClock)
from repro_torch.service.session import (LifecycleError, Session,
                                         SessionParams, SessionState,
                                         derive_session_seed)

__all__ = [
    "AdmissionQueue", "AggregationService", "BatchedExecutor",
    "BatchingConfig", "CircuitBreaker", "EpochManager", "EpochSnapshot",
    "LifecycleError", "RetryPolicy", "Session", "SessionParams",
    "SessionState", "StreamConfig", "derive_session_seed",
]


class AggregationService:
    """Front door of the aggregation service.

    ``open`` admits a new session (pinned to the current overlay epoch
    when an :class:`EpochManager` is attached), ``seal`` hands it to the
    admission queue, ``pump`` flushes ready batches through the batched
    executor.  With no epoch manager the service runs a static network
    of ``default_params.n_nodes`` slots.  ``device`` is where batches run
    (``None``: the card; on a mesh, this rank's device).

    On the mesh every rank runs its own copy of the service over the
    same calls; the clock that ``open`` / ``seal`` / ``pump`` read when
    no ``now`` is passed is then rank 0's, so session deadlines and the
    age watermark decide alike on every rank.
    """

    def __init__(self, default_params: SessionParams,
                 epochs: Optional[EpochManager] = None,
                 batching: BatchingConfig = BatchingConfig(),
                 kernel_impl: Optional[str] = None,
                 base_seed: int = 0x5EC0_A66,
                 transport: str = "sim", mesh=None,
                 dp_axes: Sequence[str] = ("data",),
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 chaos=None, metrics=None, recorder=None,
                 stream: Optional[StreamConfig] = None, *, device=None):
        if epochs is not None:
            snap = epochs.current()
            assert snap.n_nodes == default_params.n_nodes, \
                (snap.n_nodes, default_params.n_nodes)
        self.default_params = default_params
        self.epochs = epochs
        self.base_seed = base_seed
        self.executor = BatchedExecutor(kernel_impl=kernel_impl,
                                        transport=transport, mesh=mesh,
                                        dp_axes=dp_axes, retry=retry,
                                        breaker=breaker, chaos=chaos,
                                        metrics=metrics, recorder=recorder,
                                        stream=stream, device=device)
        agree = self.executor._agree
        self._clock = (time.monotonic if agree is None
                       else _AgreedClock(time.monotonic, agree))
        self.queue = AdmissionQueue(self.executor, batching,
                                    pre_execute=self._merge_epoch_faults,
                                    clock=self._clock)
        self._sessions: dict[int, Session] = {}
        self._next_sid = 0

    @property
    def metrics(self):
        """The service's :class:`~repro_torch.obs.MetricsRegistry` (shared by
        the executor and the admission queue)."""
        return self.executor.metrics

    @property
    def recorder(self):
        """The attached flight recorder, or None."""
        return self.executor.recorder

    # -- epoch integration --------------------------------------------------
    def _merge_epoch_faults(self, batch: Sequence[Session]) -> None:
        """Right before a batch executes, crash-inject every pinned slot
        whose overlay node departed after the session's epoch snapshot."""
        if self.epochs is None:
            return
        for s in batch:
            if s.epoch is not None:
                plan = self.epochs.departed_plan(s.epoch)
                if not plan.empty:
                    s.inject_fault(plan)

    # -- lifecycle ----------------------------------------------------------
    # open/seal/pump share one clock: ``now`` defaults to time.monotonic()
    # (rank 0's on a mesh) in all three, so the age watermark is
    # meaningful out of the box; tests pass explicit ticks instead.
    def open(self, params: Optional[SessionParams] = None,
             now: Optional[float] = None,
             ttl: Optional[float] = None) -> Session:
        """Admit a new session.  ``ttl`` (defaulting to
        ``BatchingConfig.session_ttl``) sets the session deadline:
        ``expires_at = now + ttl`` on the open/seal/pump clock — a
        session still queued past it moves to EXPIRED at pump time."""
        now = self._clock() if now is None else now
        params = params or self.default_params
        sid = self._next_sid
        self._next_sid += 1
        epoch = self.epochs.current() if self.epochs is not None else None
        if epoch is not None:
            assert epoch.n_nodes == params.n_nodes, \
                "session shape must match the epoch committee layout"
        ttl = self.queue.batching.session_ttl if ttl is None else ttl
        s = Session(sid, params, derive_session_seed(self.base_seed, sid),
                    epoch=epoch, opened_at=now,
                    expires_at=None if ttl is None else now + ttl)
        self._sessions[sid] = s
        return s

    def get(self, sid: int) -> Session:
        return self._sessions[sid]

    def contribute(self, sid: int, slot: int, value) -> None:
        self._sessions[sid].contribute(slot, value)

    def seal(self, sid: int, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        s = self._sessions[sid]
        s.seal(now)
        self.queue.submit(s, now=now)

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Flush ready batches; returns number of sessions revealed."""
        return self.queue.pump(self._clock() if now is None else now,
                               force=force)

    def drain(self) -> int:
        """Force-flush everything pending (shutdown / end of load)."""
        return self.queue.pump(force=True)

    def result(self, sid: int, evict: bool = False) -> torch.Tensor:
        """Revealed aggregate of session ``sid``.  ``evict=True`` also
        forgets the session — a long-lived service should evict (or call
        :meth:`evict` on FAILED sessions) to keep memory bounded."""
        out = self._sessions[sid].result
        if evict:
            del self._sessions[sid]
        return out

    def evict(self, sid: int) -> None:
        """Forget a terminal (REVEALED/FAILED/EXPIRED) session."""
        s = self._sessions[sid]
        if s.state not in (SessionState.REVEALED, SessionState.FAILED,
                           SessionState.EXPIRED):
            raise LifecycleError(
                f"only terminal sessions can be evicted, got {s!r}")
        del self._sessions[sid]

    # -- introspection ------------------------------------------------------
    @property
    def stats(self) -> dict:
        """One documented stats schema (``obs.metrics.SVC_STATS_KEYS``,
        version ``SVC_STATS_VERSION``), a view over the service's
        metrics registry:

          * ``sessions`` — ``opened`` / ``run`` / ``failed`` /
            ``pending`` counts;
          * ``batches``  — ``run`` count + realized ``sizes``;
          * ``queue``    — the admission-queue account
            (``AdmissionQueue.metrics``: flush reasons, age watermarks,
            starved/expired/shed/dropped);
          * ``caches``   — ``executor`` (batch executables) and ``plan``
            (shared memo) hit/miss/size;
          * ``resilience`` — the retry/bisect/quarantine/degrade
            account (``BatchedExecutor.resilience``);
          * ``wire``     — cumulative modeled wire bytes of executed
            batches (== the engine's trace-time account);
          * ``epoch``    — current churn epoch (None without one);
          * ``metrics``  — the raw registry snapshot;
          * ``schema``   — this schema's version.

        Schema version 2, as in the reference."""
        from repro_torch.obs.metrics import SVC_STATS_VERSION
        queue = self.queue.metrics
        caches = {"executor": self.executor.cache_stats,
                  "plan": plan_cache_stats()}
        sessions = {
            "opened": self._next_sid,
            "run": self.executor.sessions_run,
            "failed": sum(s.state is SessionState.FAILED
                          for s in self._sessions.values()),
            "pending": self.queue.depth(),
        }
        batches = {"run": self.executor.batches_run,
                   "sizes": tuple(self.queue.batch_sizes)}
        out = {
            "schema": SVC_STATS_VERSION,
            "sessions": sessions,
            "batches": batches,
            "queue": queue,
            "caches": caches,
            "resilience": self.executor.resilience,
            "wire": {"bytes_sent": self.executor.wire_bytes},
            "epoch": (self.epochs.current().epoch
                      if self.epochs is not None else None),
            "metrics": self.metrics.snapshot(),
        }
        return out
