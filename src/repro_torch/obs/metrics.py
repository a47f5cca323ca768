"""Process-wide registry of typed metrics (counters / gauges /
histograms) — the one place the system's operational counters live.

Counterpart of ``repro/obs/metrics.py``, with the same series names and
stats-schema constants, so the two packages' registries render the same
Prometheus text for the same run.  Stdlib only.

PR 6 left telemetry fragmented across three ad-hoc dicts
(``executor.resilience``, ``AdmissionQueue.metrics``,
``plan_cache_stats``) with inconsistent key styles and no export path.
This module unifies them: the executor, the admission queue, and the
``SecureAggregator`` facade all allocate their counters from a
:class:`MetricsRegistry`, and their legacy dict views (``svc.stats``,
``queue.metrics``, ``executor.resilience``) become *read-only views over
the registry* — same keys, same values, one source of truth that
``obs.export`` can render as Prometheus text or a human table.

Design constraints, in order:

  * **off-hot-path** — a metric handle is allocated once
    (``registry.counter(name, **labels)``) and updated with a plain
    attribute add (``c.inc()``); no dict lookup, no string formatting,
    no clock read on the update path.  ``benchmarks/obs_overhead.py``
    pins the cost;
  * **deterministic** — the registry clock is injectable
    (``clock=...``), and nothing here ever calls ``time`` unless asked
    to, so byte-identical replay of a traced run stays byte-identical;
  * **zero dependencies** — stdlib only.

Series are keyed by (name, sorted label items); ``snapshot()`` returns
plain nested dicts (the ``svc.stats["metrics"]`` payload), ``reset()``
zeroes every series in place (handles stay valid).  A registry built
with ``enabled=False`` hands out no-op handles — the baseline the
overhead bench compares against.

Metric-name and stats-schema constants live here (not in the service)
so the docs, the exporters, and the tests pin one vocabulary.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# Metric name catalog (the README "Observability" table renders this)
# ---------------------------------------------------------------------------

# executor
M_BATCHES = "executor.batches_run"
M_SESSIONS = "executor.sessions_run"
M_FN_HITS = "executor.fn_cache.hits"
M_FN_MISSES = "executor.fn_cache.misses"
M_FN_BUCKET_HITS = "executor.fn_cache.bucket_hits"  # ran on a larger-S
#   compiled shape bucket while the exact shape warmed in background
M_RETRIES = "executor.retries"
M_BISECTIONS = "executor.bisections"
M_QUARANTINED = "executor.quarantined"
M_DEADLINE_HITS = "executor.deadline_hits"
M_DEGRADED = "executor.degraded_batches"
M_WIRE_BYTES = "executor.wire_bytes"          # modeled == engine account
# streaming pipeline: high-watermark of concurrently in-flight batch
# slots (1 = sequential; == StreamConfig.depth when overlap happened)
G_PIPELINE_DEPTH = "executor.pipeline_depth"
# admission queue
M_FLUSHES = "queue.flushes"                   # labeled reason=size|age|...
M_MAX_QUEUE_AGE = "queue.max_queue_age"       # gauge (track_max)
M_STARVED = "queue.starved_sessions"
M_EXPIRED = "queue.expired_sessions"
M_SHED = "queue.shed_sessions"
M_DROPPED = "queue.dropped_sessions"
# facade (one-shot verbs)
M_FACADE_FN_HITS = "facade.fn_cache.hits"
M_FACADE_FN_MISSES = "facade.fn_cache.misses"
M_FACADE_BYTES = "facade.bytes_sent"
# self-tuning planner (the tuner slice)
M_TUNER_DECISIONS = "tuner.decisions"        # fresh grid scans
M_TUNER_CACHE_HITS = "tuner.cache_hits"      # decision-memo hits
M_TUNER_PROBES = "tuner.probes"              # measured micro-dispatches
# per-batch stage timing (histogram, labeled stage=...).  Sequential
# dispatch times pack + dispatch + the blocking device sync as one
# ``device_dispatch`` span; the streaming executor splits it:
# ``pack_overlap`` is the host-side pack + the non-blocking copy and
# launches (overlapped with the previous batch's device work on the
# stream) and ``device_dispatch`` becomes the blocking wait at reveal.
H_STAGE = "stage.seconds"
STAGES = ("admission_wait", "plan_compile", "device_dispatch", "reveal",
          "pack_overlap")

# ---------------------------------------------------------------------------
# svc.stats schema (pinned by tests/test_torch_service.py)
# ---------------------------------------------------------------------------

SVC_STATS_VERSION = 2
# canonical nested shape of AggregationService.stats
SVC_STATS_KEYS = ("schema", "sessions", "batches", "queue", "caches",
                  "resilience", "wire", "epoch", "metrics")
# The pre-PR-7 flat top-level aliases ("sessions_run", "batch_sizes",
# ...) were kept one release and removed in PR 8 (schema version 2):
# read the nested keys instead (st["sessions"]["run"], ...).
SVC_STATS_DEPRECATED: tuple = ()


# ---------------------------------------------------------------------------
# Typed series
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic int counter.  ``inc`` is the hot path: one add."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-value gauge with a ``track_max`` high-watermark helper."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def track_max(self, v: float) -> None:
        if v > self.value:
            self.value = v

    def reset(self) -> None:
        self.value = 0.0

    def snapshot(self):
        return self.value


class Histogram:
    """Count/total/min/max summary (no buckets — the exporters derive
    the mean; full distributions belong in the trace, not the registry)."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.reset()

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def snapshot(self):
        out = {"count": self.count, "total": self.total}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.total / self.count
        return out


class _Noop:
    """Handle handed out by a disabled registry: every update is a
    no-op, every read is zero (the overhead-bench baseline)."""

    __slots__ = ()
    value = 0
    count = 0
    total = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def track_max(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def reset(self) -> None:
        pass

    def snapshot(self):
        return 0


_NOOP = _Noop()


def _series_key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def render_series(name: str, labels: tuple) -> str:
    """(name, sorted label items) -> ``name{k=v,...}`` (Prometheus-ish;
    the snapshot/export key format)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Allocate-once, update-cheap metric series.

    ``counter`` / ``gauge`` / ``histogram`` return the SAME handle for
    the same (name, labels) — callers keep the handle and update it
    directly.  ``clock`` is carried for exporters that want timestamps;
    nothing on the update path reads it."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True):
        self.clock = clock
        self.enabled = enabled
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    def _get(self, store: dict, cls, name: str, labels: dict):
        if not self.enabled:
            return _NOOP
        key = _series_key(name, labels)
        s = store.get(key)
        if s is None:
            s = store[key] = cls()
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def snapshot(self) -> dict:
        """Plain-dict view of every series: ``{"counters": {...},
        "gauges": {...}, "histograms": {...}}`` keyed by the rendered
        series name."""
        return {
            "counters": {render_series(*k): s.snapshot()
                         for k, s in sorted(self._counters.items())},
            "gauges": {render_series(*k): s.snapshot()
                       for k, s in sorted(self._gauges.items())},
            "histograms": {render_series(*k): s.snapshot()
                           for k, s in sorted(self._histograms.items())},
        }

    def reset(self) -> None:
        """Zero every series in place — existing handles stay live."""
        for store in (self._counters, self._gauges, self._histograms):
            for s in store.values():
                s.reset()


# The shared process default: explicit opt-in; library objects build
# their OWN registry
# by default so test pins on exact counts never see cross-talk.
DEFAULT_REGISTRY = MetricsRegistry()


def registry_or_default(
        metrics: Optional[MetricsRegistry]) -> MetricsRegistry:
    """The normalization every obs-aware constructor applies: an
    explicit registry is shared, ``None`` means a fresh private one."""
    return metrics if metrics is not None else MetricsRegistry()
