"""Zero-dependency observability: metrics registry, trace flight
recorder, exporters.

Counterpart of ``repro/obs``:

  * ``obs.metrics`` — typed counters/gauges/histograms behind one
    :class:`MetricsRegistry`; the executor / admission queue / facade
    counters all live here, and their dict views are read-only views
    over it.  The metric-name catalog and the ``svc.stats`` schema
    constants are defined here too.
  * ``obs.trace``   — :class:`TraceRecorder`, a ring buffer + JSONL
    sink of protocol-granularity events (per-batch, per-voted-round
    wire bytes fed by the exact engine byte account, stage spans, the
    retry/bisect/quarantine/breaker/chaos ladder).
  * ``obs.export``  — Prometheus-style text + human table renderers.

Everything is off the hot path (events are recorded host-side at
dispatch boundaries, never between the engine's launches) and
deterministic under an injected clock, so traced runs replay
byte-identically.  (The reference's ``record_func_round`` comes with the
secure-function slice.)
"""
from repro_torch.obs.metrics import (DEFAULT_REGISTRY, MetricsRegistry,
                                     SVC_STATS_DEPRECATED, SVC_STATS_KEYS,
                                     SVC_STATS_VERSION)
from repro_torch.obs.trace import TickClock, TraceRecorder, record_batch_trace
from repro_torch.obs.export import prometheus_text, stats_table

__all__ = [
    "DEFAULT_REGISTRY", "MetricsRegistry", "SVC_STATS_DEPRECATED",
    "SVC_STATS_KEYS", "SVC_STATS_VERSION", "TickClock", "TraceRecorder",
    "prometheus_text", "record_batch_trace", "stats_table",
]
