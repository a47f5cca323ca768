"""Exporters: registry snapshot -> Prometheus-style text or a human
table; recorder ring -> JSONL.  Counterpart of ``repro/obs/export.py``: the
same exposition, byte for byte.  Stdlib only — the JSONL streaming
itself lives on :class:`~repro_torch.obs.trace.TraceRecorder` (the
``sink``), this module renders the *pull* side."""
from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry, render_series


def _prom_name(series: str) -> str:
    """``executor.fn_cache.hits{k=v}`` -> ``repro_executor_fn_cache_hits
    {k="v"}`` (Prometheus exposition conventions: underscores, quoted
    label values, a namespace prefix)."""
    name, _, labels = series.partition("{")
    name = "repro_" + name.replace(".", "_")
    if not labels:
        return name
    quoted = ",".join(
        f'{k}="{v}"' for k, v in
        (item.split("=", 1) for item in labels[:-1].split(",")))
    return f"{name}{{{quoted}}}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus-style exposition of every series.  Counters/gauges
    are one sample; histograms expand to ``_count`` / ``_sum`` /
    ``_min`` / ``_max`` samples (summary-style — the registry keeps no
    buckets)."""
    snap = registry.snapshot()
    lines = []
    for series, v in snap["counters"].items():
        lines.append(f"{_prom_name(series)} {v}")
    for series, v in snap["gauges"].items():
        lines.append(f"{_prom_name(series)} {v}")
    for series, h in snap["histograms"].items():
        name, _, labels = _prom_name(series).partition("{")
        labels = "{" + labels if labels else ""
        lines.append(f"{name}_count{labels} {h['count']}")
        lines.append(f"{name}_sum{labels} {h['total']}")
        if h["count"]:
            lines.append(f"{name}_min{labels} {h['min']}")
            lines.append(f"{name}_max{labels} {h['max']}")
    return "\n".join(lines) + "\n"


def stats_table(registry: MetricsRegistry, title: str = "metrics") -> str:
    """Aligned human-readable table of the registry."""
    snap = registry.snapshot()
    rows = []
    for series, v in snap["counters"].items():
        rows.append((series, f"{v}"))
    for series, v in snap["gauges"].items():
        rows.append((series, f"{v:.6g}"))
    for series, h in snap["histograms"].items():
        if h["count"]:
            rows.append((series,
                         f"n={h['count']} mean={h['mean'] * 1e6:.0f}us "
                         f"max={h['max'] * 1e6:.0f}us"))
        else:
            rows.append((series, "n=0"))
    if not rows:
        return f"-- {title}: (no series) --"
    width = max(len(name) for name, _ in rows)
    body = "\n".join(f"  {name:<{width}}  {val}" for name, val in rows)
    return f"-- {title} --\n{body}"


__all__ = ["prometheus_text", "stats_table", "render_series"]
