"""Observability subsystem: request tracing, unified metrics,
structured logging — the port's copy of `repro/obs/`, with the same
metric families, span names and log schema, so a scrape or trace of
either package's server reads the same.

Stdlib-only by design — bridge worker processes (which must stay
numpy/jax-free) import this package, and so does the serving tier.
See `trace` (spans + Chrome trace export), `metrics` (Prometheus
registry), `logs` (JSON request log), `telemetry` (the bundle tiers
thread through).
"""
from .logs import JsonLogger, request_record
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      log_buckets, merge_snapshots, parse_prometheus,
                      render_snapshot, snapshot_by_worker,
                      snapshot_with_label)
from .telemetry import Telemetry
from .trace import (Span, Tracer, chrome_trace, new_trace_id,
                    validate_chrome_trace)

__all__ = [
    "Span", "Tracer", "new_trace_id", "chrome_trace",
    "validate_chrome_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
    "merge_snapshots", "render_snapshot", "snapshot_by_worker",
    "snapshot_with_label", "parse_prometheus",
    "JsonLogger", "request_record",
    "Telemetry",
]
