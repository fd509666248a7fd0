"""`Telemetry` — the bundle every tier threads through.

One object carries the tracer, metrics registry, and JSON logger so
call sites take a single `telemetry=` argument instead of three. The
`on` property toggles tracer + registry together at runtime, which is
how the overhead benches A/B the same warmed server (no recompiles, no
process restarts) between obs-on and obs-off.

`Telemetry()` is cheap to build, so tiers that receive `telemetry=None`
construct an enabled default — telemetry is always AVAILABLE; only its
cost profile changes with the toggle.
"""
from __future__ import annotations

from typing import Optional

from .logs import JsonLogger
from .metrics import MetricsRegistry
from .trace import Tracer

__all__ = ["Telemetry"]


class Telemetry:
    """Tracer + metrics registry + structured logger, one handle.

        tel = Telemetry(log_json="-")          # logs to stdout
        with tel.tracer.span("dispatch", trace_id=tid) as sp: ...
        tel.metrics.counter("repro_requests_total", "...").inc()
        tel.log.request(trace_id=tid, status=200, ...)
        tel.on = False                         # obs-off A/B arm
    """

    def __init__(self, *, on: bool = True,
                 trace_capacity: int = 4096,
                 log_json: Optional[str] = None):
        self.tracer = Tracer(capacity=trace_capacity, on=on)
        self.metrics = MetricsRegistry(on=on)
        self.log = JsonLogger(log_json)

    @property
    def on(self) -> bool:
        return self.tracer.on

    @on.setter
    def on(self, value: bool) -> None:
        value = bool(value)
        self.tracer.on = value
        self.metrics.on = value

    @classmethod
    def disabled(cls) -> "Telemetry":
        """A telemetry bundle with tracing + metrics off and no log
        sink — the cheapest configuration, for overhead baselines."""
        return cls(on=False)

    def stats(self) -> dict:
        return {"on": self.on, "tracer": self.tracer.stats(),
                "log_written": self.log.written}

    def __repr__(self) -> str:
        return f"Telemetry(on={self.on})"
