"""Request tracing — lightweight spans with trace-id propagation.

A *span* is one named, timed stage of one request's journey through
the stack (http parse -> bridge hop -> queue wait -> `run_lanes`
dispatch). Spans carry a shared `trace_id`, so every stage of one
request reassembles into a single trace no matter which process or
thread recorded it, and a `parent_id` giving the nesting.

Design constraints (this module is on the serving hot path):

  * stdlib-only — bridge WORKER processes import it (no numpy/jax);
  * off-is-free — a disabled `Tracer` hands out one shared no-op span
    and touches no lock, so telemetry can ship enabled-by-default and
    still be toggled off for A/B overhead runs;
  * bounded — finished spans land in a ring buffer (`deque(maxlen=)`),
    so an always-on server never grows without bound; exporters drain
    snapshots, they never block recording;
  * cross-process timestamps — `time.monotonic_ns()` is CLOCK_MONOTONIC,
    which on Linux is one system-wide clock: spans recorded in a
    front-end worker and in the dispatcher order correctly in one
    Perfetto view.

Export is Chrome trace-event JSON (the `{"traceEvents": [...]}` array
of `"ph": "X"` complete events), loadable in Perfetto / chrome://tracing;
`validate_chrome_trace` is the structural check CI's trace-export smoke
runs against generated files.
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "new_trace_id", "chrome_trace",
           "validate_chrome_trace"]

_ids = itertools.count(1)

# pid cached at import (one getpid syscall per Span otherwise — this
# module is on the serving hot path); refreshed after fork so a forked
# child never stamps its parent's pid
_pid = os.getpid()
_pid_hex = f"{_pid:x}"


# urandom-seeded PRNG for trace ids: os.urandom is a getrandom(2)
# syscall per call, and ids only need uniqueness, not secrecy
_rng = random.Random(os.urandom(16))


def _refresh_pid() -> None:
    global _pid, _pid_hex, _rng
    _pid = os.getpid()
    _pid_hex = f"{_pid:x}"
    _rng = random.Random(os.urandom(16))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)


def new_trace_id() -> str:
    """16-hex-char random trace id (propagated via `X-Trace-Id`)."""
    return f"{_rng.getrandbits(64):016x}"


def _new_span_id() -> str:
    return f"{_pid_hex}.{next(_ids):x}"


class Span:
    """One finished (or in-flight) stage. `start`/`end` are
    monotonic nanoseconds; `attrs` is a small flat dict of JSON-able
    values (model, bucket, batch size, ...)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "start", "end", "attrs", "pid", "tid",
                 "_tracer")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: int,
                 attrs: Optional[dict], tracer: Optional["Tracer"]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[int] = None
        # ownership transfer, not a copy — the caller's kwargs dict is
        # always fresh, and this runs per request on the serving path
        self.attrs: Dict = attrs if attrs is not None else {}
        self.pid = _pid
        self.tid = threading.get_ident()
        self._tracer = tracer

    # ------------------------------------------------------- lifecycle
    def finish(self, end: Optional[int] = None, **attrs) -> "Span":
        """Close the span (idempotent) and commit it to the tracer's
        ring buffer."""
        if self.end is None:
            self.end = time.monotonic_ns() if end is None else int(end)
            if attrs:
                self.attrs.update(attrs)
            if self._tracer is not None:
                self._tracer._commit(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.finish()

    # ------------------------------------------------------------ wire
    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.monotonic_ns()
        return (end - self.start) / 1e6

    def ctx(self) -> dict:
        """Propagation context for a child stage in another
        process/thread: `{"trace_id", "parent"}`."""
        return {"trace_id": self.trace_id, "parent": self.span_id}

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": self.end,
                "pid": self.pid, "tid": self.tid, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        s = cls(d["name"], d["trace_id"], d["span_id"],
                d.get("parent_id"), int(d["start"]),
                dict(d.get("attrs") or {}), None)
        s.end = None if d.get("end") is None else int(d["end"])
        s.pid = int(d.get("pid", 0))
        s.tid = int(d.get("tid", 0))
        return s

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"{self.duration_ms:.3f} ms)")


class _NullSpan:
    """The shared do-nothing span a disabled tracer hands out — every
    operation is a constant-time no-op, so `tracer.span(...)` costs one
    attribute check when telemetry is off."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    attrs: Dict = {}
    start = 0
    end = 0
    duration_ms = 0.0

    def finish(self, end=None, **attrs) -> "_NullSpan":
        return self

    def ctx(self) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded ring buffer of finished spans.

        tracer = Tracer(capacity=4096)
        with tracer.span("dispatch", trace_id=tid, model="demo") as sp:
            ...                                  # timed region
        events = chrome_trace(tracer.spans())    # Perfetto-loadable

    `on` is the runtime toggle: when False, `span()` returns the shared
    no-op span (no allocation, no lock). `record()` ingests spans
    serialized in ANOTHER process (the bridge piggybacks worker spans
    onto its frames so the dispatcher ring holds the whole trace).
    """

    def __init__(self, capacity: int = 4096, on: bool = True):
        self.capacity = int(capacity)
        self.on = bool(on)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0          # spans evicted by the ring bound

    # ---------------------------------------------------------- record
    def span(self, name: str, *, trace_id: Optional[str] = None,
             parent: Optional[str] = None, ctx: Optional[dict] = None,
             start: Optional[int] = None, **attrs):
        """Open a span. Pass `ctx=` (a `Span.ctx()` dict, e.g. decoded
        off a bridge frame) OR explicit `trace_id`/`parent`. `start`
        backdates the span (monotonic ns) for stages measured before
        their ids were known (http parse)."""
        if not self.on:
            return NULL_SPAN
        if ctx:
            trace_id = ctx.get("trace_id") or trace_id
            parent = ctx.get("parent") or parent
        return Span(name, trace_id or new_trace_id(), _new_span_id(),
                    parent,
                    time.monotonic_ns() if start is None else int(start),
                    attrs, self)

    def span_record(self, name: str, *, trace_id: Optional[str] = None,
                    parent: Optional[str] = None,
                    ctx: Optional[dict] = None,
                    start: int, end: int, **attrs) -> Optional[dict]:
        """Build one already-finished span as a PLAIN DICT (same wire
        shape as `Span.to_dict`) without committing it — the
        dispatcher's per-request fast path. Batch the dicts and commit
        them with ONE `record_batch` call per micro-batch; they are
        normalized to `Span`s lazily, at snapshot time."""
        if not self.on:
            return None
        if ctx:
            trace_id = ctx.get("trace_id") or trace_id
            parent = ctx.get("parent") or parent
        return {"name": name, "trace_id": trace_id or new_trace_id(),
                "span_id": _new_span_id(), "parent_id": parent,
                "start": start, "end": end, "pid": _pid,
                "tid": threading.get_ident(), "attrs": attrs}

    def record_batch(self, spans: List[dict]) -> None:
        """Commit a batch of finished span dicts under one lock."""
        if not self.on or not spans:
            return
        with self._lock:
            overflow = len(self._ring) + len(spans) - self._ring.maxlen
            if overflow > 0:
                self.dropped += overflow
            self._ring.extend(spans)

    def _commit(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def record(self, spans) -> None:
        """Ingest externally-recorded spans (dicts or `Span`s) into the
        ring — the dispatcher side of worker-span forwarding."""
        if not self.on:
            return
        with self._lock:
            for s in spans:
                if isinstance(s, dict):
                    s = Span.from_dict(s)
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(s)

    # ---------------------------------------------------------- export
    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        """Snapshot of the ring (optionally one trace), oldest first.
        `record_batch` dicts are normalized to `Span`s here — export
        pays the object cost, not the serving hot path."""
        with self._lock:
            out = [s if isinstance(s, Span) else Span.from_dict(s)
                   for s in self._ring]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def stats(self) -> dict:
        with self._lock:
            return {"spans": len(self._ring),
                    "capacity": self.capacity,
                    "dropped": self.dropped, "on": self.on}


# ------------------------------------------------------- chrome export
def chrome_trace(spans) -> dict:
    """Spans -> Chrome trace-event JSON (Perfetto / chrome://tracing).
    Each span becomes one complete ("ph": "X") event; `ts`/`dur` are
    microseconds on the shared monotonic clock, so worker and
    dispatcher tracks align in one view. The trace id and span ids ride
    in `args` (Perfetto shows them in the event detail pane)."""
    events = []
    for s in spans:
        if isinstance(s, dict):
            s = Span.from_dict(s)
        if s.end is None:
            continue
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update(s.attrs)
        events.append({"name": s.name, "cat": "obs", "ph": "X",
                       "ts": s.start / 1e3,
                       "dur": max(s.end - s.start, 0) / 1e3,
                       "pid": s.pid, "tid": s.tid, "args": args})
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj) -> List[str]:
    """Structural check of a Chrome trace-event JSON object. Returns a
    list of problems (empty = valid) — the CI trace-export smoke fails
    on any. Checks the keys/types the format requires for "X" events
    plus this exporter's own contract (trace_id in args, dur >= 0)."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with 'traceEvents'"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        for key, types in (("name", str), ("ph", str),
                           ("ts", (int, float)), ("pid", int),
                           ("tid", int)):
            if not isinstance(e.get(key), types):
                problems.append(f"{where}: missing/bad {key!r}")
        if e.get("ph") == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: 'X' event needs dur >= 0")
        args = e.get("args", {})
        if not isinstance(args, dict) or not args.get("trace_id"):
            problems.append(f"{where}: args.trace_id missing")
    return problems
