"""Structured request logging — one JSON line per request.

`JsonLogger` writes newline-delimited JSON records to a path or stdout
(`--log-json PATH|-` on the `repro_torch.serve` CLI). Each record is a
flat dict; `request_record` builds the canonical per-request
shape the tests pin:

    {"ts": <unix seconds>, "event": "request", "trace_id": ...,
     "token": <label>, "model": ..., "op": "run", "status": 200,
     "code": null | "E_*", "bucket": 4, "batch_size": 3,
     "queue_wait_ms": ..., "dispatch_ms": ..., "latency_ms": ...}

Lines are serialized outside the lock and written with a single
`write()` call in append mode, so concurrent writers (multi-worker
portals pointing at one file) interleave whole lines, never bytes.
Stdlib-only; a logger built with `path=None` is a no-op.
"""
from __future__ import annotations

import io
import json
import sys
import threading
import time
from typing import Optional

__all__ = ["JsonLogger", "request_record"]


def request_record(*, trace_id: str = "", token: str = "",
                   model: str = "", op: str = "run",
                   status: int = 200, code: Optional[str] = None,
                   **extra) -> dict:
    """Canonical per-request log record. Stage latencies / batch info
    arrive via `extra` (queue_wait_ms, dispatch_ms, latency_ms, bucket,
    batch_size, ...) so callers only pass what they measured."""
    rec = {"ts": round(time.time(), 6), "event": "request",
           "trace_id": trace_id, "token": token, "model": model,
           "op": op, "status": int(status), "code": code}
    rec.update(extra)
    return rec


class JsonLogger:
    """Newline-delimited JSON sink.

    `target` is a filesystem path, `"-"` for stdout, or None for a
    disabled logger (every `write()` is a cheap no-op — the off-by-
    default arm). Files are opened lazily in append mode and lines are
    flushed per record, so `tail -f` and crash-time forensics both
    work.
    """

    def __init__(self, target: Optional[str] = None):
        self.target = target
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None
        self.written = 0

    @property
    def enabled(self) -> bool:
        return self.target is not None

    def _handle(self):
        if self.target == "-":
            return sys.stdout
        if self._fh is None or self._fh.closed:
            self._fh = open(self.target, "a", encoding="utf-8")
        return self._fh

    def write(self, record: dict) -> None:
        if self.target is None:
            return
        line = json.dumps(record, separators=(",", ":"),
                          default=str) + "\n"
        with self._lock:
            fh = self._handle()
            fh.write(line)
            fh.flush()
            self.written += 1

    def request(self, **fields) -> None:
        """`write(request_record(**fields))` — the one-liner call sites
        use."""
        self.write(request_record(**fields))

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()

    def __repr__(self) -> str:
        state = self.target if self.enabled else "disabled"
        return f"JsonLogger({state}, written={self.written})"
