"""Structured portal errors — the port's copy of `repro/portal/errors.py`,
the same codes and JSON bodies.

Every failure a client can observe over the wire is a `PortalError`:
an HTTP status, a stable machine-readable `code` (the analyzer's E_*
namespace — compile-time diagnostics and transport-time failures speak
one format), a human `message`, and optionally a Retry-After hint
(429/503) and the analyzer's structured findings (400). The JSON body
is the same whether the error was raised in this process or carried
over the worker bridge.

This module is dependency-free on purpose: the bridge WORKER processes
import it without pulling in torch or numpy.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["PortalError"]


class PortalError(Exception):
    """One wire-visible failure. `to_body()` is the canonical JSON
    body; `headers()` contributes Retry-After when a hint is set."""

    def __init__(self, status: int, code: str, message: str, *,
                 retry_after: Optional[float] = None,
                 findings: Optional[dict] = None):
        super().__init__(message)
        self.status = int(status)
        self.code = str(code)
        self.message = str(message)
        self.retry_after = retry_after
        self.findings = findings

    def to_body(self) -> dict:
        err = {"status": self.status, "code": self.code,
               "message": self.message}
        if self.retry_after is not None:
            err["retry_after_s"] = round(float(self.retry_after), 3)
        if self.findings is not None:
            err["findings"] = self.findings
        return {"error": err}

    def headers(self) -> dict:
        if self.retry_after is None:
            return {}
        # Retry-After is delta-seconds, integral, at least 1 — the
        # JSON body carries the precise float hint
        return {"Retry-After": str(max(1, int(round(self.retry_after))))}

    @classmethod
    def from_body(cls, body: dict) -> "PortalError":
        """Rebuild from `to_body()` output (the bridge's error
        round-trip)."""
        err = body.get("error", body)
        return cls(int(err.get("status", 500)),
                   err.get("code", "E_INTERNAL"),
                   err.get("message", "internal error"),
                   retry_after=err.get("retry_after_s"),
                   findings=err.get("findings"))

    def __repr__(self) -> str:
        return (f"PortalError(status={self.status}, code={self.code!r},"
                f" message={self.message!r})")
