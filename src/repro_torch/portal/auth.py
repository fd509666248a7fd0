"""Bearer-token authentication and per-token quotas — the port's copy
of `repro/portal/auth.py`.

The portal's admission control, enforced in the front-end worker
BEFORE anything touches the dispatcher:

  * authentication — `Authorization: Bearer <token>` against a static
    token table (401 `E_AUTH` otherwise; a portal constructed with
    `tokens=None` is open, the local-demo mode);
  * request rate — a token bucket per token (`rate` req/s, `burst`
    capacity): an empty bucket is a 429 `E_QUOTA_RATE` whose
    Retry-After says when the next token accrues;
  * concurrency — at most `max_inflight` requests of one token
    simultaneously in flight across run/reconfigure/stream windows
    (429 `E_QUOTA_INFLIGHT`): one client cannot occupy every lane of
    the micro-batch by pipelining.

Per-token counters (admitted / rejected / in flight) surface as
`repro_token_*` series in the Prometheus `GET /metrics` exposition
(and under `clients` in the legacy `GET /metrics?format=json` view).
Stdlib-only, so bridge workers import it without torch or numpy.

Multi-worker scope: with `--workers N` each SO_REUSEPORT worker
process builds its OWN Authenticator from `spec()`, so quota
ENFORCEMENT is per worker — a client whose connections the kernel
spreads across workers can reach up to N x the configured rate/burst/
max_inflight. REPORTING, however, is global: every worker forwards its
metrics snapshot over the bridge, so `repro_token_admitted_total` /
`repro_token_rejected_total` on `/metrics` are bridge-aggregated
totals from any worker you ask, with the per-worker split preserved
under `repro_token_*_by_worker{worker="<pid>"}`. (Only the legacy
`?format=json` `clients` block remains worker-local.) Size quotas for
the worker count (e.g. rate / N for a hard global rate), or run
`--workers 0` when exact global enforcement matters; the ingestion
backpressure (503 E_BACKPRESSURE) is always global because the
DoubleBuffer lives in the single dispatcher process.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.portal.errors import PortalError

__all__ = ["TokenQuota", "TokenState", "Authenticator"]


@dataclass
class TokenQuota:
    """Quota attached to one bearer token. `name` is the label used in
    metrics (never the secret); defaults to a truncated token prefix."""
    rate: float = 50.0          # sustained requests/second
    burst: int = 16             # bucket capacity (instantaneous burst)
    max_inflight: int = 8       # concurrent in-flight requests
    name: Optional[str] = None


class TokenState:
    """Runtime state of one token: its bucket level, in-flight count,
    and counters. All mutation happens under the authenticator lock."""

    def __init__(self, token: str, quota: TokenQuota):
        self.token = token
        self.quota = quota
        self.name = quota.name or (token[:4] + "…")
        self.level = float(quota.burst)     # tokens currently in bucket
        self.last = time.monotonic()
        self.inflight = 0
        self.admitted = 0
        self.rejected_rate = 0
        self.rejected_inflight = 0

    def _refill(self, now: float) -> None:
        self.level = min(float(self.quota.burst),
                         self.level + (now - self.last)
                         * self.quota.rate)
        self.last = now

    def metrics(self) -> dict:
        return {"admitted": self.admitted, "inflight": self.inflight,
                "rejected_rate": self.rejected_rate,
                "rejected_inflight": self.rejected_inflight,
                "rate": self.quota.rate, "burst": self.quota.burst,
                "max_inflight": self.quota.max_inflight}


class _Admission:
    """Context manager pairing one admitted request with its in-flight
    release."""

    def __init__(self, auth: "Authenticator",
                 state: Optional[TokenState]):
        self._auth, self._state = auth, state

    def __enter__(self) -> "_Admission":
        return self

    def __exit__(self, *exc) -> None:
        if self._state is not None:
            with self._auth._lock:
                self._state.inflight -= 1


class Authenticator:
    """Token table + quota enforcement. `tokens=None` disables auth
    entirely (open portal); `{}` locks everyone out."""

    def __init__(self, tokens: Optional[Dict[str, TokenQuota]] = None):
        self._lock = threading.Lock()
        self._states: Optional[Dict[str, TokenState]] = None
        if tokens is not None:
            self._states = {t: TokenState(t, q)
                            for t, q in tokens.items()}

    @property
    def enabled(self) -> bool:
        return self._states is not None

    # ------------------------------------------------------ wire format
    def spec(self) -> Optional[dict]:
        """JSON-serializable token table, for handing to spawned bridge
        workers (each worker enforces quotas for its own connections)."""
        if self._states is None:
            return None
        return {t: {"rate": s.quota.rate, "burst": s.quota.burst,
                    "max_inflight": s.quota.max_inflight,
                    "name": s.name}
                for t, s in self._states.items()}

    @classmethod
    def from_spec(cls, spec: Optional[dict]) -> "Authenticator":
        if spec is None:
            return cls(None)
        return cls({t: TokenQuota(**q) for t, q in spec.items()})

    # ------------------------------------------------------- admission
    def authenticate(self, headers: Dict[str, str]) \
            -> Optional[TokenState]:
        """Resolve the request's token (401 on missing/unknown).
        Returns None when auth is disabled."""
        if self._states is None:
            return None
        raw = headers.get("authorization", "")
        scheme, _, token = raw.partition(" ")
        if scheme.lower() != "bearer" or not token.strip():
            raise PortalError(
                401, "E_AUTH",
                "missing bearer token: send 'Authorization: Bearer "
                "<token>'")
        state = self._states.get(token.strip())
        if state is None:
            raise PortalError(401, "E_AUTH", "unknown bearer token")
        return state

    def admit(self, state: Optional[TokenState]) -> _Admission:
        """Charge one request against the token's quotas (429 with
        Retry-After when over), returning the context manager that
        releases the in-flight slot."""
        if state is None:
            return _Admission(self, None)
        now = time.monotonic()
        with self._lock:
            state._refill(now)
            if state.level < 1.0:
                state.rejected_rate += 1
                wait = (1.0 - state.level) / max(state.quota.rate, 1e-9)
                raise PortalError(
                    429, "E_QUOTA_RATE",
                    f"token {state.name} is over its "
                    f"{state.quota.rate:g} req/s rate "
                    f"(burst {state.quota.burst})",
                    retry_after=wait)
            if state.inflight >= state.quota.max_inflight:
                state.rejected_inflight += 1
                raise PortalError(
                    429, "E_QUOTA_INFLIGHT",
                    f"token {state.name} already has {state.inflight} "
                    f"requests in flight (max "
                    f"{state.quota.max_inflight})",
                    retry_after=0.05)
            state.level -= 1.0
            state.inflight += 1
            state.admitted += 1
        return _Admission(self, state)

    def metrics(self) -> dict:
        """Per-token counters keyed by the metric label (never the
        secret)."""
        if self._states is None:
            return {}
        with self._lock:
            return {s.name: s.metrics() for s in self._states.values()}
