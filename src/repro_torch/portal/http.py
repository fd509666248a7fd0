"""Minimal HTTP/1.1 front end on `asyncio` streams — stdlib only; the
port's copy of `repro/portal/http.py`, the same routes and bodies.

The transport half of the paper's web portal: a deliberately small
HTTP server (no framework, no threads — one coroutine per connection,
keep-alive, Content-Length bodies) that exposes the serving tier over
the network. Every handler goes through the same three steps —
authenticate, charge quota, forward to the gateway — and every failure
is a structured `PortalError` JSON body.

Routes (all bodies JSON):

  GET  /healthz                         liveness + resident models
  GET  /metrics                         server stats + per-token counters
  POST /v1/{model}/run                  one spike window -> spikes/digest
  POST /v1/{model}/reconfigure          write_synapses barrier
  POST /v1/{model}/session              open a resident-lane session
  GET  /v1/{model}/session/{id}         session membrane digest
  POST /v1/{model}/session/{id}/reset   lane back to V=0
  DELETE /v1/{model}/session/{id}       release the lane
  GET  /v1/{model}/stream               RFC 6455 websocket upgrade
                                        (streaming session; portal.ws)

The `gateway` is duck-typed (`LocalGateway` in-process over a
`SpikeServer`, `BridgeClient` in a front-end worker forwarding over
the unix-socket bridge), which is what lets accept/parse/auth scale
across processes independently of the single dispatcher.
"""
from __future__ import annotations

import asyncio
import json
import os
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

from repro_torch import faults
from repro_torch.obs import Telemetry
from repro_torch.portal import ws as _ws
from repro_torch.portal.auth import Authenticator
from repro_torch.portal.errors import PortalError

__all__ = ["HTTPRequest", "PortalApp", "RawResult", "read_request",
           "http_response"]

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

_REASONS = {200: "OK", 101: "Switching Protocols", 400: "Bad Request",
            401: "Unauthorized", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}


@dataclass
class HTTPRequest:
    method: str
    target: str
    version: str
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    # telemetry, filled in by dispatch/_v1: the request's span
    # propagation ctx and the quota label of its token (never the
    # secret)
    trace: Optional[dict] = None
    token_label: str = ""

    @property
    def path(self) -> str:
        return self.target.split("?", 1)[0]

    @property
    def query(self) -> Dict[str, str]:
        """Last-wins query parameters of the request target."""
        if "?" not in self.target:
            return {}
        qs = urllib.parse.parse_qsl(self.target.split("?", 1)[1],
                                    keep_blank_values=True)
        return dict(qs)

    def json(self) -> dict:
        if not self.body:
            return {}
        try:
            obj = json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise PortalError(400, "E_BAD_JSON",
                              f"request body is not valid JSON: {e}")
        if not isinstance(obj, dict):
            raise PortalError(400, "E_BAD_JSON",
                              "request body must be a JSON object")
        return obj

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return "close" not in conn

    def wants_websocket(self) -> bool:
        return ("websocket" in self.headers.get("upgrade", "").lower()
                and "upgrade" in self.headers.get("connection",
                                                  "").lower())


async def read_request(reader: asyncio.StreamReader) \
        -> Optional[HTTPRequest]:
    """Parse one request off the stream; None on clean EOF. Raises
    `PortalError` on malformed or oversized input."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise PortalError(400, "E_BAD_REQUEST",
                          "connection closed mid-request")
    except asyncio.LimitOverrunError:
        raise PortalError(413, "E_HEADERS_TOO_LARGE",
                          f"request head exceeds {MAX_HEADER_BYTES} "
                          f"bytes")
    if len(head) > MAX_HEADER_BYTES:
        raise PortalError(413, "E_HEADERS_TOO_LARGE",
                          f"request head exceeds {MAX_HEADER_BYTES} "
                          f"bytes")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise PortalError(400, "E_BAD_REQUEST",
                          f"malformed request line: {lines[0]!r}")
    req = HTTPRequest(method=parts[0].upper(), target=parts[1],
                      version=parts[2])
    for ln in lines[1:]:
        if not ln:
            continue
        name, sep, value = ln.partition(":")
        if not sep:
            raise PortalError(400, "E_BAD_REQUEST",
                              f"malformed header line: {ln!r}")
        req.headers[name.strip().lower()] = value.strip()
    length = req.headers.get("content-length", "0")
    try:
        n = int(length)
    except ValueError:
        raise PortalError(400, "E_BAD_REQUEST",
                          f"bad Content-Length: {length!r}")
    if n > MAX_BODY_BYTES:
        raise PortalError(413, "E_BODY_TOO_LARGE",
                          f"body of {n} bytes exceeds the "
                          f"{MAX_BODY_BYTES}-byte limit")
    if n:
        req.body = await reader.readexactly(n)
    return req


@dataclass
class RawResult:
    """A non-JSON (or non-200-JSON) route result — the Prometheus
    text exposition, or a health body that must ride a 503."""
    status: int
    content_type: str
    payload: bytes


def http_response(status: int, body: Union[dict, bytes, bytearray], *,
                  headers: Optional[Dict[str, str]] = None,
                  keep_alive: bool = True) -> bytes:
    hdrs = dict(headers or {})
    ctype = hdrs.pop("Content-Type", "application/json")
    payload = bytes(body) if isinstance(body, (bytes, bytearray)) \
        else json.dumps(body).encode("utf-8")
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             f"Content-Type: {ctype}",
             f"Content-Length: {len(payload)}",
             f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for k, v in hdrs.items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + payload


class PortalApp:
    """Route table + per-connection loop. One instance serves every
    connection of one worker (or of the in-process portal thread)."""

    def __init__(self, gateway, auth: Optional[Authenticator] = None,
                 telemetry: Optional[Telemetry] = None):
        self.gateway = gateway
        self.auth = auth or Authenticator(None)
        self.tel = telemetry if telemetry is not None else Telemetry()
        mreg = self.tel.metrics
        self._m_http = mreg.counter(
            "repro_http_requests_total",
            "HTTP requests by method and status",
            ("method", "status"))
        self._m_http_lat = mreg.histogram(
            "repro_http_latency_ms",
            "Wall-clock HTTP request latency in milliseconds")
        self._m_tok_admit = mreg.counter(
            "repro_token_admitted_total",
            "Requests admitted per token quota", ("token",))
        self._m_tok_reject = mreg.counter(
            "repro_token_rejected_total",
            "Requests rejected per token quota",
            ("token", "reason"))
        self._tok_last: Dict = {}
        mreg.register_callback(self._scrape_auth)

    def _scrape_auth(self, mreg) -> None:
        """Per-token quota counters, read at collect time from the
        authenticator's cumulative tallies (delta-tracked so they
        expose as true Prometheus counters and SUM correctly across
        worker snapshots)."""
        g_inflight = mreg.gauge("repro_token_inflight",
                                "Requests currently in flight per "
                                "token", ("token",))
        for label, m in self.auth.metrics().items():
            g_inflight.set(m["inflight"], token=label)
            for fld, inc in (
                    ("admitted", lambda n: self._m_tok_admit.inc(
                        n, token=label)),
                    ("rejected_rate", lambda n: self._m_tok_reject.inc(
                        n, token=label, reason="rate")),
                    ("rejected_inflight",
                     lambda n: self._m_tok_reject.inc(
                         n, token=label, reason="inflight"))):
                last = self._tok_last.get((label, fld), 0)
                if m[fld] > last:
                    inc(m[fld] - last)
                    self._tok_last[(label, fld)] = m[fld]

    # ------------------------------------------------------ connection
    async def handle_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await read_request(reader)
                except PortalError as e:
                    writer.write(http_response(
                        e.status, e.to_body(), headers=e.headers(),
                        keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                if req.wants_websocket():
                    await self._websocket(req, reader, writer)
                    break
                status, body, headers = await self.dispatch(req)
                writer.write(http_response(status, body,
                                           headers=headers,
                                           keep_alive=req.keep_alive))
                await writer.drain()
                if not req.keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # ------------------------------------------------------- dispatch
    async def dispatch(self, req: HTTPRequest) \
            -> Tuple[int, Union[dict, bytes], Dict[str, str]]:
        # root span of the request's trace: honour an X-Trace-Id the
        # client (or an upstream proxy) supplied, mint one otherwise;
        # the id is echoed back so clients can fetch /trace?trace_id=
        span = self.tel.tracer.span(
            "http_request",
            trace_id=req.headers.get("x-trace-id") or None,
            method=req.method, path=req.path)
        req.trace = span.ctx()
        headers: Dict[str, str] = {}
        try:
            out = await self._route(req)
            if isinstance(out, RawResult):
                status, body = out.status, out.payload
                headers["Content-Type"] = out.content_type
            else:
                status, body = 200, out
        except PortalError as e:
            status, body, headers = e.status, e.to_body(), e.headers()
        except Exception as e:     # noqa: BLE001 — wire boundary
            err = PortalError(500, "E_INTERNAL",
                              f"{type(e).__name__}: {e}")
            status, body, headers = err.status, err.to_body(), \
                err.headers()
        self._observe(req, span, status, body)
        if span.trace_id:
            headers["X-Trace-Id"] = span.trace_id
        return status, body, headers

    def _observe(self, req: HTTPRequest, span, status: int,
                 body) -> None:
        """Finish the root span, count the request, and emit its JSON
        log line (one per request, `--log-json`)."""
        span.finish(status=status)
        if self.tel.on:
            self._m_http.inc(method=req.method, status=str(status))
            self._m_http_lat.observe(span.duration_ms)
        if not self.tel.log.enabled:
            return
        err = body.get("error") if isinstance(body, dict) else None
        seg = [s for s in req.path.split("/") if s]
        rec = {"trace_id": span.trace_id, "token": req.token_label,
               "model": seg[1] if len(seg) >= 2 and seg[0] == "v1"
               else "", "op": seg[2] if len(seg) >= 3 else req.path,
               "status": status,
               "code": err.get("code") if isinstance(err, dict)
               else None,
               "latency_ms": round(span.duration_ms, 3)}
        if isinstance(body, dict):
            for k in ("bucket", "batch_size", "queue_wait_ms",
                      "dispatch_ms"):
                if k in body:
                    rec[k] = body[k]
        self.tel.log.request(**rec)

    async def _route(self, req: HTTPRequest) \
            -> Union[dict, RawResult]:
        path, method = req.path, req.method
        if path == "/healthz":
            self._need(method, "GET")
            try:
                out = await self.gateway.healthz(trace=req.trace)
            except PortalError as e:
                if e.code != "E_BRIDGE_DOWN":
                    raise
                # the bridge is redialing: this worker is up but can't
                # reach the dispatcher — report down with the reason
                # rather than a bare transport error
                out = {"ok": False, "status": "down",
                       "reason": str(e)}
            # which front-end process answered (the dispatcher's own
            # pid rides in `pid`) — Portal._wait_ready polls this to
            # confirm every SO_REUSEPORT worker is accepting
            out["worker_pid"] = os.getpid()
            if hasattr(self.gateway, "drops"):
                out["bridge"] = {"drops": self.gateway.drops,
                                 "reconnects": self.gateway.reconnects}
            status = out.get("status") or (
                "down" if out.get("ok") is False else "ok")
            if status == "down":
                # only DOWN answers 503 (load balancers drain this
                # backend while operators still see why); "degraded"
                # — supervisor mid-restart, stall suspicion — stays
                # 200 so one recoverable hiccup never ejects the node
                return RawResult(503, "application/json",
                                 json.dumps(out).encode("utf-8"))
            return out
        if path == "/metrics":
            self._need(method, "GET")
            if req.query.get("format") == "json":
                # legacy JSON shape; `clients` stays worker-local by
                # design (it reports the answering worker's quota
                # table — the aggregated view is the Prometheus text)
                stats = await self.gateway.stats(trace=req.trace)
                return {"server": stats,
                        "clients": self.auth.metrics()}
            out = await self.gateway.metrics("prometheus",
                                             trace=req.trace)
            return RawResult(200, out.get(
                "content_type",
                "text/plain; version=0.0.4; charset=utf-8"),
                out["text"].encode("utf-8"))
        if path == "/trace":
            self._need(method, "GET")
            return await self.gateway.trace_export(
                req.query.get("trace_id") or None, trace=req.trace)
        seg = [s for s in path.split("/") if s]
        if len(seg) >= 3 and seg[0] == "v1":
            return await self._v1(req, seg[1], seg[2:])
        raise PortalError(404, "E_NO_ROUTE",
                          f"no route for {method} {path}")

    async def _v1(self, req: HTTPRequest, model: str, rest) -> dict:
        # chaos site: a front-end worker dying mid-request (os._exit)
        # — fires only on model routes so health polls never trip it
        faults.fire("worker_exit")
        state = self.auth.authenticate(req.headers)
        if state is not None:
            req.token_label = state.name
        method = req.method
        trace = req.trace
        if rest == ["run"]:
            self._need(method, "POST")
            with self.auth.admit(state):
                return await self.gateway.run(model, req.json(),
                                              trace=trace)
        if rest == ["reconfigure"]:
            self._need(method, "POST")
            with self.auth.admit(state):
                return await self.gateway.reconfigure(model,
                                                      req.json(),
                                                      trace=trace)
        if rest == ["session"]:
            self._need(method, "POST")
            return await self.gateway.open_session(model, trace=trace)
        if len(rest) >= 2 and rest[0] == "session":
            sid = self._int(rest[1])
            if len(rest) == 2 and method == "GET":
                return await self.gateway.session_info(model, sid,
                                                       trace=trace)
            if len(rest) == 2 and method == "DELETE":
                return await self.gateway.close_session(model, sid,
                                                        trace=trace)
            if rest[2:] == ["reset"]:
                self._need(method, "POST")
                return await self.gateway.reset_session(model, sid,
                                                        trace=trace)
        raise PortalError(404, "E_NO_ROUTE",
                          f"no route for {method} {req.path}")

    async def _websocket(self, req: HTTPRequest,
                         reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """GET /v1/{model}/stream — auth happens BEFORE the 101, so a
        bad token is an ordinary HTTP 401, not a broken socket."""
        seg = [s for s in req.path.split("/") if s]
        try:
            if len(seg) != 3 or seg[0] != "v1" or seg[2] != "stream":
                raise PortalError(404, "E_NO_ROUTE",
                                  f"no websocket route for {req.path}")
            state = self.auth.authenticate(req.headers)
        except PortalError as e:
            writer.write(http_response(e.status, e.to_body(),
                                       headers=e.headers(),
                                       keep_alive=False))
            await writer.drain()
            return
        await _ws.handle_stream(self, req, reader, writer, seg[1],
                                state)

    # ------------------------------------------------------- helpers
    @staticmethod
    def _need(method: str, expected: str) -> None:
        if method != expected:
            raise PortalError(405, "E_METHOD",
                              f"use {expected} for this route, not "
                              f"{method}")

    @staticmethod
    def _int(s: str) -> int:
        try:
            return int(s)
        except ValueError:
            raise PortalError(400, "E_BAD_REQUEST",
                              f"session id must be an integer, got "
                              f"{s!r}")
