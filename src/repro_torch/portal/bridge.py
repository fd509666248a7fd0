"""Multi-worker bridge: N front-end processes, ONE resident dispatcher —
the port's copy of `repro/portal/bridge.py`, the same wire format.

The dispatcher process owns the torch runtime and the card — the resident
`Deployment`s, their kernels and lane state, the micro-batching
thread. Accepting sockets, parsing HTTP, checking tokens, and JSON
(de)serialization are pure-Python work that the GIL serializes against
nothing useful, so the portal splits them out: `--workers N` spawns N
front-end processes that each run the full `PortalApp` (http + ws +
auth) against a `BridgeClient` gateway, forwarding every admitted
request over a unix-domain socket to the `BridgeServer` beside the
dispatcher. All workers listen on the SAME TCP port via SO_REUSEPORT
(the kernel load-balances accepts), so the front end scales with
cores while the model stays resident exactly once.

The wire format is deliberately dumb: 4-byte big-endian length +
UTF-8 JSON, requests tagged with a connection-local `id` so one UDS
connection multiplexes every in-flight request of its worker.
Responses are `{"id": n, "result": ...}` or `{"id": n, "error":
<PortalError.to_body()>}` — errors cross the process boundary with
status/code/Retry-After/findings intact.

Telemetry rides the same frames: an optional `trace` field carries the
request's span-propagation context (`Span.ctx()`) dispatcher-ward, so
one trace id follows a request across the process boundary; `spans`
piggybacks the worker's finished spans (drained from its ring) and
`m` its metrics snapshot, which the `BridgeServer` ingests into the
dispatcher-side telemetry — that is how `/metrics` answers with
AGGREGATED multi-worker totals and `/trace` shows whole cross-process
traces.

Worker processes are spawned as
`python -m repro_torch.portal --worker ...`
and import ONLY stdlib modules (this file, http.py, ws.py, auth.py,
errors.py, and the port's stdlib-only `obs` and `faults`) — never torch
or numpy — so they start in tens of milliseconds and add no CUDA state
to fork.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import os
import random
import struct
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import faults
from repro_torch.obs import Telemetry
from repro_torch.portal.auth import Authenticator
from repro_torch.portal.errors import PortalError

__all__ = ["BridgeServer", "BridgeClient", "run_worker",
           "GATEWAY_OPS"]

# every gateway method a worker may invoke remotely — op names double
# as the method names on both gateway implementations
GATEWAY_OPS = ("run", "reconfigure", "open_session", "close_session",
               "reset_session", "session_info", "stats", "healthz",
               "metrics", "trace_export")

# worker metric snapshots are piggybacked at most this often on
# ordinary frames (scrape ops always carry a fresh one)
_M_FLUSH_S = 0.5

_MAX_MSG = 256 * 1024 * 1024


def _frame(obj: dict) -> bytes:
    payload = json.dumps(obj).encode("utf-8")
    return struct.pack(">I", len(payload)) + payload


async def _read_msg(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        head = await reader.readexactly(4)
        n, = struct.unpack(">I", head)
        if n > _MAX_MSG:
            raise PortalError(413, "E_BODY_TOO_LARGE",
                              f"bridge message of {n} bytes exceeds "
                              f"{_MAX_MSG}")
        payload = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        # a peer dying mid-frame is the same as a clean EOF here
        return None
    return json.loads(payload.decode("utf-8"))


class BridgeServer:
    """Dispatcher-side end of the bridge: serves gateway ops over a
    unix-domain socket. Each incoming message becomes its own task, so
    a slow micro-batch never head-of-line-blocks the connection — the
    `id` tags let responses return out of order while each worker's
    HTTP answers stay correctly paired."""

    def __init__(self, gateway, path: str,
                 telemetry: Optional[Telemetry] = None):
        self.gateway = gateway
        self.path = path
        self.telemetry = telemetry
        # latest metrics snapshot per worker pid (see worker_snapshots)
        self._worker_snaps: Dict[int, dict] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns = set()

    def worker_snapshots(self) -> List[Tuple[int, dict]]:
        """(pid, metrics snapshot) of every worker that has flushed —
        the extra exposition sources `/metrics` aggregates over."""
        return sorted(self._worker_snaps.items())

    async def start(self) -> "BridgeServer":
        self._server = await asyncio.start_unix_server(self._conn,
                                                       path=self.path)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # settle per-connection handlers (workers are already dead by
        # now) so loop teardown never reaps a pending task
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        self._conns.clear()

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        me = asyncio.current_task()
        self._conns.add(me)
        me.add_done_callback(self._conns.discard)
        lock = asyncio.Lock()          # frame writes stay atomic
        tasks = set()

        async def answer(msg: dict) -> None:
            # ingest piggybacked worker telemetry BEFORE running the
            # op, so a metrics/trace scrape sees the flushing worker's
            # own up-to-the-frame state
            if self.telemetry is not None:
                spans = msg.get("spans")
                if spans:
                    self.telemetry.tracer.record(spans)
            m = msg.get("m")
            if isinstance(m, dict) and "pid" in m:
                self._worker_snaps[int(m["pid"])] = m.get("snap", {})
            out = {"id": msg.get("id")}
            try:
                op = msg.get("op")
                if op not in GATEWAY_OPS:
                    raise PortalError(400, "E_BAD_REQUEST",
                                      f"unknown bridge op {op!r}")
                fn = getattr(self.gateway, op)
                kw = {"trace": msg["trace"]} if "trace" in msg else {}
                out["result"] = await fn(*msg.get("args", []), **kw)
            except PortalError as e:
                out["error"] = e.to_body()["error"]
            except Exception as e:     # noqa: BLE001 — process boundary
                out["error"] = PortalError(
                    500, "E_INTERNAL",
                    f"{type(e).__name__}: {e}").to_body()["error"]
            async with lock:
                writer.write(_frame(out))
                await writer.drain()

        try:
            while True:
                msg = await _read_msg(reader)
                if msg is None:
                    break
                t = asyncio.ensure_future(answer(msg))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            for t in tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class _BridgeMethod:
    def __init__(self, client: "BridgeClient", op: str):
        self._client, self._op = client, op

    async def __call__(self, *args, trace: Optional[dict] = None):
        return await self._client.call(self._op, *args, trace=trace)


class BridgeClient:
    """Worker-side gateway: the same duck-typed surface as
    `LocalGateway`, but every call is a length-prefixed JSON message
    over the unix socket. In-flight calls multiplex on one connection;
    message ids pair responses back to their awaiting coroutine.

    The connection self-heals. When the socket drops (dispatcher
    restart, chaos `bridge_drop`), in-flight IDEMPOTENT ops are parked
    and replayed verbatim on the next connection; non-idempotent ops
    (`run`, `reconfigure` — the dispatcher may have applied them before
    dying) fail fast with 503 E_BRIDGE_DOWN so the CLIENT decides
    whether to retry. A background loop redials with capped exponential
    backoff + deterministic jitter; new calls wait up to
    `connect_wait_s` for the link before failing."""

    #: ops safe to resend after a drop — everything except the two that
    #: mutate lane state / weights exactly once per call
    IDEMPOTENT_OPS = frozenset(GATEWAY_OPS) - {"run", "reconfigure"}

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 telemetry: Optional[Telemetry] = None, *,
                 path: Optional[str] = None,
                 auto_reconnect: bool = True,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 connect_wait_s: float = 15.0,
                 seed: int = 0):
        self._reader, self._writer = reader, writer
        self.telemetry = telemetry
        self.path = path
        self.auto_reconnect = bool(auto_reconnect) and path is not None
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.connect_wait_s = float(connect_wait_s)
        self.drops = 0
        self.reconnects = 0
        self._rng = random.Random(seed)
        self._closing = False
        self._connected = asyncio.Event()
        self._connected.set()
        self._m_flushed = 0.0
        self._ids = itertools.count()
        # id -> (future, frame dict) so idempotent frames can replay
        self._waiting: Dict[int, Tuple[asyncio.Future, dict]] = {}
        self._reconnector: Optional[asyncio.Future] = None
        self._pump = asyncio.ensure_future(self._read_loop())
        for op in GATEWAY_OPS:
            setattr(self, op, _BridgeMethod(self, op))

    @classmethod
    async def open(cls, path: str,
                   telemetry: Optional[Telemetry] = None, **kw) \
            -> "BridgeClient":
        reader, writer = await asyncio.open_unix_connection(path)
        return cls(reader, writer, telemetry, path=path, **kw)

    async def _read_loop(self) -> None:
        while True:
            try:
                msg = await _read_msg(self._reader)
            except Exception:          # noqa: BLE001 — treat as drop
                msg = None
            if msg is None:
                self._on_disconnect()
                return
            ent = self._waiting.pop(msg.get("id"), None)
            if ent is None:
                continue
            fut, _ = ent
            if fut.done():
                continue
            if "error" in msg:
                fut.set_exception(
                    PortalError.from_body({"error": msg["error"]}))
            else:
                fut.set_result(msg.get("result"))

    def _down_error(self) -> PortalError:
        return PortalError(503, "E_BRIDGE_DOWN",
                           "dispatcher connection lost — the bridge "
                           "is redialing; retry shortly",
                           retry_after=1.0)

    def _on_disconnect(self) -> None:
        self._connected.clear()
        self.drops += 1
        reconnecting = self.auto_reconnect and not self._closing
        err = self._down_error()
        replay: Dict[int, Tuple[asyncio.Future, dict]] = {}
        for mid, (fut, msg) in self._waiting.items():
            if fut.done():
                continue
            if reconnecting and msg.get("op") in self.IDEMPOTENT_OPS:
                replay[mid] = (fut, msg)
            else:
                # run/reconfigure may have been applied dispatcher-side
                # before the drop — replaying could double-step a lane,
                # so the caller gets the structured 503 instead
                fut.set_exception(err)
        self._waiting = replay
        if reconnecting:
            self._reconnector = asyncio.ensure_future(
                self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        delay = self.backoff_base_s
        while not self._closing:
            try:
                reader, writer = \
                    await asyncio.open_unix_connection(self.path)
            except OSError:
                await asyncio.sleep(
                    delay + self._rng.uniform(0.0, delay / 2))
                delay = min(delay * 2.0, self.backoff_cap_s)
                continue
            if self._closing:
                writer.close()
                return
            self._reader, self._writer = reader, writer
            self.reconnects += 1
            self._pump = asyncio.ensure_future(self._read_loop())
            self._connected.set()
            # replay parked idempotent frames verbatim (minus the
            # telemetry piggyback, already ingested the first time);
            # ids are connection-local to THIS client so they still
            # pair correctly on the fresh connection
            for mid, (fut, msg) in sorted(self._waiting.items()):
                msg = {k: v for k, v in msg.items()
                       if k not in ("spans", "m")}
                self._waiting[mid] = (fut, msg)
                self._writer.write(_frame(msg))
            try:
                await self._writer.drain()
            except (ConnectionError, OSError):
                pass   # the fresh read loop observes the drop, redials
            return

    async def call(self, op: str, *args,
                   trace: Optional[dict] = None):
        if faults.fire("bridge_drop") and self._writer is not None:
            # chaos: sever the UDS out from under this worker — the
            # read loop sees EOF and the redial path takes over
            self._writer.transport.abort()
        if not self._connected.is_set():
            if not self.auto_reconnect or self._closing:
                raise self._down_error()
            try:
                await asyncio.wait_for(self._connected.wait(),
                                       self.connect_wait_s)
            except asyncio.TimeoutError:
                raise PortalError(
                    503, "E_BRIDGE_DOWN",
                    f"dispatcher unreachable for "
                    f"{self.connect_wait_s:.0f}s", retry_after=1.0)
        mid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        msg = {"id": mid, "op": op, "args": list(args)}
        tel = self.telemetry
        span = None
        if tel is not None and tel.tracer.on:
            # the bridge hop is its own span; the dispatcher-side
            # gateway_call nests under it via the forwarded ctx
            span = tel.tracer.span("bridge", ctx=trace, op=op)
            msg["trace"] = span.ctx()
        elif trace is not None:
            msg["trace"] = trace
        if tel is not None:
            # flush finished spans (recorded since the last call) and,
            # throttled — or always for scrape ops — the metrics
            # snapshot; the dispatcher ingests both, which is what
            # makes /metrics aggregated and /trace cross-process
            done = [s.to_dict() for s in tel.tracer.spans()
                    if s.end is not None]
            if done:
                tel.tracer.clear()
                msg["spans"] = done
            now = time.monotonic()
            if op in ("metrics", "healthz", "trace_export") \
                    or now - self._m_flushed > _M_FLUSH_S:
                msg["m"] = {"pid": os.getpid(),
                            "snap": tel.metrics.collect()}
                self._m_flushed = now
        self._waiting[mid] = (fut, msg)
        # write-before-await keeps bridge submission order == the
        # order callers issued calls in (ws streaming relies on it)
        try:
            self._writer.write(_frame(msg))
            await self._writer.drain()
        except (ConnectionError, OSError):
            # drop mid-write: _on_disconnect has already settled (or
            # parked for replay) this future — just await it below
            pass
        try:
            return await fut
        finally:
            if span is not None:
                span.finish()

    async def close(self) -> None:
        self._closing = True
        if self._reconnector is not None:
            self._reconnector.cancel()
            try:
                await self._reconnector
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._reconnector = None
        self._pump.cancel()
        err = self._down_error()
        for fut, _ in self._waiting.values():
            if not fut.done():
                fut.set_exception(err)
        self._waiting.clear()
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


# ------------------------------------------------------------- workers
def _reuseport_socket(host: str, port: int):
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    return s


async def _worker_async(host: str, port: int, uds_path: str,
                        auth_spec: Optional[dict],
                        log_json: Optional[str] = None) -> None:
    from repro_torch.portal.http import PortalApp

    telemetry = Telemetry(log_json=log_json)
    gateway = await BridgeClient.open(uds_path, telemetry)
    app = PortalApp(gateway, Authenticator.from_spec(auth_spec),
                    telemetry=telemetry)
    sock = _reuseport_socket(host, port)
    server = await asyncio.start_server(app.handle_conn, sock=sock)
    async with server:
        await server.serve_forever()


def run_worker(host: str, port: int, uds_path: str,
               auth_spec_json: Optional[str] = None,
               log_json: Optional[str] = None) -> None:
    """Entry point of `python -m repro_torch.portal --worker` — one
    front-end process. Blocks until killed by the parent portal."""
    # arm chaos sites from REPRO_FAULTS (no-op when unset) — workers
    # are spawned with the parent portal's env, so one spec governs
    # the whole process tree
    faults.install_from_env()
    spec = json.loads(auth_spec_json) if auth_spec_json else None
    try:
        asyncio.run(_worker_async(host, port, uds_path, spec,
                                  log_json))
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
