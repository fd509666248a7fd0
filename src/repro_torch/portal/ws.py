"""Websocket transport (RFC 6455) for streaming sessions — stdlib only;
the port's copy of `repro/portal/ws.py`, the same wire protocol.

`GET /v1/{model}/stream` upgrades to a websocket whose connection IS a
session: the handshake pins a resident deployment lane (the same
`SlotPool` lane an HTTP session would get), every text frame the
client sends is one spike window, and results stream back IN SUBMISSION
ORDER as their micro-batches resolve — a client may pipeline several
windows without waiting (the server's coalesce rule still runs at most
one window of the lane per batch, so the lane's dynamics equal one
uninterrupted run). Closing the socket releases the lane.

Framing is implemented directly on the handshake primitives the RFC
reduces to — `hashlib.sha1` + `base64` for Sec-WebSocket-Accept and
a ~30-line frame codec (FIN/opcode, 7/16/64-bit lengths, client
masking) — so bridge workers need no third-party dependency.

Wire protocol (text frames, JSON):

  server -> client   {"session": id, "model": m, "window": W}   (hello)
  client -> server   {"counts": [[...]]} | {"events": [[...]]}
                     (one window; optional "tag" echoes back)
  server -> client   {"window": i, "spikes": ..., "membrane": ...,
                      "digest": ...}  or  {"window": i, "error": {...}}
  close frame        drains pending windows, answers them, releases
                     the lane, echoes the close
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import struct
from typing import Optional, Tuple

from repro_torch.portal.errors import PortalError

__all__ = ["accept_key", "encode_frame", "read_message",
           "handle_stream", "WSClient", "FrameTooBig",
           "MAX_FRAME_BYTES"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x2, 0x8, 0x9, 0xA

# same cap as http.MAX_BODY_BYTES (ws.py cannot import http.py — the
# import runs the other way): a frame header may claim a 64-bit
# length, and readexactly() would happily buffer it all, so unbounded
# claims are rejected with close status 1009 before any payload read.
MAX_FRAME_BYTES = 64 * 1024 * 1024
CLOSE_TOO_BIG = 1009            # RFC 6455 7.4.1 "Message Too Big"


class FrameTooBig(Exception):
    """Incoming frame declares a payload over MAX_FRAME_BYTES."""

    def __init__(self, size: int):
        super().__init__(f"websocket frame of {size} bytes exceeds "
                         f"the {MAX_FRAME_BYTES}-byte limit")
        self.size = size


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((key + _GUID).encode("latin-1")).digest()
    return base64.b64encode(digest).decode("latin-1")


def encode_frame(payload: bytes, opcode: int = OP_TEXT,
                 mask: bool = False) -> bytes:
    """One FIN frame. Servers send unmasked; clients MUST mask."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head.append(mbit | n)
    elif n < (1 << 16):
        head.append(mbit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mbit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4]
                        for i, b in enumerate(payload))
    return bytes(head) + payload


async def _read_frame(reader: asyncio.StreamReader) \
        -> Optional[Tuple[int, bool, bytes]]:
    """(opcode, fin, payload), None on EOF or mid-frame disconnect
    (abrupt client exits are routine, not errors), or `FrameTooBig`
    for a length claim over MAX_FRAME_BYTES."""
    try:
        b1, b2 = await reader.readexactly(2)
        fin, opcode = bool(b1 & 0x80), b1 & 0x0F
        masked, n = bool(b2 & 0x80), b2 & 0x7F
        if n == 126:
            n, = struct.unpack(">H", await reader.readexactly(2))
        elif n == 127:
            n, = struct.unpack(">Q", await reader.readexactly(8))
        if n > MAX_FRAME_BYTES:
            raise FrameTooBig(n)
        key = await reader.readexactly(4) if masked else None
        payload = await reader.readexactly(n) if n else b""
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    if key:
        payload = bytes(b ^ key[i % 4]
                        for i, b in enumerate(payload))
    return opcode, fin, payload


async def read_message(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) \
        -> Optional[Tuple[int, bytes]]:
    """Next complete data/close message, reassembling fragments and
    answering pings inline. None on EOF; raises `FrameTooBig` when a
    frame claims more than MAX_FRAME_BYTES (caller closes with 1009)."""
    opcode, buf = None, bytearray()
    while True:
        frame = await _read_frame(reader)
        if frame is None:
            return None
        op, fin, payload = frame
        if op == OP_PING:
            writer.write(encode_frame(payload, OP_PONG))
            continue
        if op == OP_PONG:
            continue
        if op == OP_CLOSE:
            return OP_CLOSE, payload
        if op in (OP_TEXT, OP_BINARY):
            opcode, buf = op, bytearray(payload)
        elif opcode is not None:      # continuation
            buf += payload
        else:
            continue
        if fin:
            return opcode, bytes(buf)


def _handshake_bytes(key: str) -> bytes:
    return ("HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
            "\r\n").encode("latin-1")


# --------------------------------------------------------------- server
async def handle_stream(app, req, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, model: str,
                        state) -> None:
    """Serve one streaming-session connection (called by
    `PortalApp._websocket` after routing + auth)."""
    from repro_torch.portal.http import http_response   # no cycle at import

    key = req.headers.get("sec-websocket-key")
    if not key:
        e = PortalError(400, "E_BAD_REQUEST",
                        "websocket upgrade without Sec-WebSocket-Key")
        writer.write(http_response(e.status, e.to_body(),
                                   keep_alive=False))
        await writer.drain()
        return
    try:
        hello = await app.gateway.open_session(model)
    except PortalError as e:
        # lane exhaustion / unknown model is an ordinary HTTP error,
        # not a broken socket
        writer.write(http_response(e.status, e.to_body(),
                                   headers=e.headers(),
                                   keep_alive=False))
        await writer.drain()
        return
    sid = hello["session"]
    writer.write(_handshake_bytes(key))
    writer.write(encode_frame(json.dumps(hello).encode("utf-8")))
    await writer.drain()

    # one trace per stream: every window span (and its downstream
    # bridge/queue/dispatch spans) nests under this root
    tel = app.tel
    root = tel.tracer.span(
        "ws_stream",
        trace_id=req.headers.get("x-trace-id") or None,
        model=model, session=sid)

    pending: asyncio.Queue = asyncio.Queue()

    async def window_task(payload: dict) -> dict:
        with app.auth.admit(state):
            payload = dict(payload)
            payload["session"] = sid
            span = tel.tracer.span("ws_window", ctx=root.ctx(),
                                   model=model)
            try:
                out = await app.gateway.run(model, payload,
                                            trace=span.ctx())
            except PortalError as e:
                span.finish(error=e.code)
                raise
            span.finish()
            return out

    close_payload = b""

    async def produce() -> None:
        # the try/finally guarantees the None sentinel even if a read
        # raises: a producer that dies silently would leave the
        # consumer blocked on pending.get() forever, and the finally
        # below (lane release) would never run — the lane would leak.
        nonlocal close_payload
        idx = 0
        try:
            while True:
                try:
                    msg = await read_message(reader, writer)
                except FrameTooBig as e:
                    # answered by the consumer's close frame, AFTER
                    # every already-pipelined window — no data frame
                    # ever follows the close
                    close_payload = (struct.pack(">H", CLOSE_TOO_BIG)
                                     + str(e).encode("utf-8")[:100])
                    break
                if msg is None or msg[0] == OP_CLOSE:
                    break
                try:
                    payload = json.loads(msg[1].decode("utf-8"))
                    if not isinstance(payload, dict):
                        raise ValueError("window message must be a "
                                         "JSON object")
                except (ValueError, UnicodeDecodeError) as e:
                    err = PortalError(400, "E_BAD_JSON",
                                      f"bad window message: {e}")
                    fut = asyncio.get_running_loop().create_future()
                    fut.set_exception(err)
                    await pending.put((idx, None, fut))
                else:
                    tag = payload.pop("tag", None)
                    # the task starts now — submission order IS frame
                    # order
                    task = asyncio.ensure_future(window_task(payload))
                    await pending.put((idx, tag, task))
                idx += 1
        finally:
            pending.put_nowait(None)

    producer = asyncio.ensure_future(produce())
    try:
        while True:
            item = await pending.get()
            if item is None:
                break
            idx, tag, task = item
            out = {"window": idx}
            if tag is not None:
                out["tag"] = tag
            try:
                out.update(await task)
            except PortalError as e:
                out["error"] = e.to_body()["error"]
            except Exception as e:        # noqa: BLE001 — wire boundary
                out["error"] = PortalError(
                    500, "E_INTERNAL",
                    f"{type(e).__name__}: {e}").to_body()["error"]
            if tel.log.enabled:
                err = out.get("error")
                tel.log.request(
                    trace_id=root.trace_id,
                    token=state.name if state is not None else "",
                    model=model, op="ws_window",
                    status=err.get("status", 500) if err else 200,
                    code=err.get("code") if err else None,
                    window=idx,
                    **{k: out[k] for k in
                       ("bucket", "batch_size", "queue_wait_ms",
                        "dispatch_ms") if k in out})
            writer.write(encode_frame(json.dumps(out).encode("utf-8")))
            await writer.drain()
        writer.write(encode_frame(close_payload, OP_CLOSE))
        await writer.drain()
    except (ConnectionError, OSError):
        pass
    finally:
        root.finish()
        producer.cancel()
        try:
            await app.gateway.close_session(model, sid)
        except PortalError:
            pass


# --------------------------------------------------------------- client
class WSClient:
    """Synchronous websocket client for the streaming endpoint — what
    the tests, `chip_smoke.py` and `examples/torch_serve_snn.py --portal`
    drive
    the portal with (also a reference for external clients).

        c = WSClient("127.0.0.1", port, "demo", token="s3cret")
        c.send_window(counts=window)          # pipeline as many as
        res = c.recv()                        # you like; results come
        c.close()                             # back in order
    """

    def __init__(self, host: str, port: int, model: str,
                 token: Optional[str] = None, timeout: float = 120.0):
        import socket

        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self._buf = b""
        key = base64.b64encode(os.urandom(16)).decode("latin-1")
        lines = [f"GET /v1/{model}/stream HTTP/1.1",
                 f"Host: {host}:{port}",
                 "Upgrade: websocket", "Connection: Upgrade",
                 f"Sec-WebSocket-Key: {key}",
                 "Sec-WebSocket-Version: 13"]
        if token:
            lines.append(f"Authorization: Bearer {token}")
        self.sock.sendall(("\r\n".join(lines) + "\r\n\r\n")
                          .encode("latin-1"))
        status, headers, body = self._read_http_response()
        if status != 101:
            self.sock.close()
            raise PortalError.from_body(
                json.loads(body.decode("utf-8") or "{}"))
        if headers.get("sec-websocket-accept") != accept_key(key):
            self.sock.close()
            raise PortalError(502, "E_HANDSHAKE",
                              "bad Sec-WebSocket-Accept from server")
        self.hello = self.recv()
        self.session = self.hello["session"]

    # -------------------------------------------------- raw transport
    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("websocket peer closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_http_response(self):
        while b"\r\n\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("peer closed during handshake")
            self._buf += chunk
        head, self._buf = self._buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split()[1])
        headers = {}
        for ln in lines[1:]:
            name, _, value = ln.partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        n = int(headers.get("content-length", "0") or 0)
        if n:
            body = self._read_exact(n)
        return status, headers, body

    def _read_frame(self):
        b1, b2 = self._read_exact(2)
        opcode, n = b1 & 0x0F, b2 & 0x7F
        if n == 126:
            n, = struct.unpack(">H", self._read_exact(2))
        elif n == 127:
            n, = struct.unpack(">Q", self._read_exact(8))
        payload = self._read_exact(n) if n else b""
        return opcode, payload

    # ------------------------------------------------------- protocol
    def send_window(self, counts=None, events=None, seed=None,
                    tag=None) -> None:
        """Submit one spike window (does not wait for the result)."""
        msg = {}
        if counts is not None:
            msg["counts"] = [[int(x) for x in row] for row in counts]
        if events is not None:
            msg["events"] = [[int(x) for x in step] for step in events]
        if seed is not None:
            msg["seed"] = int(seed)
        if tag is not None:
            msg["tag"] = tag
        self.sock.sendall(encode_frame(
            json.dumps(msg).encode("utf-8"), mask=True))

    def recv(self) -> dict:
        """Next in-order server message; raises `PortalError` if the
        window failed."""
        while True:
            opcode, payload = self._read_frame()
            if opcode == OP_CLOSE:
                raise ConnectionError("server closed the stream")
            if opcode == OP_PING:
                self.sock.sendall(encode_frame(payload, OP_PONG,
                                               mask=True))
                continue
            if opcode not in (OP_TEXT, OP_BINARY):
                continue
            out = json.loads(payload.decode("utf-8"))
            if "error" in out:
                raise PortalError.from_body({"error": out["error"]})
            return out

    def close(self) -> None:
        """Send the close frame and wait for the server's echo (which
        arrives only after every pipelined window was answered)."""
        try:
            self.sock.sendall(encode_frame(b"", OP_CLOSE, mask=True))
            while True:
                opcode, _ = self._read_frame()
                if opcode == OP_CLOSE:
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            self.sock.close()
