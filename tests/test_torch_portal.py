"""The port's web portal (`repro_torch.portal`) against `repro.portal`.

The counterparts of tests/test_portal.py on the port's server
(``device="cpu"``, the kernels' plain versions): 8 concurrent HTTP
clients bit-identical to `SpikeServer.submit`, the session lifecycle,
the reconfigure barrier, the 400 `AnalysisError` report, the negative
routes, `/metrics`, a websocket session equal to the in-process lane,
lane exhaustion as a 503, an abrupt disconnect releasing its lane, the
1009 close on an oversized frame, the auth and quota paths,
backpressure as a 503 with Retry-After, no lane shape beyond the warmed
buckets, the bridge round trip, healthz down and a dispatch restart
that recovers, the bridge's auto-reconnect and the worker respawn.

Then one request stream — runs, a session over HTTP, a websocket
session, a reconfigure and more runs — goes through a JAX-backed
`repro.portal.Portal` and the port's `Portal` on the simulator, both
engine paths, hiaer and mesh (world size 1): identical digests and
identical JSON bodies apart from the timing fields.

Every client call carries a socket timeout and every wait polls against
a deadline, so a fault fails a test instead of hanging the run.
"""
import asyncio
import http.client
import json
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core.api import LIF_neuron as JLIF
from repro.core.compile import compile_spec as j_compile
from repro.core.partition import Hierarchy as JHier
from repro.core.spec import NetworkSpec as JSpec
from repro.portal import Portal as JPortal
from repro.portal import WSClient as JWSClient
from repro.serve import SpikeServer as JServer
from repro_torch import Hierarchy as THier
from repro_torch import LIF_neuron as TLIF
from repro_torch import NetworkSpec as TSpec
from repro_torch import compile_spec as t_compile
from repro_torch import faults
from repro_torch.analysis import AnalysisError
from repro_torch.analysis.retrace import compile_counts
from repro_torch.core.deploy import deploy
from repro_torch.portal import Portal, PortalError, TokenQuota, WSClient
from repro_torch.portal.gateway import result_digest
from repro_torch.serve import BufferFull, SpikeServer
from test_torch_serve import _spec, windows

TIMEOUT = 60
# the fields of a run result that time the request or name its trace
TIMING = ("latency_ms", "queue_wait_ms", "dispatch_ms", "trace_id")
# (backend, fused): the simulator, both engine paths, hiaer, mesh
CROSS = [("simulator", False), ("engine", False), ("engine", True),
         ("hiaer", False), ("mesh", False)]


def small_pair(backend, n_axons=5, n_neurons=12, seed=3):
    """(repro artifact, repro_torch artifact) of one network from one
    numpy seed; hiaer and mesh on three cores."""
    arts = []
    for spec_cls, lif, compile_fn, hier in (
            (JSpec, JLIF, j_compile, JHier), (TSpec, TLIF, t_compile, THier)):
        kw = {}
        if backend in ("hiaer", "mesh"):
            kw["hierarchy"] = hier(1, 1, 3, -(-n_neurons // 3))
        arts.append(compile_fn(_spec(spec_cls, lif, n_axons, n_neurons,
                                     seed), target=backend, **kw))
    return tuple(arts)


def http_req(port, method, path, body=None, token=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    payload = raw if raw is not None else (
        json.dumps(body) if body is not None else None)
    conn.request(method, path, payload, headers)
    resp = conn.getresponse()
    data = resp.read().decode("utf-8")
    conn.close()
    hdrs = {k.lower(): v for k, v in resp.getheaders()}
    if hdrs.get("content-type", "").startswith("text/plain"):
        return resp.status, hdrs, data
    return resp.status, hdrs, json.loads(data)


def poll(cond, what, deadline_s=TIMEOUT, every_s=0.02):
    """Wait until `cond()` is true; fail naming `what` at the deadline."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > deadline_s:
            raise AssertionError(f"{what} (after {deadline_s} s)")
        time.sleep(every_s)


def retry_os(fn, deadline_s=TIMEOUT):
    """`fn()`, retried while it raises OSError (a connection that
    belonged to a dead worker), until the deadline."""
    t0 = time.monotonic()
    while True:
        try:
            return fn()
        except OSError:
            if time.monotonic() - t0 > deadline_s:
                raise
            time.sleep(0.05)


def run_threads(target, n):
    errors = []

    def wrap(i):
        try:
            target(i)
        except BaseException as e:     # noqa: BLE001 — raised below
            errors.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "a client thread never returned"
    if errors:
        raise errors[0]


def lane_ref(c, lanes, wins, seeds=None):
    """Each window of `wins` run on a fresh port deployment of `c`, lane
    by lane (a scratch lane -1 under its seed): the digests."""
    ref = deploy(c, seed=0, device="cpu")
    ref.alloc_lanes(4)
    out = []
    for i, (ln, w) in enumerate(zip(lanes, wins)):
        spk, V = ref.run_lanes([ln], w[None],
                               seeds=None if seeds is None else [seeds[i]])
        out.append(result_digest(spk[0], V[0]))
    return out


def _wait_lanes_free(srv, model):
    poll(lambda: srv.models[model].sessions.n_open == 0,
         "a lane is still open — leaked by a dead connection")


# ------------------------------------------------- shared engine portal
@pytest.fixture(scope="module")
def engine_portal():
    """One resident engine model served in-process, shared by the HTTP
    and websocket tests."""
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=3.0)
    srv.add_model("m", c, window=4, n_sessions=4, seed=0, device="cpu")
    with srv, Portal(srv, port=0) as portal:
        yield srv, portal, c


# ------------------------------------------------------- HTTP transport
def test_http_eight_concurrent_clients_bit_identical(engine_portal):
    """8 concurrent HTTP clients x 3 requests == direct submit, bit for
    bit (digest and full arrays)."""
    srv, portal, c = engine_portal
    rng = np.random.default_rng(7)
    reqs = {(cl, r): windows(rng, 1, 4, c.n_axons)[0]
            for cl in range(8) for r in range(3)}
    results = {}

    def client(cl):
        for r in range(3):
            results[(cl, r)] = http_req(
                portal.port, "POST", "/v1/m/run",
                {"counts": reqs[(cl, r)].tolist(), "seed": cl * 100 + r})

    run_threads(client, 8)
    for (cl, r), w in reqs.items():
        status, _, body = results[(cl, r)]
        assert status == 200, body
        ref = srv.submit("m", w, seed=cl * 100 + r).result(timeout=TIMEOUT)
        assert body["digest"] == result_digest(ref.spikes, ref.membrane)
        np.testing.assert_array_equal(np.asarray(body["spikes"], bool),
                                      ref.spikes)
        np.testing.assert_array_equal(
            np.asarray(body["membrane"], np.int32), ref.membrane)
        assert body["batch_size"] >= 1 and body["model"] == "m"


def test_http_session_lifecycle(engine_portal):
    srv, portal, c = engine_portal
    w = windows(np.random.default_rng(3), 1, 4, c.n_axons)[0]
    _, _, opened = http_req(portal.port, "POST", "/v1/m/session")
    sid = opened["session"]
    assert opened["window"] == 4
    s, _, r1 = http_req(portal.port, "POST", "/v1/m/run",
                        {"counts": w.tolist(), "session": sid})
    assert s == 200 and r1["session"] == sid
    s, _, info = http_req(portal.port, "GET", f"/v1/m/session/{sid}")
    assert s == 200 and info["steps"] == 4 and info["requests"] == 1
    np.testing.assert_array_equal(np.asarray(info["membrane"]),
                                  np.asarray(r1["membrane"]))
    s, _, _ = http_req(portal.port, "POST", f"/v1/m/session/{sid}/reset")
    assert s == 200
    s, _, info = http_req(portal.port, "GET", f"/v1/m/session/{sid}")
    assert not np.asarray(info["membrane"]).any()
    s, _, r2 = http_req(portal.port, "POST", "/v1/m/run",
                        {"counts": w.tolist(), "session": sid})
    # reset -> same construction stream -> same window result
    assert r2["digest"] == r1["digest"]
    s, _, closed = http_req(portal.port, "DELETE", f"/v1/m/session/{sid}")
    assert s == 200 and closed["closed"] == sid
    s, _, body = http_req(portal.port, "GET", f"/v1/m/session/{sid}")
    assert s == 404 and body["error"]["code"] == "E_NO_SESSION"


def test_session_reset_waits_off_the_portal_loop(engine_portal):
    """A session DELETE whose lane reset waits (on a multi-rank
    deployment it waits for the replica lock, which a dispatch holds
    through its collectives) stalls no other client: /healthz answers
    while the reset waits, and the DELETE completes once it may go on."""
    srv, portal, c = engine_portal
    dep = srv.models["m"].dep
    real, entered, go = dep.reset, threading.Event(), threading.Event()

    def held(*a, **kw):
        entered.set()
        assert go.wait(TIMEOUT)
        return real(*a, **kw)

    _, _, opened = http_req(portal.port, "POST", "/v1/m/session")
    out = {}
    dep.reset = held
    try:
        t = threading.Thread(target=lambda: out.update(r=http_req(
            portal.port, "DELETE", f"/v1/m/session/{opened['session']}")))
        t.start()
        assert entered.wait(TIMEOUT)
        s, _, hz = http_req(portal.port, "GET", "/healthz")
        assert s == 200 and hz["ok"] and t.is_alive()
        go.set()
        t.join(TIMEOUT)
    finally:
        go.set()
        del dep.reset
    assert out["r"][0] == 200 and out["r"][2]["closed"] == opened["session"]
    _wait_lanes_free(srv, "m")


def test_http_reconfigure_barrier(engine_portal):
    """A /reconfigure lands between batches: the run after it sees the
    new weight, and a fresh deployment with the same write agrees."""
    srv, portal, c = engine_portal
    pre, post = -1, int(c.syn_post[0])
    dep = srv.models["m"].dep
    w_old = int(dep.read_synapses([pre], [post])[0])
    w = windows(np.random.default_rng(11), 1, 4, c.n_axons)[0]
    try:
        s, _, body = http_req(portal.port, "POST", "/v1/m/reconfigure",
                              {"pre": [pre], "post": [post],
                               "weight": [w_old + 5]})
        assert s == 200 and body["uploads"] >= 1
        assert int(dep.read_synapses([pre], [post])[0]) == w_old + 5
        s, _, after = http_req(portal.port, "POST", "/v1/m/run",
                               {"counts": w.tolist(), "seed": 4})
        ref = deploy(c, seed=0, device="cpu")
        ref.write_synapses([pre], [post], [w_old + 5])
        spk, V = ref.run_lanes([-1], w[None], seeds=[4])
        assert after["digest"] == result_digest(spk[0], V[0])
        s, _, body = http_req(portal.port, "POST", "/v1/m/reconfigure",
                              {"pre": [pre], "post": [post]})
        assert s == 400 and "'weight'" in body["error"]["message"]
    finally:
        # later module tests see the original weights
        http_req(portal.port, "POST", "/v1/m/reconfigure",
                 {"pre": [pre], "post": [post], "weight": [w_old]})


def test_analysis_error_renders_400_with_exact_report(engine_portal):
    """The 400 body carries the analyzer's own code and a message that
    is EXACTLY `report.render()` (== str(AnalysisError))."""
    srv, portal, c = engine_portal
    wide = np.zeros((4, c.n_axons + 7), int)
    with pytest.raises(AnalysisError) as ei:
        srv.submit("m", wide)
    status, _, body = http_req(portal.port, "POST", "/v1/m/run",
                               {"counts": wide.tolist()})
    assert status == 400
    assert body["error"]["code"] == "E_SCHED_WIDTH"
    assert body["error"]["message"] == str(ei.value)
    f = body["error"]["findings"]["findings"][0]
    assert f["code"] == "E_SCHED_WIDTH" and f["severity"] == "error"


def test_http_negative_routes(engine_portal):
    srv, portal, c = engine_portal
    s, _, body = http_req(portal.port, "GET", "/nope")
    assert s == 404 and body["error"]["code"] == "E_NO_ROUTE"
    s, _, body = http_req(portal.port, "POST", "/v1/ghost/run",
                          {"events": [[0]]})
    assert s == 404 and body["error"]["code"] == "E_NO_MODEL"
    s, _, body = http_req(portal.port, "GET", "/v1/m/run")
    assert s == 405 and body["error"]["code"] == "E_METHOD"
    s, _, body = http_req(portal.port, "POST", "/v1/m/run",
                          raw=b"{not json")
    assert s == 400 and body["error"]["code"] == "E_BAD_JSON"
    s, _, body = http_req(portal.port, "POST", "/v1/m/run",
                          {"counts": [[0] * c.n_axons], "events": [[0]]})
    assert s == 400 and "exactly one" in body["error"]["message"]
    s, _, body = http_req(portal.port, "GET", "/v1/m/session/x")
    assert s == 400 and body["error"]["code"] == "E_BAD_REQUEST"


def test_metrics_exposes_server_stats_and_clients(engine_portal):
    srv, portal, c = engine_portal
    w = windows(np.random.default_rng(1), 1, 4, c.n_axons)[0]
    assert http_req(portal.port, "POST", "/v1/m/run",
                    {"counts": w.tolist()})[0] == 200
    s, _, body = http_req(portal.port, "GET", "/metrics?format=json")
    assert s == 200
    assert body["server"]["models"]["m"]["requests"] >= 1
    assert {"p50_ms", "p99_ms", "buffer"} <= set(body["server"])
    assert body["clients"] == {}            # open portal: no tokens
    s, hdrs, text = http_req(portal.port, "GET", "/metrics")
    assert s == 200 and hdrs["content-type"].startswith("text/plain")
    for fam in ("repro_http_requests_total", "repro_serve_requests_total",
                "repro_lanes_capacity", "repro_compile_count"):
        assert fam in text, fam
    ok = [ln for ln in text.splitlines()
          if ln.startswith("repro_http_requests_total{")
          and 'status="200"' in ln]
    assert ok and float(ok[0].split()[-1]) >= 1


# -------------------------------------------------- websocket transport
def test_ws_streaming_session_equals_inprocess_lane(engine_portal):
    """A websocket stream == the in-process session lane, window for
    window, with every window pipelined before the first read."""
    srv, portal, c = engine_portal
    wins = windows(np.random.default_rng(9), 4, 4, c.n_axons)
    ws = WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
    for i, w in enumerate(wins):
        ws.send_window(counts=w, tag=f"t{i}")
    got = [ws.recv() for _ in range(len(wins))]
    ws.close()
    assert [g["window"] for g in got] == [0, 1, 2, 3]
    assert [g["tag"] for g in got] == ["t0", "t1", "t2", "t3"]
    ref = deploy(c, seed=0, device="cpu")
    ref.alloc_lanes(4)
    for w, g in zip(wins, got):
        spk, V = ref.run_lanes([ws.session], w[None])
        assert g["digest"] == result_digest(spk[0], V[0])
        np.testing.assert_array_equal(np.asarray(g["spikes"], bool), spk[0])
    _wait_lanes_free(srv, "m")


def test_ws_lane_exhaustion_is_http_503(engine_portal):
    srv, portal, c = engine_portal
    clients = [WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
               for _ in range(4)]
    try:
        with pytest.raises(PortalError) as ei:
            WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
        assert ei.value.status == 503 and ei.value.code == "E_NO_LANES"
    finally:
        for ws in clients:
            ws.close()
    _wait_lanes_free(srv, "m")


def test_ws_abrupt_disconnect_releases_lane(engine_portal):
    """A client vanishing mid-frame releases its lane: repeated abrupt
    disconnects never exhaust the 4 session slots."""
    srv, portal, c = engine_portal
    for _ in range(6):
        ws = WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
        ws.sock.sendall(b"\x81")              # half a frame header...
        ws.sock.close()                       # ...then vanish
    _wait_lanes_free(srv, "m")
    clients = [WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
               for _ in range(4)]
    for ws in clients:
        ws.close()
    _wait_lanes_free(srv, "m")


def test_ws_oversized_frame_rejected_with_close_1009(engine_portal):
    from repro_torch.portal.ws import MAX_FRAME_BYTES, OP_CLOSE

    srv, portal, c = engine_portal
    ws = WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
    ws.sock.sendall(bytes([0x81, 0x80 | 127])
                    + struct.pack(">Q", 2 * MAX_FRAME_BYTES))
    while True:
        opcode, payload = ws._read_frame()
        if opcode == OP_CLOSE:
            break
    assert struct.unpack(">H", payload[:2])[0] == 1009
    ws.sock.close()
    _wait_lanes_free(srv, "m")


# ------------------------------------------------ auth + quotas + 503s
def test_auth_and_quota_negative_paths():
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    srv.add_model("m", c, window=3, n_sessions=2, seed=0, device="cpu")
    tokens = {"good": TokenQuota(rate=1000.0, burst=1000, max_inflight=8,
                                 name="alice"),
              "slow": TokenQuota(rate=0.001, burst=1, max_inflight=8,
                                 name="bob"),
              "narrow": TokenQuota(rate=1000.0, burst=1000,
                                   max_inflight=0, name="carol")}
    w = windows(np.random.default_rng(0), 1, 3, c.n_axons)[0]
    run = {"counts": w.tolist()}
    with srv, Portal(srv, port=0, tokens=tokens) as portal:
        s, _, b = http_req(portal.port, "POST", "/v1/m/run", run)
        assert s == 401 and b["error"]["code"] == "E_AUTH"
        s, _, b = http_req(portal.port, "POST", "/v1/m/run", run,
                           token="wrong")
        assert s == 401 and b["error"]["code"] == "E_AUTH"
        with pytest.raises(PortalError) as ei:
            WSClient("127.0.0.1", portal.port, "m", token="wrong",
                     timeout=TIMEOUT)
        assert ei.value.status == 401
        s, _, b = http_req(portal.port, "GET", "/healthz")
        assert s == 200 and b["ok"]
        assert http_req(portal.port, "POST", "/v1/m/run", run,
                        token="good")[0] == 200
        assert http_req(portal.port, "POST", "/v1/m/run", run,
                        token="slow")[0] == 200
        s, h, b = http_req(portal.port, "POST", "/v1/m/run", run,
                           token="slow")
        assert s == 429 and b["error"]["code"] == "E_QUOTA_RATE"
        assert int(h["retry-after"]) >= 1 and b["error"]["retry_after_s"] > 0
        s, h, b = http_req(portal.port, "POST", "/v1/m/run", run,
                           token="narrow")
        assert s == 429 and b["error"]["code"] == "E_QUOTA_INFLIGHT"
        s, _, m = http_req(portal.port, "GET", "/metrics?format=json")
        assert m["clients"]["bob"]["rejected_rate"] == 1
        assert m["clients"]["carol"]["rejected_inflight"] == 1
        assert m["clients"]["alice"]["admitted"] == 1
        assert "good" not in m["clients"]
        s, _, text = http_req(portal.port, "GET", "/metrics")
        assert 'repro_token_rejected_total{token="bob",reason="rate"} 1' \
            in text


def test_backpressure_full_buffer_is_503_with_retry_after():
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0, max_pending=0)
    srv.add_model("m", c, window=3, n_sessions=0, seed=0, device="cpu")
    w = windows(np.random.default_rng(0), 1, 3, c.n_axons)[0]
    with pytest.raises(BufferFull):
        srv.submit("m", w)
    with Portal(srv, port=0) as portal:
        s, h, b = http_req(portal.port, "POST", "/v1/m/run",
                           {"counts": w.tolist()})
        assert s == 503 and b["error"]["code"] == "E_BACKPRESSURE"
        assert int(h["retry-after"]) >= 1 and b["error"]["retry_after_s"] > 0
        srv.shutdown()
        s, h, b = http_req(portal.port, "POST", "/v1/m/run",
                           {"counts": w.tolist()})
        assert s == 503 and b["error"]["code"] == "E_SHUTDOWN"
        assert int(h["retry-after"]) >= 1 and b["error"]["retry_after_s"] > 0


# ----------------------------------------------------- lane shapes
def test_portal_adds_zero_lane_shapes():
    """Serving the warmed window shapes through the portal runs no lane
    shape beyond the pow2 buckets the direct dispatches ran (the port's
    form of the zero-retrace check)."""
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=3.0)
    m = srv.add_model("m", c, window=4, n_sessions=0, seed=0,
                      device="cpu")
    rng = np.random.default_rng(5)
    zero = np.zeros((4, c.n_axons), np.int32)
    for B in (1, 2, 4, 8):
        m.dep.run_lanes([-1] * B, np.stack([zero] * B))
    before = compile_counts(m.dep.impl)
    reqs = {(cl, r): windows(rng, 1, 4, c.n_axons)[0]
            for cl in range(8) for r in range(2)}
    with srv, Portal(srv, port=0) as portal:
        def client(cl):
            for r in range(2):
                s, _, b = http_req(portal.port, "POST", "/v1/m/run",
                                   {"counts": reqs[(cl, r)].tolist(),
                                    "seed": cl * 10 + r})
                assert s == 200, b
        run_threads(client, 8)
    assert compile_counts(m.dep.impl) == before
    assert {B for B, _ in m.trace_shapes} <= {1, 2, 4, 8}


# ------------------------------------------------------ bridge workers
def test_bridge_worker_roundtrip(engine_portal):
    """One spawned torch-free front-end worker over the unix-socket
    bridge: same results as in-process, errors cross intact."""
    srv, _, c = engine_portal
    w = windows(np.random.default_rng(13), 1, 4, c.n_axons)[0]
    with Portal(srv, port=0, workers=1) as portal:
        s, _, health = http_req(portal.port, "GET", "/healthz")
        assert s == 200 and health["worker_pid"] != health["pid"]
        s, _, body = http_req(portal.port, "POST", "/v1/m/run",
                              {"counts": w.tolist(), "seed": 77})
        assert s == 200
        ref = srv.submit("m", w, seed=77).result(timeout=TIMEOUT)
        assert body["digest"] == result_digest(ref.spikes, ref.membrane)
        s, _, body = http_req(
            portal.port, "POST", "/v1/m/run",
            {"counts": np.zeros((4, c.n_axons + 3), int).tolist()})
        assert s == 400 and body["error"]["code"] == "E_SCHED_WIDTH"
        ws = WSClient("127.0.0.1", portal.port, "m", timeout=TIMEOUT)
        ws.send_window(counts=w)
        got = ws.recv()
        ws.close()
        assert got["digest"] == lane_ref(c, [ws.session], [w])[0]
        # the worker's metrics reach the dispatcher's scrape
        s, _, text = http_req(portal.port, "GET", "/metrics")
        assert "repro_http_requests_total_by_worker" in text
    _wait_lanes_free(srv, "m")


# ------------------------------------------------ fault tolerance
def test_healthz_503_down_when_dispatcher_dead():
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0, supervise=False)
    srv.add_model("m", c, window=3, n_sessions=0, seed=0, device="cpu")
    w = windows(np.random.default_rng(0), 1, 3, c.n_axons)[0]
    faults.install(faults.FaultPlan().arm("dispatch_crash", at=(1,)))
    try:
        with srv, Portal(srv, port=0) as portal:
            s, _, hz = http_req(portal.port, "GET", "/healthz")
            assert s == 200 and hz["status"] == "ok"
            s, _, b = http_req(portal.port, "POST", "/v1/m/run",
                               {"counts": w.tolist()})
            assert s == 500 and "injected fault" in b["error"]["message"]
            last = {}

            def down():
                last["r"] = http_req(portal.port, "GET", "/healthz")
                return last["r"][0] == 503
            poll(down, "healthz never answered 503")
            hz = last["r"][2]
            assert hz["status"] == "down" and hz["ok"] is False
            assert "unsupervised" in hz["reason"]
    finally:
        faults.uninstall()


def test_dispatch_restart_503_with_retry_after_then_recovers():
    """A supervised dispatcher crash is one structured 503
    E_DISPATCH_RESTART with Retry-After; the retried request returns the
    fault-free answer bit-exactly and healthz stays 200."""
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    srv.add_model("m", c, window=3, n_sessions=0, seed=0, device="cpu")
    w = windows(np.random.default_rng(2), 1, 3, c.n_axons)[0]
    run = {"counts": w.tolist(), "seed": 5}
    faults.install(faults.FaultPlan().arm("dispatch_crash", at=(1,)))
    try:
        with srv, Portal(srv, port=0) as portal:
            s, h, b = http_req(portal.port, "POST", "/v1/m/run", run)
            assert s == 503 and b["error"]["code"] == "E_DISPATCH_RESTART"
            assert int(h["retry-after"]) >= 1
            assert b["error"]["retry_after_s"] > 0
            last = {}

            def served():
                last["r"] = http_req(portal.port, "POST", "/v1/m/run", run)
                return last["r"][0] == 200
            poll(served, "the retried request was never served")
            assert last["r"][2]["digest"] == lane_ref(c, [-1], [w], [5])[0]
            s, _, hz = http_req(portal.port, "GET", "/healthz")
            assert s == 200 and hz["status"] in ("ok", "degraded")
            assert hz["restarts"] == 1
    finally:
        faults.uninstall()


def test_bridge_client_auto_reconnect(tmp_path):
    """Severed UDS: the in-flight non-idempotent `run` fails with the
    structured 503 E_BRIDGE_DOWN, an idempotent call across the drop is
    replayed on the redial, and later runs are bit-exact."""
    from repro_torch.portal.bridge import BridgeClient, BridgeServer
    from repro_torch.portal.gateway import LocalGateway

    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    srv.add_model("m", c, window=3, n_sessions=0, seed=0, device="cpu")
    w = windows(np.random.default_rng(4), 1, 3, c.n_axons)[0]
    uds = str(Path(tmp_path) / "bridge.sock")

    async def until(cond, what):
        t0 = time.monotonic()
        while not cond():
            assert time.monotonic() - t0 < TIMEOUT, what
            await asyncio.sleep(0.01)

    async def scenario():
        bs = await BridgeServer(LocalGateway(srv), uds).start()
        cl = await BridgeClient.open(uds, backoff_base_s=0.01)
        try:
            assert (await cl.healthz())["ok"]
            # the dispatcher is not started: the run waits in the queue,
            # in flight, when the transport is severed
            run_t = asyncio.ensure_future(
                cl.run("m", {"counts": w.tolist(), "seed": 1}))
            await until(lambda: srv._buf.stats()["pending"] == 1,
                        "the run never reached the server's queue")
            cl._writer.transport.abort()
            with pytest.raises(PortalError) as ei:
                await asyncio.wait_for(run_t, TIMEOUT)
            assert ei.value.status == 503
            assert ei.value.code == "E_BRIDGE_DOWN"
            assert (await asyncio.wait_for(cl.healthz(), TIMEOUT))["ok"]
            assert cl.drops >= 1 and cl.reconnects >= 1
            srv.start()
            out = await asyncio.wait_for(
                cl.run("m", {"counts": w.tolist(), "seed": 2}), TIMEOUT)
            assert out["digest"] == lane_ref(c, [-1], [w], [2])[0]
        finally:
            await cl.close()
            await bs.stop()

    try:
        asyncio.run(scenario())
    finally:
        srv.shutdown()


def test_portal_respawns_killed_worker():
    """SIGKILL one of two bridge front ends: the reaper respawns it
    (SO_REUSEPORT keeps the port), traffic keeps flowing bit-exactly,
    healthz returns to ok."""
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=2.0)
    srv.add_model("m", c, window=3, n_sessions=0, seed=0, device="cpu")
    w = windows(np.random.default_rng(6), 1, 3, c.n_axons)[0]
    with srv, Portal(srv, port=0, workers=2) as portal:
        first = list(portal._procs)
        direct = srv.submit("m", w, seed=3).result(timeout=TIMEOUT)
        ref = result_digest(direct.spikes, direct.membrane)
        portal._procs[0].kill()
        poll(lambda: portal.worker_restarts >= 1,
             "the killed worker was never respawned")
        for _ in range(6):
            s, _, b = retry_os(lambda: http_req(
                portal.port, "POST", "/v1/m/run",
                {"counts": w.tolist(), "seed": 3}))
            assert s == 200 and b["digest"] == ref
        s, _, hz = http_req(portal.port, "GET", "/healthz")
        assert s == 200 and hz["status"] == "ok"
        procs = first + list(portal._procs)
    assert all(p.poll() is not None for p in procs)   # none left behind


# --------------------------------------------- the two packages' portals
def _strip(body):
    """A JSON body without its timing fields (recursively)."""
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in TIMING}
    return body


def _cross_stream(port, wsclient, n_axons, edit):
    """One request stream through a portal; every JSON body it got."""
    rng = np.random.default_rng(31)
    out = []
    for r in range(3):                         # stateless runs
        w = windows(rng, 1, 3, n_axons)[0][:2 + r % 2]
        out.append(http_req(port, "POST", "/v1/m/run",
                            {"counts": w.tolist(), "seed": 10 + r}))
    out.append(http_req(port, "POST", "/v1/m/run",
                        {"events": [[0, 1], [2, 2], []], "seed": 3}))
    _, _, opened = http_req(port, "POST", "/v1/m/session")
    sid = opened["session"]
    out.append((200, {}, opened))
    ws = wsclient("127.0.0.1", port, "m", timeout=TIMEOUT)
    out.append((200, {}, ws.hello))
    for i in range(3):
        ws.send_window(counts=windows(rng, 1, 3, n_axons)[0], seed=i,
                       tag=i)
    out += [(200, {}, ws.recv()) for _ in range(3)]
    w = windows(rng, 1, 3, n_axons)[0]
    out.append(http_req(port, "POST", "/v1/m/run",
                        {"counts": w.tolist(), "session": sid}))
    out.append(http_req(port, "POST", "/v1/m/reconfigure", edit))
    ws.send_window(counts=windows(rng, 1, 3, n_axons)[0])
    out.append((200, {}, ws.recv()))
    ws.close()
    for r in range(2):                         # after the barrier
        w = windows(rng, 1, 3, n_axons)[0]
        out.append(http_req(port, "POST", "/v1/m/run",
                            {"counts": w.tolist(), "seed": 20 + r}))
    out.append(http_req(port, "POST", "/v1/m/run",
                        {"counts": w.tolist(), "session": sid}))
    out.append(http_req(port, "GET", f"/v1/m/session/{sid}"))
    out.append(http_req(port, "POST", f"/v1/m/session/{sid}/reset"))
    out.append(http_req(port, "GET", f"/v1/m/session/{sid}"))
    out.append(http_req(port, "DELETE", f"/v1/m/session/{sid}"))
    out.append(http_req(port, "POST", "/v1/m/run",
                        {"counts": np.zeros((3, n_axons + 2),
                                            int).tolist()}))
    out.append(http_req(port, "GET", f"/v1/m/session/{sid}"))
    return [(s, _strip(b)) for s, _, b in out]


@pytest.mark.parametrize("backend,fused", CROSS)
def test_portal_stream_matches_jax_portal(backend, fused):
    """One stream through `repro.portal` over a JAX server and through
    the port's portal: the same statuses, digests and JSON bodies apart
    from the timing fields."""
    jc, tc = small_pair(backend)
    post = int(tc.syn_post[0])
    w0 = int(deploy(tc, device="cpu").read_synapses([-1], [post])[0])
    edit = {"pre": [-1], "post": [post], "weight": [w0 + 4]}
    jsrv = JServer(max_batch=4, max_wait_ms=1.0)
    jsrv.add_model("m", jc, window=3, n_sessions=2, seed=0,
                   **({"use_pallas": True} if fused else {}))
    tsrv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    tsrv.add_model("m", tc, window=3, n_sessions=2, seed=0, fused=fused,
                   device="cpu")
    got = {}
    for name, srv, portal_cls, ws_cls in (
            ("jax", jsrv, JPortal, JWSClient),
            ("torch", tsrv, Portal, WSClient)):
        with srv, portal_cls(srv, port=0) as portal:
            got[name] = _cross_stream(portal.port, ws_cls, tc.n_axons, edit)
    assert [s for s, _ in got["torch"]] == [s for s, _ in got["jax"]]
    assert [s for s, _ in got["jax"]].count(200) == len(got["jax"]) - 2
    for i, (t, j) in enumerate(zip(got["torch"], got["jax"])):
        assert t == j, (backend, fused, i, t, j)
    assert tsrv.models["m"].sessions.n_open == 0


# ---------------------------------------------------- the entry points
def _jax_demo_digest(counts, seed, sessions=False):
    """JAX's demo network (`python -m repro.portal`'s) run on a scratch
    lane under `seed`: the digest the port's CLI must answer with."""
    from repro.core.deploy import deploy as j_deploy
    from repro.portal.gateway import result_digest as j_digest
    from repro.serve.__main__ import demo_spec as j_demo_spec
    dep = j_deploy(j_compile(j_demo_spec(16, 64), target="engine"), seed=0)
    dep.alloc_lanes(1)
    w = np.zeros((8, 16), np.int32)
    w[:counts.shape[0]] = counts
    spk, V = dep.run_lanes([-1], w[None], seeds=[seed])
    return j_digest(spk[0, :counts.shape[0]], V[0])


@pytest.mark.parametrize("workers", [0, 2])
def test_portal_cli_serves_until_sigint(workers):
    """`python -m repro_torch.portal --device cpu --port 0` (in-process
    and with bridged workers) answers with JAX's digest for the same
    request and drains cleanly on SIGINT."""
    import os
    import queue
    import signal
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.portal", "--device", "cpu",
         "--port", "0", "--workers", str(workers)],
        env=env, cwd=str(root), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        head = ""
        while "portal serving model" not in head:   # past any warnings
            head = lines.get(timeout=TIMEOUT)
        assert "portal serving model 'demo' (engine on cpu" in head, head
        port = int(head.split("http://127.0.0.1:")[1].split()[0])
        s, _, hz = http_req(port, "GET", "/healthz")
        assert s == 200 and hz["models"]["demo"]["n_neurons"] == 64
        assert (hz["worker_pid"] != hz["pid"]) == bool(workers)
        counts = np.random.default_rng(2).integers(0, 2, (5, 16))
        s, _, body = http_req(port, "POST", "/v1/demo/run",
                              {"counts": counts.tolist(), "seed": 9})
        assert s == 200 and body["steps"] == 5
        assert body["digest"] == _jax_demo_digest(counts, 9)
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=TIMEOUT)
    reader.join(timeout=TIMEOUT)
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    assert rc == 0, rest
    assert any("dispatcher drained" in ln for ln in rest), rest


def test_portal_cli_mesh_under_torchrun_drains_on_sigint():
    """`torchrun --nproc-per-node 4 -m repro_torch.portal --backend mesh`:
    rank 0 runs the portal and leads, the other ranks replay; a request
    gets JAX's digest (the demo network's spikes do not depend on the
    hierarchy). SIGINT to every rank, followers first (a terminal's
    Ctrl-C reaches each rank), drains rank 0, whose stop record releases
    the followers: every rank exits 0, so torchrun does."""
    import os
    import queue
    import signal
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.portal", "--device",
         "cpu", "--backend", "mesh", "--port", "0"],
        env=env, cwd=str(root), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        head, t0 = "", time.monotonic()
        while "portal serving model" not in head:   # past any warnings
            try:
                head = lines.get(timeout=1)
            except queue.Empty:
                assert proc.poll() is None and time.monotonic() - t0 < 120, \
                    f"torchrun did not start the portal: rc {proc.poll()}"
        assert "(mesh on cpu, 4 ranks" in head, head
        port = int(head.split("http://127.0.0.1:")[1].split()[0])
        s, _, hz = http_req(port, "GET", "/healthz")
        assert s == 200 and hz["ok"], hz
        counts = np.random.default_rng(4).integers(0, 2, (6, 16))
        s, _, body = http_req(port, "POST", "/v1/demo/run",
                              {"counts": counts.tolist(), "seed": 9})
        assert s == 200 and body["digest"] == _jax_demo_digest(counts, 9)
        ranks = [int(pid) for f in Path(f"/proc/{proc.pid}/task").glob(
            "*/children") for pid in f.read_text().split()]
        assert len(ranks) == 4 and hz["pid"] in ranks, (ranks, hz["pid"])
        for pid in sorted(ranks, key=lambda p: p == hz["pid"]):
            os.kill(pid, signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=TIMEOUT)
    reader.join(timeout=TIMEOUT)
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    assert rc == 0, rest
    assert any("dispatcher drained" in ln for ln in rest), rest


def test_serve_example_over_the_portal_matches_in_process():
    """`examples/torch_serve_snn.py --portal` streams every client over
    a websocket and reports the same per-lane spike rates and membranes
    as the in-process run (`--portal-workers 2` in front)."""
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    outs = {}
    for extra in ([], ["--portal", "--portal-workers", "2"]):
        p = subprocess.run(
            [sys.executable, str(root / "examples" / "torch_serve_snn.py"),
             "--device", "cpu", "--clients", "4", "--samples", "2",
             "--shape", "6", "--neurons", "32"] + extra,
            env=env, cwd=str(root), capture_output=True, text=True,
            timeout=120)
        assert p.returncode == 0, p.stdout + p.stderr[-3000:]
        outs[bool(extra)] = sorted(
            ln.split(":", 1)[1] for ln in p.stdout.splitlines()
            if ln.strip().startswith("client "))
    assert len(outs[True]) == 4 and outs[True] == outs[False]
    assert "websocket streams through the web portal" in p.stdout
