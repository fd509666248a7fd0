"""The port's serving tier (`repro_torch.serve`) against `repro.serve`.

The same seeded request streams go through a JAX-backed `SpikeServer`
and the port's (``device="cpu"``, the kernels' plain versions): the
per-request `result_digest`s agree on the engine, the fused engine and
the simulator, and equal serial `run_lanes` on the port whatever
micro-batch a request rode in. Then the server's own contracts, as
`tests/test_serve.py` and `tests/test_retrace.py` pin them for `repro`:
the session lifecycle and window contract, batching only within a model,
`next_pow2`, reconfiguration as a barrier (engine == simulator == JAX),
`add_model` on the card by default, and the lane path's shape bound.
"""
import math
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core.api import LIF_neuron as JLIF
from repro.core.compile import compile_spec as j_compile
from repro.core.spec import NetworkSpec as JSpec
from repro.portal.gateway import result_digest as j_digest
from repro.serve import SpikeServer as JServer
from repro_torch import LIF_neuron as TLIF
from repro_torch import NetworkSpec as TSpec
from repro_torch import compile_spec as t_compile
from repro_torch.analysis.retrace import (RetraceDetector, RetraceError,
                                          compile_counts)
from repro_torch.core.deploy import deploy
from repro_torch.portal.gateway import result_digest
from repro_torch.serve import SpikeServer, next_pow2

# (backend, fused): the engine, the fused engine, the simulator
BACKENDS = [("engine", False), ("engine", True), ("simulator", False)]
TIMEOUT = 120


def _spec(spec_cls, lif, n_axons, n_neurons, seed):
    """Half quiet, half noisy LIF neurons (nu = -14: noise in +-4), so
    each lane's threefry stream shows in its spikes."""
    rng = np.random.default_rng(seed)
    spec = spec_cls()
    ax = spec.add_axons(n_axons)
    half = n_neurons // 2
    spec.add_neurons(half, lif(threshold=5, nu=-32, lam=50))
    spec.add_neurons(n_neurons - half, lif(threshold=5, nu=-14, lam=50))
    nid = np.arange(n_neurons)
    pre = np.concatenate([np.repeat(ax, 4), np.repeat(nid, 3)])
    post = rng.integers(0, n_neurons, pre.shape[0])
    w = rng.integers(-3, 7, pre.shape[0])
    spec.connect(pre, post, w)
    spec.set_outputs(list(range(4)))
    return spec


def small_pair(backend, n_axons=5, n_neurons=12, seed=3):
    """(repro artifact, repro_torch artifact) of one network built from
    one numpy seed, compiled for `backend` in each package."""
    return (j_compile(_spec(JSpec, JLIF, n_axons, n_neurons, seed),
                      target=backend),
            t_compile(_spec(TSpec, TLIF, n_axons, n_neurons, seed),
                      target=backend))


def windows(rng, B, T, A):
    return rng.integers(0, 2, (B, T, A)).astype(np.int32)


def digest(res):
    return result_digest(res.spikes, res.membrane)


def add_pair(jsrv, tsrv, name, backend, fused, **kw):
    """Make the same network resident in a JAX and a port server."""
    jc, tc = small_pair(backend)
    jsrv.add_model(name, jc, use_pallas=fused, **kw)
    tsrv.add_model(name, tc, fused=fused, device="cpu", **kw)
    return tc


def serve_clients(srv, model, reqs, n_sess, n_clients, n_req):
    """Concurrent clients: clients < n_sess hold a session (opened here,
    in order, so the lanes are the same in every server), the rest send
    stateless requests with seed cl * 100 + r. Returns {(cl, r):
    ServeResult} and {cl: session lane}."""
    lanes = {cl: srv.open_session(model) for cl in range(n_sess)}
    results, errors = {}, []

    def client(cl):
        try:
            for r in range(n_req):
                results[(cl, r)] = srv.submit(
                    model, reqs[(cl, r)], session=lanes.get(cl),
                    seed=cl * 100 + r).result(timeout=TIMEOUT)
        except Exception as e:     # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(cl,))
          for cl in range(n_clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errors, errors
    for sid in lanes.values():
        srv.close_session(model, sid)
    return results, lanes


# ------------------------------------------------------ served results
@pytest.mark.parametrize("backend,fused", BACKENDS)
def test_served_digests_match_jax_and_serial(backend, fused):
    """8 concurrent clients (4 sessions, 4 scratch, 3 requests each,
    window 4) through a JAX server and the port's: every response has
    the same digest in both, and equals the same request run alone on
    the port (sessions on their lane, scratch requests by their seed)."""
    T, n_req = 4, 3
    jsrv = JServer(max_batch=8, max_wait_ms=4.0)
    tsrv = SpikeServer(max_batch=8, max_wait_ms=4.0)
    tc = add_pair(jsrv, tsrv, "m", backend, fused, window=T,
                  n_sessions=4, seed=0)
    rng = np.random.default_rng(7)
    reqs = {(cl, r): windows(rng, 1, T, tc.n_axons)[0]
            for cl in range(8) for r in range(n_req)}
    out = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # many more thread switches
    try:
        for name, srv in (("jax", jsrv), ("torch", tsrv)):
            with srv:
                out[name], lanes = serve_clients(srv, "m", reqs, 4, 8,
                                                 n_req)
            assert srv.stats()["requests"] == 8 * n_req
    finally:
        sys.setswitchinterval(switch)
    assert {k: j_digest(r.spikes, r.membrane)
            for k, r in out["jax"].items()} == \
        {k: digest(r) for k, r in out["torch"].items()}

    ref = deploy(tc, seed=0, fused=fused, device="cpu")
    ref.alloc_lanes(4)
    for cl in range(8):
        lane = lanes.get(cl, -1)
        for r in range(n_req):
            seeds = None if lane >= 0 else [cl * 100 + r]
            spk, V = ref.run_lanes([lane], reqs[(cl, r)][None],
                                   seeds=seeds)
            got = out["torch"][(cl, r)]
            np.testing.assert_array_equal(got.spikes, spk[0])
            np.testing.assert_array_equal(got.membrane, V[0])
            assert got.batch_size >= 1 and got.model == "m"


# --------------------------------------------------- server behaviour
def test_session_lifecycle_and_window_contract():
    _, c = small_pair("simulator")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    srv.add_model("m", c, window=4, n_sessions=2, seed=0, device="cpu")
    w = windows(np.random.default_rng(2), 1, 4, c.n_axons)[0]
    with srv:
        sid = srv.open_session("m")
        srv.submit("m", w, session=sid).result(timeout=TIMEOUT)
        V = srv.session_membrane("m", sid)
        srv.reset_session("m", sid)                  # back to V = 0
        assert not srv.session_membrane("m", sid).any()
        r2 = srv.submit("m", w, session=sid).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(r2.membrane, V)   # same stream
        with pytest.raises(ValueError, match="fill the 4-step"):
            srv.submit("m", w[:2], session=sid)
        with pytest.raises(ValueError, match="split it across"):
            srv.submit("m", np.zeros((9, c.n_axons), np.int32))
        # short STATELESS requests are padded and sliced
        short = srv.submit("m", w[:2]).result(timeout=TIMEOUT)
        assert short.spikes.shape[0] == 2
        srv.close_session("m", sid)
        with pytest.raises(KeyError, match="unknown session"):
            srv.submit("m", w, session=sid)
        srv.open_session("m"), srv.open_session("m")
        with pytest.raises(RuntimeError, match="no free session"):
            srv.open_session("m")
        with pytest.raises(KeyError, match="no resident model"):
            srv.submit("nope", w)


def test_server_batches_only_within_model():
    """Two resident models: batches never mix them, and both serve."""
    _, ce = small_pair("engine")
    _, cs = small_pair("simulator", n_axons=3, n_neurons=6)
    srv = SpikeServer(max_batch=8, max_wait_ms=3.0)
    srv.add_model("e", ce, window=3, n_sessions=0, device="cpu")
    srv.add_model("s", cs, window=3, n_sessions=0, device="cpu")
    rng = np.random.default_rng(5)
    with srv:
        fe = [srv.submit("e", windows(rng, 1, 3, ce.n_axons)[0], seed=i)
              for i in range(3)]
        fs = [srv.submit("s", windows(rng, 1, 3, cs.n_axons)[0], seed=i)
              for i in range(3)]
        re_ = [f.result(timeout=TIMEOUT) for f in fe]
        rs = [f.result(timeout=TIMEOUT) for f in fs]
    assert all(r.spikes.shape[1] == ce.n_neurons for r in re_)
    assert all(r.spikes.shape[1] == cs.n_neurons for r in rs)
    models = srv.stats()["models"]
    assert models["e"]["requests"] == 3 and models["s"]["requests"] == 3
    assert sum(srv.batch_sizes) == 6
    for name in ("e", "s"):
        assert all(B <= 4 for B, _ in models[name]["batch_shapes"])


def test_next_pow2():
    assert [next_pow2(i) for i in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError, match="positive"):
        next_pow2(0)


def _reconfigure_history(srv, c):
    """Serve 4 requests, reconfigure, serve 4 more (all in flight
    together); returns the served results and the edit."""
    T = 4
    reqs = windows(np.random.default_rng(11), 8, T, c.n_axons)
    pre, post = [-1], [int(c.syn_post[0])]
    w_new = int(c.syn_weight[0]) + 2
    srv.add_model("m", c, window=T, n_sessions=0, seed=0,
                  **({} if isinstance(srv, JServer) else
                     {"device": "cpu"}))
    with srv:
        before = [srv.submit("m", reqs[i], seed=i) for i in range(4)]
        fut_rc = srv.reconfigure("m", pre, post, [w_new])
        after = [srv.submit("m", reqs[i], seed=i) for i in range(4, 8)]
        got = [f.result(timeout=TIMEOUT) for f in before + after]
        assert fut_rc.result(timeout=TIMEOUT) >= 1      # applied, counted
    return got, reqs, (pre, post, [w_new])


def test_reconfigure_while_serving_engine_simulator_and_jax_agree():
    """A reconfiguration in flight lands between batches: the served
    history equals serial execution on the port's engine and simulator,
    and engine == simulator == JAX's engine, bit for bit."""
    hist = {}
    for backend in ("engine", "simulator"):
        _, c = small_pair(backend)
        got, reqs, edit = _reconfigure_history(
            SpikeServer(max_batch=4, max_wait_ms=3.0), c)
        # serial reference on a fresh compile (the served artifact's
        # weight column was edited in place)
        ref = deploy(small_pair(backend)[1], seed=0, device="cpu")
        for i, g in enumerate(got):
            if i == 4:
                ref.write_synapses(*edit)
            spk, V = ref.run_lanes([-1], reqs[i][None], seeds=[i])
            np.testing.assert_array_equal(g.spikes, spk[0])
            np.testing.assert_array_equal(g.membrane, V[0])
        hist[backend] = [digest(g) for g in got]
    jc, _ = small_pair("engine")
    got, _, _ = _reconfigure_history(JServer(max_batch=4, max_wait_ms=3.0),
                                     jc)
    hist["jax"] = [j_digest(g.spikes, g.membrane) for g in got]
    assert hist["engine"] == hist["simulator"] == hist["jax"]
    assert len(set(hist["engine"])) > 1


def test_add_model_deploys_on_the_card_by_default():
    """Without device="cpu" a model goes to the card; with no card the
    deploy raises and nothing falls back to the CPU."""
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=2)
    if torch.cuda.is_available():
        assert srv.add_model("m", c, window=2).dep.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            srv.add_model("m", c, window=2)
        assert "m" not in srv.models
    m = srv.add_model("cpu", c, window=2, device="cpu")
    assert m.dep.device.type == "cpu"


# ----------------------------------------------------- the shape bound
def test_retrace_detector_finds_lane_paths():
    with pytest.raises(ValueError, match="no lane-path"):
        RetraceDetector.of(object())
    for backend in ("engine", "simulator", "hiaer", "mesh"):
        dep = deploy(small_pair(backend)[1], device="cpu")
        assert compile_counts(dep.impl) == {
            (type(dep.impl).__name__, "run_lanes"): 0}
        det = RetraceDetector.of(dep.impl)
        dep.alloc_lanes(2)
        dep.run_lanes([0, -1], np.zeros((2, 3, 5), np.int32))
        with pytest.raises(RetraceError, match="run_lanes"):
            det.assert_no_retrace()
        det.snapshot()
        dep.run_lanes([1, 0], np.ones((2, 3, 5), np.int32))
        det.assert_no_retrace()


def test_serving_session_stays_within_log2_bmax_plus_one_shapes():
    """Fluctuating client bursts stay within log2(B_max) + 1 lane-path
    shapes (pow2 buckets at a fixed window), and a replay pass over the
    same shapes adds none — the port's form of tests/test_retrace.py."""
    max_batch = 8
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=max_batch, max_wait_ms=3.0)
    srv.add_model("m", c, window=3, n_sessions=2, device="cpu")
    rng = np.random.default_rng(0)

    def burst(n):
        futs = [srv.submit("m", windows(rng, 1, 3, c.n_axons)[0], seed=i)
                for i in range(n)]
        for f in futs:
            f.result(timeout=TIMEOUT)

    impl = srv.models["m"].dep.impl
    with srv:
        for n in (1, 5, 3, 8, 2, 7, 4, 6):       # fluctuating load
            burst(n)
        lane = {k: v for k, v in compile_counts(impl).items()
                if "lanes" in k[1]}
        bound = int(math.log2(max_batch)) + 1
        assert lane and sum(lane.values()) <= bound, lane
        assert srv.stats()["models"]["m"]["batch_shapes"] == \
            sorted(impl.lane_shapes)
        det = RetraceDetector.of(impl)
        for n in (8, 1, 6, 3):                   # warm shapes: replay
            burst(n)
        det.assert_no_retrace()
