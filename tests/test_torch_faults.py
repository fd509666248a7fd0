"""The port's fault injection (`repro_torch.faults`) and its serving
tier's recovery, against `repro`'s.

A `FaultPlan` fires the same hits in both packages for one spec and
seed; under the chaos matrix of tests/test_fault_tolerance.py the port
server's surviving responses carry the JAX server's fault-free digests,
every future settles and no lane leaks; the supervisor replays
deterministically (and as JAX's does), the restart budget ends in DOWN,
an unsupervised crash settles its in-flight batch, concurrent shutdowns
run once, and `checkpoint()`/`restore()` resume sessions bit-exact —
within the port and across the two packages, both ways.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from repro import faults as jfaults
from repro.portal.gateway import result_digest as j_digest
from repro.serve import DispatchRestart as JDispatchRestart
from repro.serve import SpikeServer as JServer
from repro_torch import faults
from repro_torch.analysis.retrace import compile_counts
from repro_torch.core.deploy import deploy
from repro_torch.portal.gateway import result_digest
from repro_torch.serve import BufferClosed, DispatchRestart, SpikeServer
from test_torch_serve import TIMEOUT, digest, small_pair, windows

CHAOS_SPECS = [
    "dispatch_crash@2",
    "batch_exception@3",
    "slow_batch@2:delay=0.3",
    "dispatch_crash@1;batch_exception@4",
]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test leaves both packages' global hooks disarmed."""
    yield
    faults.uninstall()
    jfaults.uninstall()


# ---------------------------------------------------------- the plans
def _trace(plan, sites, n):
    """What `fire` does on each of n rounds over `sites`: True/False, or
    the hit index of a raised InjectedFault."""
    out = []
    for _ in range(n):
        for site in sites:
            try:
                out.append(plan.fire(site))
            except (faults.InjectedFault, jfaults.InjectedFault) as e:
                out.append(("raised", e.site, e.hit))
    return out


@pytest.mark.parametrize("spec,seed", [
    ("dispatch_crash@2,5;bridge_drop%0.3;slow_batch@1:delay=0", 7),
    ("batch_exception%0.2;bridge_drop@3,4;dispatch_crash%0.05", 0),
    ("slow_batch%0.5:delay=0;bridge_drop%0.9", 123),
])
def test_fault_plan_fires_the_same_hits_as_jax(spec, seed):
    sites = ["dispatch_crash", "batch_exception", "slow_batch",
             "bridge_drop"]
    tp = faults.FaultPlan.from_spec(spec, seed=seed)
    jp = jfaults.FaultPlan.from_spec(spec, seed=seed)
    assert tp.spec() == jp.spec()
    assert faults.FaultPlan.from_spec(tp.spec(), seed=seed).spec() == \
        tp.spec()
    got = _trace(tp, sites, 60)
    assert got == _trace(jp, sites, 60)
    assert tp.stats() == jp.stats()
    assert any(g not in (False,) for g in got)
    assert faults.SITES == jfaults.SITES
    # no plan installed: the hook is a cheap no-op
    assert faults.fire("dispatch_crash") is False
    with pytest.raises(ValueError):
        faults.FaultPlan().arm("not_a_site")


def test_fault_plan_ndjson_log_records_triggers(tmp_path):
    log = tmp_path / "faults.ndjson"
    p = faults.FaultPlan(log_path=str(log)).arm("bridge_drop", at=(2,))
    p.fire("bridge_drop")
    p.fire("bridge_drop", batch=4)
    recs = [json.loads(ln) for ln in log.read_text().strip().splitlines()]
    assert len(recs) == 1
    assert recs[0]["site"] == "bridge_drop" and recs[0]["hit"] == 2
    assert recs[0]["batch"] == 4 and recs[0]["pid"] == os.getpid()


def test_install_from_env_arms_the_plan(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "bridge_drop@1")
    monkeypatch.setenv("REPRO_FAULTS_SEED", "5")
    plan = faults.install_from_env()
    assert faults.current() is plan and plan.seed == 5
    assert faults.fire("bridge_drop") is True
    monkeypatch.delenv("REPRO_FAULTS")
    faults.uninstall()
    assert faults.install_from_env() is None


# --------------------------------------------------- the chaos matrix
def _stream(n_axons):
    """4 scratch and 4 session clients, 2 windows each (window 3)."""
    rng = np.random.default_rng(11)
    return {kind: {cl: [windows(rng, 1, 3, n_axons)[0] for _ in range(2)]
                   for cl in range(4)} for kind in ("scratch", "session")}


def _retry_result(srv, w, seed, futs, session=None, tries=8):
    """Submit-and-retry: an injected rejection is safe to resubmit."""
    for _ in range(tries):
        fut = srv.submit("m", w, seed=seed, session=session)
        futs.append(fut)
        try:
            return fut.result(timeout=TIMEOUT)
        except (DispatchRestart, JDispatchRestart, faults.InjectedFault,
                jfaults.InjectedFault):
            time.sleep(0.05)
    raise AssertionError("request never succeeded after retries")


def _drive(srv, stream, futs):
    """The 8 clients concurrently; sessions opened in order first, so a
    client gets the same lane in every server. Returns {(kind, cl, r):
    ServeResult}."""
    sids = {cl: srv.open_session("m") for cl in range(4)}
    out, errors = {}, []

    def client(kind, cl):
        try:
            for r, w in enumerate(stream[kind][cl]):
                out[(kind, cl, r)] = _retry_result(
                    srv, w, seed=cl * 100 + r if kind == "scratch" else 0,
                    futs=futs,
                    session=sids[cl] if kind == "session" else None)
            if kind == "session":
                srv.close_session("m", sids[cl])
        except Exception as e:     # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(kind, cl))
          for kind in ("scratch", "session") for cl in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errors, errors
    return out


@pytest.fixture(scope="module")
def jax_fault_free():
    """The JAX server's digests of the chaos stream, no plan armed."""
    jc, _ = small_pair("engine")
    srv = JServer(max_batch=8, max_wait_ms=2.0)
    srv.add_model("m", jc, window=3, n_sessions=4, seed=0)
    stream = _stream(jc.n_axons)
    with srv:
        out = _drive(srv, stream, [])
        post = srv.submit("m", stream["scratch"][0][0], seed=999).result(
            timeout=TIMEOUT)
    digests = {k: j_digest(r.spikes, r.membrane) for k, r in out.items()}
    digests["post"] = j_digest(post.spikes, post.membrane)
    return digests


@pytest.mark.parametrize("plan_spec", CHAOS_SPECS)
def test_chaos_matrix_survivors_match_jax_fault_free(plan_spec,
                                                     jax_fault_free):
    """8 concurrent clients through an armed plan on the port's server:
    every surviving response carries the JAX server's fault-free digest,
    every future settles, every lane returns, and recovery runs no new
    lane-path shape beyond the warmed buckets."""
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=2.0)
    m = srv.add_model("m", c, window=3, n_sessions=4, seed=0, device="cpu")
    zero = np.zeros((3, c.n_axons), np.int32)
    for B in (1, 2, 4, 8):
        m.dep.run_lanes([-1] * B, np.stack([zero] * B))
    m.dep.reset()
    before = compile_counts(m.dep.impl)
    stream = _stream(c.n_axons)

    faults.install(faults.FaultPlan.from_spec(plan_spec, seed=3))
    futs = []
    with srv:
        out = _drive(srv, stream, futs)
        post = _retry_result(srv, stream["scratch"][0][0], seed=999,
                             futs=futs)
    faults.uninstall()

    assert all(f.done() for f in futs)
    assert m.sessions.n_open == 0
    got = {k: digest(r) for k, r in out.items()}
    got["post"] = digest(post)
    assert got == jax_fault_free
    assert compile_counts(m.dep.impl) == before
    if "dispatch_crash" in plan_spec:
        assert srv.health()["restarts"] >= 1


def _replay_pass(make_server, fault_mod, digest_fn):
    srv, n_axons = make_server()
    fault_mod.install(fault_mod.FaultPlan.from_spec("dispatch_crash@2",
                                                    seed=0))
    rng = np.random.default_rng(0)
    outcomes = []
    try:
        with srv:
            for r in range(5):
                w = windows(rng, 1, 3, n_axons)[0]
                try:
                    res = srv.submit("m", w, seed=r).result(
                        timeout=TIMEOUT)
                    outcomes.append(("ok", digest_fn(res.spikes,
                                                     res.membrane)))
                except Exception as e:   # noqa: BLE001 — outcome record
                    outcomes.append((type(e).__name__,
                                     getattr(e, "restart", None)))
            outcomes.append(("restarts", srv.health()["restarts"]))
    finally:
        fault_mod.uninstall()
    return outcomes


def test_supervisor_restart_is_deterministic_replay_and_matches_jax():
    def port_server():
        _, c = small_pair("engine")
        srv = SpikeServer(max_batch=8, max_wait_ms=2.0)
        srv.add_model("m", c, window=3, n_sessions=4, seed=0,
                      device="cpu")
        return srv, c.n_axons

    def jax_server():
        jc, _ = small_pair("engine")
        srv = JServer(max_batch=8, max_wait_ms=2.0)
        srv.add_model("m", jc, window=3, n_sessions=4, seed=0)
        return srv, jc.n_axons

    first = _replay_pass(port_server, faults, result_digest)
    assert first == _replay_pass(port_server, faults, result_digest)
    assert ("DispatchRestart", 1) in first
    assert first == _replay_pass(jax_server, jfaults, j_digest)


def test_dispatcher_down_after_restart_budget():
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=2.0, max_restarts=0)
    srv.add_model("m", c, window=3, n_sessions=4, device="cpu")
    w = windows(np.random.default_rng(0), 1, 3, c.n_axons)[0]
    faults.install(faults.FaultPlan().arm("dispatch_crash", at=(1,)))
    with srv:
        with pytest.raises(DispatchRestart):
            srv.submit("m", w).result(timeout=TIMEOUT)
        deadline = time.monotonic() + 30
        while srv.health()["status"] != "down" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        hz = srv.health()
        assert hz["status"] == "down" and hz["ok"] is False
        assert "max_restarts" in hz["reason"]
        with pytest.raises(BufferClosed):
            srv.submit("m", w)


def test_unsupervised_crash_settles_inflight_and_reports_down():
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=2.0, supervise=False)
    srv.add_model("m", c, window=3, n_sessions=4, device="cpu")
    w = windows(np.random.default_rng(1), 1, 3, c.n_axons)[0]
    faults.install(faults.FaultPlan().arm("dispatch_crash", at=(1,)))
    with srv:
        with pytest.raises(faults.InjectedFault):
            srv.submit("m", w).result(timeout=TIMEOUT)
        deadline = time.monotonic() + 30
        while srv.health()["status"] != "down" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        hz = srv.health()
        assert hz["status"] == "down" and hz["ok"] is False
        assert hz["restarts"] == 0


def test_shutdown_concurrent_callers_once_guarded():
    _, c = small_pair("engine")
    srv = SpikeServer(max_batch=8, max_wait_ms=2.0)
    srv.add_model("m", c, window=3, n_sessions=4, device="cpu")
    w = windows(np.random.default_rng(2), 1, 3, c.n_axons)[0]
    srv.start()
    futs = [srv.submit("m", w, seed=i) for i in range(4)]
    errs = []

    def caller():
        try:
            srv.shutdown(drain=True)
        except Exception as e:     # noqa: BLE001 — assert below
            errs.append(e)

    ts = [threading.Thread(target=caller) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errs, errs
    assert all(f.done() for f in futs)
    srv.start()                     # restartable after a full shutdown
    assert srv.submit("m", w, seed=9).result(timeout=TIMEOUT) is not None
    srv.shutdown()


# ------------------------------------------------- checkpoint/restore
def _ckpt_server(pkg, backend="engine"):
    jc, tc = small_pair(backend)
    if pkg == "jax":
        srv = JServer(max_batch=4, max_wait_ms=1.0)
        srv.add_model("m", jc, window=3, n_sessions=4, seed=0)
    else:
        srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
        srv.add_model("m", tc, window=3, n_sessions=4, seed=0,
                      device="cpu")
    return srv, tc


def _ckpt_windows(n_axons):
    rng = np.random.default_rng(23)
    return [windows(rng, 1, 3, n_axons)[0] for _ in range(6)]


def _edit(tc):
    post = int(tc.syn_post[0])
    w = int(deploy(tc, device="cpu").read_synapses([-1], [post])[0]) + 2
    return [-1], [post], [w]


def _serve_session(srv, wins, edit, sid=None, edit_at=2):
    """Windows on one session (opened unless given), the weight edit
    before window `edit_at`; returns the digests."""
    sid = srv.open_session("m") if sid is None else sid
    out = []
    for i, w in enumerate(wins):
        if i == edit_at:
            srv.reconfigure("m", *edit).result(timeout=TIMEOUT)
        res = srv.submit("m", w, session=sid).result(timeout=TIMEOUT)
        out.append(result_digest(res.spikes, res.membrane))
    return sid, out


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_checkpoint_restore_sessions_resume_bit_exact(tmp_path, writer,
                                                      reader):
    """3 windows (a weight edit before the third) -> checkpoint -> a
    FRESH server restores -> 3 more windows == 6 uninterrupted windows,
    with the session id unchanged; the writer and reader may be either
    package (same leaves, dtypes and aux), and the restored lane keys
    are the uint32 words the writer saved."""
    ref_srv, tc = _ckpt_server(reader)
    wins = _ckpt_windows(tc.n_axons)
    edit = _edit(tc)
    with ref_srv:
        sid, ref = _serve_session(ref_srv, wins, edit)

    srv_a, _ = _ckpt_server(writer)
    with srv_a:
        sid_a, first = _serve_session(srv_a, wins[:3], edit)
        aux = srv_a.checkpoint(tmp_path / "ck")
    assert sid_a == sid and first == ref[:3]
    assert aux["models"]["m"]["sessions"][0]["id"] == sid
    saved = srv_a.models["m"].dep.lane_state()

    srv_b, _ = _ckpt_server(reader)
    srv_b.restore(tmp_path / "ck")
    state = srv_b.models["m"].dep.lane_state()
    assert state["keys"].dtype == np.uint32
    np.testing.assert_array_equal(state["keys"], saved["keys"])
    np.testing.assert_array_equal(state["V"], saved["V"])
    assert srv_b.models["m"].reconfig_applied == 1
    with srv_b:
        _, rest = _serve_session(srv_b, wins[3:], edit, sid=sid,
                                 edit_at=-1)
        assert srv_b.open_session("m") != sid
    assert rest == ref[3:]


# ----------------------------------------------------- portal smoke
def test_portal_smoke_cli_respawns_worker_and_matches_jax(tmp_path):
    """`python -m repro_torch.faults portal-smoke --workers 2` with a
    `worker_exit` plan: a front-end worker hard-exits mid-traffic, the
    reaper respawns it, the CLI exits 0, and every answer carries the
    JAX server's digest for the same request; the fault log names the
    exits."""
    import subprocess
    import sys
    from pathlib import Path

    from repro.core.compile import compile_spec as j_compile
    from repro.core.deploy import deploy as j_deploy
    from repro.serve.__main__ import demo_spec as j_demo_spec

    root = Path(__file__).resolve().parents[1]
    log = tmp_path / "faults.ndjson"
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.faults", "portal-smoke",
         "--device", "cpu", "--workers", "2", "--plan", "worker_exit@3",
         "--log", str(log)],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=str(root))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "portal-smoke: PASS" in proc.stdout
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("served 10 requests")][0]
    assert "digests identical: True" in line
    dep = j_deploy(j_compile(j_demo_spec(16, 64), target="engine"), seed=0)
    dep.alloc_lanes(1)
    counts = np.random.default_rng(0).integers(0, 2, (8, 16)) \
        .astype(np.int32)
    spk, V = dep.run_lanes([-1], counts[None], seeds=[0])
    assert line.endswith(f"digest: {j_digest(spk[0], V[0])}")
    fired = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert fired and all(f["site"] == "worker_exit" and f["hit"] == 3
                         for f in fired)
