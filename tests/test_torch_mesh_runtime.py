"""The port's mesh tier (`repro_torch.core.mesh_runtime`) against the JAX
package's (`repro.core.mesh_runtime`) and engines: spikes, membranes,
pointer/row reads and per-level traffic bit for bit, with every rank
holding only its own cores' ragged shard.

World size 1 runs in this process (no process group: one rank holds
every core, as JAX on a one-device host). Several ranks run in a
subprocess: `tests/_torch_mesh_ranks.py` spawns 8 gloo ranks on the CPU
from a `FileStore` in tmp_path; they replay the input sequences whose
JAX outputs this process wrote to an .npz, and never import jax.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.neuron as jn
import repro_torch.core.neuron as tn
from _torch_mesh_ranks import replay, serve_data, serve_stream
from _torch_pair import noisy_spec
from repro.core.api import CRI_network as JNet
from repro.core.compile import CompiledNetwork as JCompiled
from repro.core.compile import compile_spec as j_compile
from repro.core.deploy import deploy as j_deploy
from repro.core.mesh_runtime import default_device_count as j_ddc
from repro.core.partition import Hierarchy as JHier
from repro.core.spec import NetworkSpec as JSpec
from repro.kernels.exchange import HierSpec as JHierSpec
from repro.kernels.exchange import collective_stages as j_stages
from repro.portal import Portal as JPortal
from repro.portal import WSClient as JWSClient
from repro.serve import SpikeServer as JServer
from repro_torch.analysis.retrace import RetraceDetector, RetraceError
from repro_torch.core.api import CRI_network as TNet
from repro_torch.core.compile import CompiledNetwork as TCompiled
from repro_torch.core.compile import compile_spec as t_compile
from repro_torch.core.deploy import deploy as t_deploy
from repro_torch.core.mesh_runtime import MeshNetwork
from repro_torch.core.mesh_runtime import default_device_count as t_ddc
from repro_torch.core.partition import Hierarchy as THier
from repro_torch.portal import Portal, WSClient
from repro_torch.core.spec import NetworkSpec as TSpec
from repro_torch.serve import SpikeServer
from test_routing_vectorized import drive, random_net
from test_torch_hiaer import same_counters, t_dicts

ROOT = Path(__file__).resolve().parents[1]
# JAX's 8-device child suite's hierarchies (tests/test_mesh_runtime.py)
CHILD_HIERS = [(2, 2, 2, 8), (1, 2, 2, 12), (1, 1, 4, 12), (1, 1, 1, 1000)]


# --------------------------------------------------------- pure helper
def test_default_device_count_matches_jax():
    for n_cores, avail in [(8, 3), (6, 8), (5, 2), (8, 8), (1, 1), (12, 5),
                           (7, 7), (16, 6)]:
        assert t_ddc(n_cores, available=avail) == j_ddc(n_cores, avail)
    assert t_ddc(8) == 1                     # no process group: one rank
    for bad in [(8, 0), (0, 4), (3, -1)]:
        with pytest.raises(ValueError):
            j_ddc(*bad)
        with pytest.raises(ValueError):
            t_ddc(*bad)


def test_device_count_validation_same_errors():
    lif_j = jn.LIF_neuron(threshold=5, nu=-32, lam=63)
    lif_t = tn.LIF_neuron(threshold=5, nu=-32, lam=63)
    kw = dict(axons={"a": [("x", 3)]}, outputs=["x"], backend="mesh")
    for n_dev in (2, 3000):        # 2 cannot split 3 cores; 3000 > world
        with pytest.raises(ValueError):
            JNet(neurons={"x": ([], lif_j), "y": ([], lif_j)},
                 hierarchy=JHier(1, 1, 3, 1), n_devices=n_dev, **kw)
        with pytest.raises(ValueError):
            TNet(neurons={"x": ([], lif_t), "y": ([], lif_t)},
                 hierarchy=THier(1, 1, 3, 1), n_devices=n_dev,
                 device="cpu", **kw)


# ---------------------------------------------------- world size 1
@pytest.mark.parametrize("seed", [21, 0, 1, 2])
def test_mesh_single_device_parity(seed):
    """One rank holds every core: no stages, and the port's mesh (both
    wires) == JAX's mesh == the port's engine (spikes, V, counters,
    per-level traffic)."""
    axons, neurons, outputs = random_net(seed)
    hier = (2, 2, 2, 1000)
    jm = JNet(axons=axons, neurons=neurons, outputs=outputs,
              backend="mesh", seed=seed, hierarchy=JHier(*hier))
    want = drive(seed, jm, list(axons))
    te = TNet(*t_dicts(axons, neurons, outputs), backend="engine",
              seed=seed, device="cpu")
    assert drive(seed, te, list(axons)) == want
    for packed in (True, False):
        tm = TNet(*t_dicts(axons, neurons, outputs), backend="mesh",
                  seed=seed, hierarchy=THier(*hier), packed=packed,
                  device="cpu")
        assert isinstance(tm._impl, MeshNetwork)
        assert tm._impl.n_devices == 1 and tm._impl._stages == []
        assert drive(seed, tm, list(axons)) == want
        same_counters(jm, tm)
        same_counters(tm, te, levels=False)


def test_no_dense_weight_image_on_device():
    """Per-core weight storage: the tables carry exactly the ragged
    entries, never an (R * SLOTS)-sized array, on hiaer and mesh."""
    axons, neurons, outputs = random_net(2, n_neurons=30)
    for backend in ("hiaer", "mesh"):
        net = TNet(*t_dicts(axons, neurons, outputs), backend=backend,
                   seed=0, hierarchy=THier(1, 2, 2, 30), device="cpu")
        t = net._impl.tables
        assert not hasattr(t, "w_ext")
        dense = net.compiled.image.syn_post.size      # R * SLOTS slots
        nnz = net.compiled.shards.n_entries
        assert nnz < dense
        assert t.entry_w.numel() <= max(nnz, 1) < dense
        for leaf in [x for x in t if hasattr(x, "numel")] + list(t.exchange):
            assert leaf.numel() < dense


def test_mesh_byte_accounting_matches_jax():
    """The wire and event-vector bytes equal JAX's; the shard bytes are
    JAX's plus the CSR offsets' int64 width."""
    spec_j, spec_t = noisy_spec(JSpec, jn, seed=5), noisy_spec(TSpec, tn,
                                                               seed=5)
    hier = (1, 2, 2, 20)
    j = j_deploy(j_compile(spec_j, "mesh", hierarchy=JHier(*hier))).impl
    t = t_deploy(t_compile(spec_t, "mesh", hierarchy=THier(*hier)),
                 device="cpu").impl
    for packed in (None, True, False):
        assert t.exchange_bytes_per_step(packed) == \
            j.exchange_bytes_per_step(packed)
        assert t.event_vector_bytes(packed) == j.event_vector_bytes(packed)
    ip = t.cores_per_device * (t.shards.n_max + 1) * 4
    assert t.device_shard_bytes() == [b + ip for b in j.device_shard_bytes()]


# ------------------------------------------------------------ artifacts
def test_mesh_artifacts_cross_both_ways(tmp_path):
    """A mesh artifact of either package loads in the other and runs the
    same: run, run_batch, run_lanes and lane state."""
    hier = (1, 1, 4, 20)
    js, ts = noisy_spec(JSpec, jn, seed=8), noisy_spec(TSpec, tn, seed=8)
    j_compile(js, "mesh", hierarchy=JHier(*hier)).save(tmp_path / "j.npz")
    t_compile(ts, "mesh", hierarchy=THier(*hier)).save(tmp_path / "t.npz",
                                                       compressed=False)
    jc, tc = JCompiled.load(tmp_path / "t.npz"), \
        TCompiled.load(tmp_path / "j.npz")
    assert jc.target == tc.target == "mesh"
    np.testing.assert_array_equal(tc.shards.entry_w, jc.shards.entry_w)
    jd, td = j_deploy(jc, seed=2), t_deploy(tc, seed=2, device="cpu")
    rng = np.random.default_rng(8)
    s = rng.integers(0, 3, (5, tc.n_axons)).astype(np.int32)
    np.testing.assert_array_equal(td.run(s), jd.run(s))
    np.testing.assert_array_equal(np.asarray(td.V), np.asarray(jd.V))
    b = rng.integers(0, 2, (3, 4, tc.n_axons)).astype(np.int32)
    np.testing.assert_array_equal(td.run_batch(b), jd.run_batch(b))
    for d in (jd, td):
        d.alloc_lanes(2)
    win = rng.integers(0, 2, (2, 4, tc.n_axons)).astype(np.int32)
    for x, y in zip(td.run_lanes([1, -1], win, seeds=[0, 3]),
                    jd.run_lanes([1, -1], win, seeds=[0, 3])):
        np.testing.assert_array_equal(x, y)
    for k in ("V", "keys"):
        np.testing.assert_array_equal(td.lane_state()[k],
                                      jd.lane_state()[k])
    same_counters(jd, td)


# ---------------------------------------------------------------- serving
def _reconfigure_history(server_cls, compiled, **deploy_kw):
    """tests/test_serve.py's history on either package's server: 4
    requests, a reconfiguration, 4 more, all in flight together; returns
    the served (spikes, membrane) pairs."""
    rng = np.random.default_rng(11)
    T = 4
    pre, post = [-1], [int(compiled.syn_post[0])]
    w_old = int(compiled.syn_weight[0])
    reqs = rng.integers(0, 2, (8, T, compiled.n_axons)).astype(np.int32)
    srv = server_cls(max_batch=4, max_wait_ms=3.0)
    srv.add_model("m", compiled, window=T, n_sessions=0, seed=0,
                  **deploy_kw)
    with srv:
        before = [srv.submit("m", reqs[i], seed=i) for i in range(4)]
        fut = srv.reconfigure("m", pre, post, [w_old + 2])
        after = [srv.submit("m", reqs[i], seed=i) for i in range(4, 8)]
        got = [f.result(timeout=120) for f in before + after]
        assert fut.result(timeout=120) >= 1
    return [(g.spikes, g.membrane) for g in got]


def _small(pkg_spec, lif, backend, compile_fn, hier):
    rng = np.random.default_rng(3)
    spec = pkg_spec()
    ax = spec.add_axons(5)
    nid = spec.add_neurons(12, lif(threshold=5, nu=-32, lam=50))
    pre = np.concatenate([np.repeat(ax, 4), np.repeat(nid, 3)])
    spec.connect(pre, rng.integers(0, 12, pre.shape[0]),
                 rng.integers(-3, 7, pre.shape[0]))
    spec.set_outputs(list(range(4)))
    kw = {"hierarchy": hier(1, 1, 3, 4)} if backend == "mesh" else {}
    return compile_fn(spec, target=backend, **kw)


def test_reconfigure_while_serving_engine_matches_mesh():
    """Interleaved reconfiguration on the port's engine and mesh servers
    equals JAX's mesh server, so the two backends agree bit for bit."""
    want = _reconfigure_history(
        JServer, _small(JSpec, jn.LIF_neuron, "mesh", j_compile, JHier))
    for backend in ("engine", "mesh"):
        got = _reconfigure_history(
            SpikeServer, _small(TSpec, tn.LIF_neuron, backend, t_compile,
                                THier), device="cpu")
        for (s, v), (ws, wv) in zip(got, want):
            np.testing.assert_array_equal(s, ws)
            np.testing.assert_array_equal(v, wv)


def test_retrace_detector_finds_the_mesh_lane_path():
    dep = t_deploy(_small(TSpec, tn.LIF_neuron, "mesh", t_compile, THier),
                   device="cpu")
    det = RetraceDetector.of(dep.impl)
    dep.alloc_lanes(2)
    dep.run_lanes([0, -1], np.zeros((2, 3, 5), np.int32))
    with pytest.raises(RetraceError, match="MeshNetwork.run_lanes"):
        det.assert_no_retrace()
    det.snapshot()
    dep.run_lanes([1, 0], np.ones((2, 3, 5), np.int32))
    det.assert_no_retrace()


# ------------------------------------------------------- several ranks
def _write_batch(c, rng, k=6):
    """k distinct synapses of artifact c (first record of each pair), as
    encoded (pre, post) and new weights."""
    _, first = np.unique(c.syn_item * c.n_neurons + c.syn_post,
                         return_index=True)
    cols = rng.choice(first, min(k, first.size), replace=False)
    item = c.syn_item[cols]
    pre = np.where(item < c.item_base, -(item + 1), item - c.item_base)
    return pre, c.syn_post[cols], rng.integers(-40, 40, cols.size)


def _mesh_case(tmp_path, i, hier, seed, with_engine):
    axons, neurons, outputs = random_net(seed)
    js = JSpec.from_dicts(axons, neurons, outputs)
    jc = j_compile(js, "mesh", hierarchy=JHier(*hier))
    art = tmp_path / f"art{i}.npz"
    jc.save(art)
    rng = np.random.default_rng(seed)
    A = jc.n_axons
    ref = {"step_counts": rng.integers(0, 2, (6, A)).astype(np.int32),
           "run_counts": rng.integers(0, 3, (5, A)).astype(np.int32),
           "batch_counts": rng.integers(0, 2, (3, 4, A)).astype(np.int32),
           "lane_windows": rng.integers(0, 2, (2, 3, 4, A))
           .astype(np.int32),
           "after_counts": rng.integers(0, 2, (4, A)).astype(np.int32)}
    ref["write_pre"], ref["write_post"], ref["write_w"] = _write_batch(
        jc, rng)
    ref.update(replay(j_deploy(JCompiled.load(art), seed=seed), ref))
    if with_engine:
        eng = replay(j_deploy(j_compile(js, "engine"), seed=seed), ref)
        for k in ("step_spikes", "step_V", "run_spikes", "batch_spikes",
                  "lane_spikes", "lane_V", "after_spikes", "read_back"):
            np.testing.assert_array_equal(eng[k], ref[k], err_msg=k)
    C = int(np.prod(hier[:3]))
    for n in (1, 2, 4, 8):
        if C % n == 0:
            ref[f"stages_{n}"] = np.arange(
                len(j_stages(JHierSpec(*hier[:3]), n)))
    np.savez(tmp_path / f"case{i}.npz", artifact=str(art), seed=seed,
             n_cores=C, **ref)


def test_mesh_eight_gloo_ranks_subprocess(tmp_path):
    """8 gloo ranks: JAX's child-suite hierarchies at every n_devices in
    {1, 2, 4, 8} dividing the cores (ranks past n_devices take rank 0's
    outputs by broadcast), both wires, through step, run, run_batch,
    run_lanes and a weight write; every rank == JAX's mesh outputs, and
    a multi-rank SpikeServer on rank 0 (the other ranks following)
    serves the two run_lanes windows with JAX's lanes' digests."""
    for i, hier in enumerate(CHILD_HIERS):
        _mesh_case(tmp_path, i, hier, 40 + i, with_engine=i == 0)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"),
         "mesh", str(tmp_path), str(tmp_path / "store"), "8"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    assert "MESH-RANKS-OK" in proc.stdout


def test_mesh_four_gloo_ranks_serve_subprocess(tmp_path):
    """4 gloo ranks serve a mesh artifact (one core a rank): rank 0
    leads a SpikeServer behind a Portal, the others replay its calls.
    Sessions, scratch requests, a websocket session, two reconfigures,
    a checkpoint and a restore give the digests of a world-size-1 port
    server and of JAX's mesh server, also with dispatch_crash@2 armed on
    the leader; every follower's lanes and weights == the leader's. A
    follower deployed with another seed first makes the leader's
    add_model and every follower raise."""
    from _torch_mesh_ranks import SERVE_SESSIONS
    from test_torch_serve import _spec
    from repro.core.api import LIF_neuron as JLIF
    jc = j_compile(_spec(JSpec, JLIF, 6, 24, 5), "mesh",
                   hierarchy=JHier(1, 2, 2, 6))
    art = tmp_path / "art.npz"
    jc.save(art)
    rng = np.random.default_rng(61)
    T = 3
    data = serve_data(rng, jc.n_axons, T)
    edits = []
    for _ in range(2):
        pre, post, w = _write_batch(jc, rng, 5)
        edits.append({"pre": pre.tolist(), "post": post.tolist(),
                      "weight": w.tolist()})
    want = {}
    jsrv = JServer(max_batch=8, max_wait_ms=2.0)
    jsrv.add_model("m", JCompiled.load(art), window=T,
                   n_sessions=SERVE_SESSIONS + 1, seed=0)
    with jsrv, JPortal(jsrv, port=0) as p:
        want["jax"] = serve_stream(p.port, jsrv, JWSClient, data, edits,
                                   tmp_path / "ck_jax")
    tsrv = SpikeServer(max_batch=8, max_wait_ms=2.0)
    tsrv.add_model("m", TCompiled.load(art), window=T,
                   n_sessions=SERVE_SESSIONS + 1, seed=0, device="cpu")
    with tsrv, Portal(tsrv, port=0) as p:
        want["ws1"] = serve_stream(p.port, tsrv, WSClient, data, edits,
                                   tmp_path / "ck_ws1")
    assert want["ws1"] == want["jax"]
    assert want["jax"]["rcA"] == 1 and want["jax"]["rcB"] == 2
    cases = tmp_path / "serve.npz"
    np.savez(cases, artifact=str(art), edits=json.dumps(edits),
             want_jax=json.dumps(want["jax"]),
             want_ws1=json.dumps(want["ws1"]), **data)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"),
         "serve", str(cases), str(tmp_path / "store"), "4"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    assert "MESH-RANKS-OK" in proc.stdout
    assert "serve chaos:" in proc.stdout


def test_serve_cli_mesh_backend():
    """`python -m repro_torch.serve --backend mesh` serves the demo
    network at world size 1 (as `python -m repro.serve --backend mesh`
    on one device) with the engine backend's spike rate."""
    import contextlib
    import io

    from repro_torch.serve.__main__ import main
    lines = {}
    for backend in ("mesh", "engine"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--device", "cpu", "--backend", backend,
                       "--clients", "2", "--requests", "2", "--sessions"])
        assert rc == 0
        lines[backend] = buf.getvalue().splitlines()
    assert lines["mesh"][0].startswith("served 4 requests from 2 clients")
    rate = [x.split("rate")[-1] for b in ("mesh", "engine")
            for x in lines[b] if "mean spike rate" in x]
    assert len(rate) == 2 and rate[0] == rate[1] and float(rate[0]) > 0


def test_serve_cli_mesh_backend_under_torchrun():
    """`torchrun --nproc-per-node 4 -m repro_torch.serve --backend mesh`:
    one core a rank, rank 0 serving while the others replay its
    dispatches; the same requests and spike rate as world size 1 (the
    demo network's spikes do not depend on the hierarchy)."""
    import contextlib
    import io
    import os

    from repro_torch.serve.__main__ import main
    argv = ["--device", "cpu", "--backend", "mesh", "--clients", "2",
            "--requests", "2", "--sessions"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    one = buf.getvalue().splitlines()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.serve"] + argv,
        env=env, capture_output=True, text=True, timeout=240, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    four = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(four) == len(one), (four, one)
    assert four[0].startswith("served 4 requests from 2 clients")
    assert four[-1].split("mean spike rate")[-1] == \
        one[-1].split("mean spike rate")[-1]
