"""The multi-rank half of tests/test_torch_mesh_runtime.py and
tests/test_torch_distributed_engine.py: gloo ranks on the CPU, started
from a `FileStore`, that never import jax.

    python tests/_torch_mesh_ranks.py mesh CASES_DIR STORE WORLD
    python tests/_torch_mesh_ranks.py pod CASES_NPZ STORE WORLD
    python tests/_torch_mesh_ranks.py serve CASES_NPZ STORE WORLD

`mesh`: every `case*.npz` in CASES_DIR holds a JAX-compiled mesh
artifact's path and the JAX package's outputs for one input sequence
(steps, run, run_batch, two run_lanes windows, a weight write and one
more run); every rank deploys the artifact at each n_devices in
{1, 2, 4, 8} that divides its cores, on both wires, replays the sequence
and holds every output (spikes, V, lane state, reads, per-level traffic,
`shard_rebuilds`) to the reference exactly; then rank 0 serves the two
run_lanes windows from a `SpikeServer` (two sessions and a scratch
request a window) while the other ranks follow, and holds the served
digests to the reference's lanes. `serve`: rank 0 leads a `SpikeServer`
behind an in-process `Portal` over CASES_NPZ's mesh artifact, one core a
rank, and the other ranks replay its calls (`serve_follower`); the
stream of `serve_stream` (sessions, scratch requests, a websocket
session, two reconfigures, a checkpoint and a restore) goes through the
portal once clean and once with `dispatch_crash@2` armed on the leader;
the digests must equal CASES_NPZ's (a world-size-1 port server's and the
JAX package's mesh server's), the chaos run must restart once, and
every rank's lane state after shutdown must equal the leader's.
`pod`: the pod-scale step on
a (data 2, model WORLD / 2) mesh at each n_loc of CASES_NPZ (one
word-aligned, one not), each rank's V and spikes held, step by step, to
the JAX package's `small_reference_step` on the rank's window and
shard, which CASES_NPZ holds. Prints MESH-RANKS-OK when every rank
passed.
"""
import http.client
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.compile import CompiledNetwork  # noqa: E402
from repro_torch.core.deploy import deploy  # noqa: E402
from repro_torch.distributed import mesh  # noqa: E402

def replay(dep, ref) -> dict:
    """The reference's input sequence on `dep` (a `Deployment` of either
    package, V read through numpy); returns what it gave."""
    out = {"step_spikes": [], "step_V": []}
    A = ref["step_counts"].shape[1]
    for c in ref["step_counts"]:
        out["step_spikes"].append(dep.step(np.repeat(np.arange(A), c)))
        out["step_V"].append(np.asarray(dep.V))
    out["run_spikes"] = dep.run(ref["run_counts"])
    out["run_V"] = np.asarray(dep.V)
    out["batch_spikes"] = dep.run_batch(ref["batch_counts"])
    dep.alloc_lanes(3)
    spk, V = [], []
    for w, win in enumerate(ref["lane_windows"]):
        s, v = dep.run_lanes([2, -1, 0], win, seeds=[0, 5 + w, 0])
        spk.append(s)
        V.append(v)
    out["lane_spikes"], out["lane_V"] = np.stack(spk), np.stack(V)
    st = dep.lane_state()
    out["lane_state_V"], out["lane_state_keys"] = st["V"], st["keys"]
    dep.write_synapses(ref["write_pre"], ref["write_post"], ref["write_w"])
    out["after_spikes"] = dep.run(ref["after_counts"])
    out["after_V"] = np.asarray(dep.V)
    out["read_back"] = dep.read_synapses(ref["write_pre"],
                                         ref["write_post"])
    out["read_membrane"] = np.asarray(dep.read_membrane(
        range(dep.compiled.n_neurons)))
    c = dep.counter
    out["counters"] = np.asarray([c.pointer_reads, c.row_reads,
                                  c.timesteps] + list(c.level_events),
                                 np.int64)
    for k in ("step_spikes", "step_V"):
        out[k] = np.stack(out[k])
    return out


def mesh_suite(rank: int, world: int, cases_dir: str) -> None:
    torch.set_num_threads(1)
    for path in sorted(Path(cases_dir).glob("case*.npz")):
        with np.load(path) as z:
            ref = {k: z[k] for k in z.files}
        art = str(ref.pop("artifact"))
        C = int(ref["n_cores"])
        for n_dev in [d for d in (1, 2, 4, 8) if C % d == 0 and d <= world]:
            for packed in (True, False):
                c = CompiledNetwork.load(art)
                assert c.target == "mesh"
                dep = deploy(c, seed=int(ref["seed"]), device="cpu",
                             n_devices=n_dev, packed=packed)
                impl = dep.impl
                assert impl.n_devices == n_dev and impl.world_size == world
                assert len(impl._stages) == len(
                    ref[f"stages_{n_dev}"]), (n_dev, impl._stages)
                got = replay(dep, ref)
                where = f"{path.name} n_devices={n_dev} packed={packed} " \
                        f"rank {rank}"
                for k, v in got.items():
                    np.testing.assert_array_equal(v, ref[k],
                                                  err_msg=f"{k}: {where}")
                cores = c.neuron_core[ref["write_post"]]
                want = np.unique(cores // impl.cores_per_device).size
                assert impl.shard_rebuilds == want, \
                    (where, impl.shard_rebuilds, want)
        # rank 0 serves the two lane windows, the other ranks follow
        served_windows(rank, CompiledNetwork.load(art), ref, path.name)


def served_windows(rank: int, c, ref, where: str) -> None:
    """ref's two run_lanes windows (lanes [2, -1, 0], seeds
    [0, 5 + w, 0]) served by rank 0: sessions 0-2 hold lanes 0-2, the
    scratch request carries seed 5 + w; each answer's digest == the
    reference lane's."""
    from repro_torch.portal.gateway import result_digest
    from repro_torch.serve import SpikeServer, serve_follower
    if rank:
        assert serve_follower(deploy(c, seed=int(ref["seed"]),
                                     device="cpu")) > 0
        return
    srv = SpikeServer(max_batch=4, max_wait_ms=2.0)
    srv.add_model("m", c, window=ref["lane_windows"].shape[2], n_sessions=3,
                  seed=int(ref["seed"]), device="cpu")
    with srv:
        sids = [srv.open_session("m") for _ in range(3)]
        for w, win in enumerate(ref["lane_windows"]):
            futs = [srv.submit("m", win[0], session=sids[2]),
                    srv.submit("m", win[1], seed=5 + w),
                    srv.submit("m", win[2], session=sids[0])]
            for b, f in enumerate(futs):
                res = f.result(timeout=120)
                want = result_digest(ref["lane_spikes"][w][b],
                                     ref["lane_V"][w][b])
                assert result_digest(res.spikes, res.membrane) == want, \
                    f"served window {w} entry {b}: {where}"


def pod_suite(rank: int, world: int, cases: str) -> None:
    from repro_torch.core import distributed_engine as de
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    with np.load(cases) as z:
        ref = {k: z[k] for k in z.files}
    m = make_mesh((2, world // 2), ("data", "model"))
    lin = m.index(("data", "model"))
    for n_loc in ref["n_locs"]:
        cfg = de.SNNShardConfig(n_neurons=world * int(n_loc), block=64,
                                fan_window_blocks=2)
        sl = slice(lin * n_loc, (lin + 1) * n_loc)
        state = {k: torch.as_tensor(ref[f"{n_loc}_{k}"][..., sl].copy())
                 for k in ("V", "theta", "lam", "weights", "spikes")}
        step = de.make_snn_step(cfg, m)
        for s in range(ref[f"{n_loc}_want_V"].shape[0]):
            state = step(state, prng.fold_in(prng.PRNGKey(0), s))
            np.testing.assert_array_equal(
                state["V"].numpy(), ref[f"{n_loc}_want_V"][s, sl],
                err_msg=f"V: rank {rank} n_loc {n_loc} step {s}")
            np.testing.assert_array_equal(
                state["spikes"].numpy(), ref[f"{n_loc}_want_spikes"][s, sl],
                err_msg=f"spikes: rank {rank} n_loc {n_loc} step {s}")


# ------------------------------------------------------------- serving
SERVE_SESSIONS = 4            # HTTP sessions; a websocket one beside them
SERVE_SCRATCH = 2             # scratch requests a round
SERVE_ROUNDS = 4
TIMEOUT = 60


def serve_data(rng, A: int, T: int) -> dict:
    """The windows of `serve_stream`, drawn from `rng`."""
    def wins(*shape):
        return rng.integers(0, 2, shape + (T, A)).astype(np.int32)
    return {"sess": wins(SERVE_ROUNDS, SERVE_SESSIONS),
            "scratch": wins(SERVE_ROUNDS, SERVE_SCRATCH),
            "ws": wins(2)}


def _http(port, method, path, body=None):
    """One request; retried while the answer is the supervisor's 503
    E_DISPATCH_RESTART (the window was rolled back: safe to resend)."""
    t0 = time.monotonic()
    while True:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=TIMEOUT)
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read().decode("utf-8"))
        conn.close()
        code = out.get("error", {}).get("code") if resp.status != 200 \
            else None
        if code != "E_DISPATCH_RESTART":
            assert resp.status == 200, (method, path, out)
            return out
        assert time.monotonic() - t0 < TIMEOUT, "restart never recovered"


def _ws_window(ws, w):
    """One websocket window, resent after a supervised restart."""
    from repro_torch.portal.errors import PortalError
    for _ in range(8):
        ws.send_window(counts=w)
        try:
            return ws.recv()
        except PortalError as e:
            if e.code != "E_DISPATCH_RESTART":
                raise
    raise AssertionError("a websocket window never survived")


def serve_stream(port, srv, ws_cls, data, edits, ckpt) -> dict:
    """The serving stream through a portal at `port` over `srv` (either
    package's server; `ws_cls` its `WSClient`): SERVE_SESSIONS HTTP
    sessions and SERVE_SCRATCH scratch requests a round, concurrently;
    a websocket session of two windows in round 0; reconfigure edits[0]
    after round 1; a checkpoint to `ckpt` after round 2; edits[1]; round
    3; the sessions closed and the checkpoint restored (weights and
    lanes back); round 3 again. Returns {key: digest or count}."""
    sids = [_http(port, "POST", "/v1/m/session")["session"]
            for _ in range(SERVE_SESSIONS)]
    got = {}

    def round_(r, tag):
        def one(k):
            if k < SERVE_SESSIONS:
                out = _http(port, "POST", "/v1/m/run",
                            {"counts": data["sess"][r][k].tolist(),
                             "session": sids[k]})
                got[f"{tag}s{k}"] = out["digest"]
            else:
                j = k - SERVE_SESSIONS
                out = _http(port, "POST", "/v1/m/run",
                            {"counts": data["scratch"][r][j].tolist(),
                             "seed": 100 * r + j})
                got[f"{tag}x{j}"] = out["digest"]
        errors = []

        def wrap(k):
            try:
                one(k)
            except BaseException as e:     # noqa: BLE001 — raised below
                errors.append(e)
        ts = [threading.Thread(target=wrap, args=(k,))
              for k in range(SERVE_SESSIONS + SERVE_SCRATCH)]
        for t in ts:
            t.start()
        if r == 0:
            ws = ws_cls("127.0.0.1", port, "m", timeout=TIMEOUT)
            for i, w in enumerate(data["ws"]):
                got[f"ws{i}"] = _ws_window(ws, w)["digest"]
            ws.close()
        for t in ts:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive(), "a client never returned"
        if errors:
            raise errors[0]

    for r in range(SERVE_ROUNDS - 1):
        round_(r, f"r{r}")
        if r == 1:
            got["rcA"] = _http(port, "POST", "/v1/m/reconfigure",
                               edits[0])["uploads"]
    srv.checkpoint(ckpt)
    got["rcB"] = _http(port, "POST", "/v1/m/reconfigure",
                       edits[1])["uploads"]
    round_(SERVE_ROUNDS - 1, "r3")
    for sid in sids:
        _http(port, "DELETE", f"/v1/m/session/{sid}")
    srv.restore(ckpt)
    round_(SERVE_ROUNDS - 1, "restored")
    for k, sid in enumerate(sids):
        info = _http(port, "GET", f"/v1/m/session/{sid}")
        got[f"info{k}"] = [info["lane"], info["requests"], info["steps"]]
        _http(port, "DELETE", f"/v1/m/session/{sid}")
    return got


def serve_suite(rank: int, world: int, cases: str) -> None:
    from repro_torch import faults
    from repro_torch.portal import Portal, WSClient
    from repro_torch.serve import SpikeServer, serve_follower
    torch.set_num_threads(1)
    with np.load(cases) as z:
        ref = {k: z[k] for k in z.files}
    work = Path(cases).parent
    data = {k: ref[k] for k in ("sess", "scratch", "ws")}
    edits = json.loads(str(ref["edits"]))
    T = data["ws"].shape[1]
    # the last rank deploys with another seed: the add record's check
    # makes add_model and serve_follower raise on every rank
    c = CompiledNetwork.load(str(ref["artifact"]))
    kw = dict(device="cpu", n_devices=world)
    try:
        if rank:
            serve_follower(deploy(c, seed=int(rank == world - 1), **kw))
        else:
            SpikeServer().add_model("m", c, window=T, seed=0, **kw)
    except ValueError as e:
        assert f"{{{world - 1}: ['seed']}}" in str(e), e
    else:
        raise AssertionError("a follower of another seed was accepted")
    for tag, plan in (("clean", None), ("chaos", "dispatch_crash@2")):
        c = CompiledNetwork.load(str(ref["artifact"]))
        kw = dict(seed=0, device="cpu", n_devices=world)
        if rank:
            dep = deploy(c, **kw)
            assert dep.impl.holds_shard and dep.impl.world_size == world
            report = {"replayed": serve_follower(dep)}
        else:
            srv = SpikeServer(max_batch=8, max_wait_ms=2.0)
            srv.add_model("m", c, window=T, n_sessions=SERVE_SESSIONS + 1,
                          **kw)
            dep = srv.models["m"].dep
            if plan:
                faults.install(faults.FaultPlan.from_spec(plan))
            try:
                with srv, Portal(srv, port=0) as portal:
                    got = serve_stream(portal.port, srv, WSClient, data,
                                       edits, work / f"ckpt_{tag}")
            finally:
                faults.uninstall()
            report = {"digests": got, "restarts": srv.health()["restarts"],
                      "records": srv._leader.records}
        st = dep.lane_state()
        np.savez(work / f"lanes_{tag}_{rank}.npz", V=st["V"],
                 keys=st["keys"], syn_weight=dep.compiled.syn_weight)
        with open(work / f"serve_{tag}_{rank}.json", "w") as fh:
            json.dump(report, fh)


def check_serve(cases: str, world: int) -> None:
    """The ranks' reports against CASES_NPZ: digests, one restart under
    chaos, and every follower's lanes and weights == the leader's."""
    work = Path(cases).parent
    with np.load(cases) as z:
        want = {k: json.loads(str(z[k])) for k in ("want_jax", "want_ws1")}
    assert want["want_jax"] == want["want_ws1"], "world 1 != JAX"
    for tag in ("clean", "chaos"):
        reps = [json.loads((work / f"serve_{tag}_{r}.json").read_text())
                for r in range(world)]
        assert reps[0]["digests"] == want["want_jax"], \
            f"{tag}: the leader's digests differ from world size 1 / JAX"
        assert reps[0]["restarts"] == (tag == "chaos"), reps[0]
        assert all(r["replayed"] == reps[1]["replayed"] > 0
                   for r in reps[1:]), reps
        with np.load(work / f"lanes_{tag}_0.npz") as z0:
            lead = {k: z0[k] for k in z0.files}
        for r in range(1, world):
            with np.load(work / f"lanes_{tag}_{r}.npz") as z:
                for k in lead:
                    np.testing.assert_array_equal(
                        z[k], lead[k], err_msg=f"{tag} rank {r} {k}")
        print(f"serve {tag}: {len(reps[0]['digests'])} answers == world 1 "
              f"and JAX; {reps[0]['records']} records, each follower "
              f"replayed {reps[1]['replayed']} calls; lanes equal",
              flush=True)


SUITES = {"mesh": mesh_suite, "pod": pod_suite, "serve": serve_suite}


def main(argv) -> int:
    suite, arg, store, world = argv[1], argv[2], argv[3], int(argv[4])
    mesh.spawn(SUITES[suite], world, store, (arg,), timeout_s=240,
               collective_timeout_s=120)
    if suite == "serve":
        check_serve(arg, world)
    print("MESH-RANKS-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
