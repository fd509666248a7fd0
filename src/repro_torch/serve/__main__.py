"""`python -m repro_torch.serve` — self-contained spike-serving demo,
the port of `python -m repro.serve`, on the card unless `--device cpu`.

Builds a random recurrent SNN, makes it resident in a `SpikeServer`,
drives it from N concurrent client threads (a mix of stateless
requests and resident streaming sessions), and prints the serving
statistics: p50/p99 latency, requests/sec, mean micro-batch size, and
the batch shapes run (the power-of-two buckets).

    PYTHONPATH=src python -m repro_torch.serve --clients 8 --requests 4
    PYTHONPATH=src python -m repro_torch.serve --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.serve \
        --device cpu --backend mesh

Under `torchrun`, `--backend mesh` spreads the network's cores over the
world (one core a rank) and serves it from rank 0: the other ranks
deploy the same artifact and replay rank 0's dispatches
(`serve.replica.serve_follower`) until its server shuts down.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core.compile import compile_spec
from repro_torch.core.neuron import LIF_neuron
from repro_torch.core.partition import Hierarchy
from repro_torch.core.spec import NetworkSpec
from repro_torch.distributed import mesh
from repro_torch.serve import SpikeServer


def demo_spec(n_axons: int, n_neurons: int, fanout: int = 6,
              seed: int = 0) -> NetworkSpec:
    """Random recurrent LIF network via the bulk columnar builder."""
    rng = np.random.default_rng(seed)
    spec = NetworkSpec()
    ax = spec.add_axons(n_axons)
    nid = spec.add_neurons(n_neurons,
                           LIF_neuron(threshold=6, nu=-32, lam=40))
    pre = np.concatenate([
        np.repeat(ax, fanout),
        np.repeat(nid, fanout)])
    post = rng.integers(0, n_neurons, pre.shape[0])
    w = rng.integers(-3, 8, pre.shape[0])
    spec.connect(pre, post, w)
    spec.set_outputs(list(range(min(8, n_neurons))))
    return spec


def demo_compiled(args):
    """The demo network compiled for `args.backend`; under a world of W
    ranks the mesh target gets W cores (one a rank) — the served spikes
    and membranes are the same on any hierarchy."""
    kw = {}
    W = mesh.world()[1]
    if args.backend == "mesh" and W > 1:
        kw["hierarchy"] = Hierarchy(1, 1, W, -(-args.neurons // W))
    return compile_spec(demo_spec(args.axons, args.neurons),
                        target=args.backend, **kw)


def follow(compiled, device) -> int:
    """A follower rank of a multi-rank mesh server: deploy the artifact
    (in step with the leader's `add_model`) and replay its calls until
    the leader's stop record. SIGINT and SIGTERM, which torchrun and a
    terminal's Ctrl-C deliver to every rank, are left to the leader: it
    drains and sends the stop record (torchrun kills a rank that outlives
    its shutdown grace)."""
    import signal

    from repro_torch.core.deploy import deploy
    from repro_torch.serve import serve_follower
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda signum, frame: None)
    serve_follower(deploy(compiled, seed=0, device=device))
    return 0


def _client(srv: SpikeServer, model: str, cid: int, n_requests: int,
            window: int, n_axons: int, use_session: bool,
            results: list) -> None:
    rng = np.random.default_rng(100 + cid)
    sid = srv.open_session(model) if use_session else None
    for r in range(n_requests):
        counts = rng.integers(0, 2, (window, n_axons)).astype(np.int32)
        for attempt in range(4):
            try:
                res = srv.submit(model, counts, session=sid,
                                 seed=cid * 1000 + r).result(timeout=120)
                break
            except RuntimeError:
                # chaos / dispatcher restart: state was rolled back,
                # the same window is safe to resubmit bit-exactly
                if attempt == 3:
                    raise
                time.sleep(0.05)
        results.append(res)
        if srv.tel.log.enabled:
            srv.tel.log.request(
                trace_id=res.trace_id, token="", model=model,
                op="run", status=200, code=None, bucket=res.bucket,
                batch_size=res.batch_size,
                queue_wait_ms=round(res.queue_wait_ms, 3),
                dispatch_ms=round(res.dispatch_ms, 3),
                latency_ms=round(res.latency_ms, 3))
    if sid is not None:
        srv.close_session(model, sid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--backend", default="engine",
                    choices=["simulator", "engine", "hiaer", "mesh"],
                    help="mesh under torchrun: one core a rank, served "
                         "by rank 0; without it, world size 1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: the kernels' plain "
                         "versions)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per client")
    ap.add_argument("--window", type=int, default=8,
                    help="timesteps per serving window")
    ap.add_argument("--axons", type=int, default=16)
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--wait-ms", type=float, default=5.0,
                    help="micro-batch deadline")
    ap.add_argument("--sessions", action="store_true",
                    help="give every client a resident session lane")
    ap.add_argument("--log-json", default=None, metavar="PATH|-",
                    help="write one JSON line per request to PATH "
                         "('-' = stdout)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's spans as Chrome trace-event "
                         "JSON (open in Perfetto / chrome://tracing)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm chaos sites, e.g. "
                         "'dispatch_crash@2;batch_exception%%0.05' "
                         "(see python -m repro_torch.faults list)")
    ap.add_argument("--faults-seed", type=int, default=0)
    ap.add_argument("--faults-log", default=None, metavar="PATH",
                    help="append one NDJSON line per fired fault")
    args = ap.parse_args(argv)

    from repro_torch import faults
    from repro_torch.obs import Telemetry, chrome_trace

    if args.faults:
        faults.install(faults.FaultPlan.from_spec(
            args.faults, seed=args.faults_seed,
            log_path=args.faults_log))
    else:
        faults.install_from_env()

    started = args.backend == "mesh" and mesh.init_from_env(args.device)
    try:
        return _serve(args, Telemetry(log_json=args.log_json),
                      chrome_trace)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, tel, chrome_trace) -> int:
    compiled = demo_compiled(args)
    if mesh.world()[0] != 0:
        return follow(compiled, args.device)
    srv = SpikeServer(max_batch=args.max_batch, max_wait_ms=args.wait_ms,
                      telemetry=tel)
    srv.add_model("demo", compiled, window=args.window,
                  n_sessions=args.clients, seed=0, device=args.device)

    # build the kernels (first use) outside the timed window so the
    # printed latencies are serving latencies, not build latencies
    with srv:
        srv.submit("demo", np.zeros((args.window, args.axons),
                                    np.int32)).result()
        srv.reset_stats()
        results: list = []
        t0 = time.monotonic()
        threads = [threading.Thread(
            target=_client,
            args=(srv, "demo", c, args.requests, args.window,
                  args.axons, args.sessions, results))
            for c in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        stats = srv.stats()

    total = args.clients * args.requests
    spike_rate = float(np.mean([r.spikes.mean() for r in results]))
    print(f"served {total} requests from {args.clients} clients in "
          f"{wall:.3f}s  ({total / wall:.1f} req/s)")
    print(f"p50 {stats['p50_ms']:.2f} ms   p99 {stats['p99_ms']:.2f} ms"
          f"   mean batch {stats['mean_batch_size']:.2f}")
    print(f"buffer swaps {stats['buffer']['swaps']}  max future depth "
          f"{stats['buffer']['max_future_depth']}")
    print(f"batch shapes {stats['models']['demo']['batch_shapes']}  "
          f"mean spike rate {spike_rate:.3f}")
    if args.trace_out:
        import json

        obj = chrome_trace(tel.tracer.spans())
        with open(args.trace_out, "w", encoding="utf-8") as fh:
            json.dump(obj, fh)
        print(f"wrote {len(obj['traceEvents'])} trace events to "
              f"{args.trace_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
