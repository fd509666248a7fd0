"""`python -m repro_torch.portal` — serve a resident model over
localhost, on the card unless `--device cpu` (the port of
`python -m repro.portal`).

Builds the same random recurrent SNN as `python -m repro_torch.serve`,
makes it resident in a `SpikeServer`, and opens the web portal on top:

    PYTHONPATH=src python -m repro_torch.portal --port 8787 --workers 4 \
        --token s3cret:50:16:8
    PYTHONPATH=src python -m repro_torch.portal --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.portal \
        --device cpu --backend mesh

    curl -s localhost:8787/healthz
    curl -s -X POST localhost:8787/v1/demo/run \
        -H 'Authorization: Bearer s3cret' \
        -d '{"events": [[0, 1], [2], []]}'

Runs until SIGINT/SIGTERM, then drains: the signal handler calls
`SpikeServer.shutdown(drain=True)`, so every queued request is
answered before the process exits.

Under `torchrun`, `--backend mesh` spreads the network's cores over the
world (one core a rank): rank 0 runs the portal and the leading server,
and every other rank replays its dispatches
(`serve.replica.serve_follower`) until the server drains on SIGINT /
SIGTERM of rank 0.

The hidden `--worker` mode is the entry point of spawned bridge
front-end processes (see `repro_torch.portal.bridge`); it imports
neither torch nor numpy.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading


def _worker_mode(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.portal --worker")
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--uds", required=True)
    ap.add_argument("--auth-spec", default=None)
    ap.add_argument("--log-json", default=None)
    args = ap.parse_args(argv)

    from repro_torch.portal.bridge import run_worker

    run_worker(args.host, args.port, args.uds, args.auth_spec,
               args.log_json)
    return 0


def _parse_token(spec: str):
    """`secret[:rate[:burst[:max_inflight]]]` -> (secret, TokenQuota)."""
    from repro_torch.portal.auth import TokenQuota

    parts = spec.split(":")
    secret = parts[0]
    if not secret:
        raise SystemExit(f"empty token in --token {spec!r}")
    rate = float(parts[1]) if len(parts) > 1 else 50.0
    burst = int(parts[2]) if len(parts) > 2 else max(int(rate), 1)
    inflight = int(parts[3]) if len(parts) > 3 else 8
    return secret, TokenQuota(rate=rate, burst=burst,
                              max_inflight=inflight)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--worker":
        return _worker_mode(argv[1:])

    ap = argparse.ArgumentParser(prog="python -m repro_torch.portal")
    ap.add_argument("--backend", default="engine",
                    choices=["simulator", "engine", "hiaer", "mesh"],
                    help="mesh under torchrun: one core a rank, served "
                         "by rank 0; without it, world size 1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: the kernels' plain "
                         "versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--workers", type=int, default=0,
                    help="0 = serve in-process; N = spawn N bridged "
                         "front-end worker processes (token quotas "
                         "are then enforced per worker — up to N x "
                         "the configured limits; /metrics totals are "
                         "bridge-aggregated across workers, with "
                         "per-worker breakdown under *_by_worker)")
    ap.add_argument("--model", default="demo",
                    help="resident model name (the {model} in /v1/"
                         "{model}/run)")
    ap.add_argument("--axons", type=int, default=16)
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--wait-ms", type=float, default=5.0)
    ap.add_argument("--max-pending", type=int, default=256,
                    help="ingestion-queue bound; beyond it requests "
                         "shed with 503 + Retry-After")
    ap.add_argument("--token", action="append", default=[],
                    metavar="SECRET[:RATE[:BURST[:INFLIGHT]]]",
                    help="add a bearer token (repeatable); no --token "
                         "= open portal")
    ap.add_argument("--log-json", default=None, metavar="PATH|-",
                    help="write one JSON line per request to PATH "
                         "('-' = stdout); off by default")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable span recording and metric updates "
                         "(tracing/metrics are on by default)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm chaos sites in THIS process and every "
                         "spawned worker (exported as REPRO_FAULTS), "
                         "e.g. 'worker_exit@3;bridge_drop%%0.02'")
    ap.add_argument("--faults-seed", type=int, default=0)
    ap.add_argument("--faults-log", default=None, metavar="PATH",
                    help="append one NDJSON line per fired fault "
                         "(line-atomic across processes)")
    args = ap.parse_args(argv)

    import os

    from repro_torch import faults
    from repro_torch.distributed import mesh
    from repro_torch.obs import Telemetry

    if args.faults:
        # export so bridge workers (spawned with this env) arm the
        # same plan; their per-site hit counters are process-local
        os.environ["REPRO_FAULTS"] = args.faults
        os.environ["REPRO_FAULTS_SEED"] = str(args.faults_seed)
        if args.faults_log:
            os.environ["REPRO_FAULTS_LOG"] = args.faults_log
    faults.install_from_env()
    started = args.backend == "mesh" and mesh.init_from_env(args.device)
    try:
        return _serve(args, Telemetry, mesh)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, Telemetry, mesh) -> int:
    from repro_torch.portal.gateway import Portal
    from repro_torch.serve import SpikeServer
    from repro_torch.serve.__main__ import demo_compiled, follow

    compiled = demo_compiled(args)
    if mesh.world()[0] != 0:
        return follow(compiled, args.device)
    tel = Telemetry(on=not args.no_telemetry, log_json=args.log_json)
    srv = SpikeServer(max_batch=args.max_batch,
                      max_wait_ms=args.wait_ms,
                      max_pending=args.max_pending,
                      telemetry=tel)
    srv.add_model(args.model, compiled, window=args.window,
                  n_sessions=args.sessions, seed=0, device=args.device)
    tokens = dict(_parse_token(t) for t in args.token) or None

    stop = threading.Event()

    def _signal(signum, frame):
        print(f"\nsignal {signum}: draining and shutting down ...",
              flush=True)
        stop.set()

    signal.signal(signal.SIGINT, _signal)
    signal.signal(signal.SIGTERM, _signal)

    srv.start()
    portal = Portal(srv, host=args.host, port=args.port,
                    workers=args.workers, tokens=tokens)
    portal.start()
    mode = (f"{args.workers} bridged workers" if args.workers
            else "in-process")
    ranks = mesh.world()[1]
    where = args.device + (f", {ranks} ranks" if ranks > 1 else "")
    print(f"portal serving model {args.model!r} "
          f"({args.backend} on {where}, {args.axons} axons, "
          f"{args.neurons} neurons, window {args.window}) at "
          f"{portal.url}  [{mode}]", flush=True)
    print(f"  curl -s {portal.url}/healthz")
    auth = f" -H 'Authorization: Bearer {args.token[0].split(':')[0]}'"\
        if args.token else ""
    print(f"  curl -s -X POST {portal.url}/v1/{args.model}/run{auth} "
          f"-d '{{\"events\": [[0, 1], [2]]}}'", flush=True)
    try:
        stop.wait()
    finally:
        portal.stop()
        # drain: every queued request is resolved before exit — no
        # client hangs on a dead socket
        srv.shutdown(drain=True)
        print("portal stopped; dispatcher drained.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
