"""`python -m repro_torch.faults` — chaos CLI for the port's serving
stack (the port of `python -m repro.faults`).

    python -m repro_torch.faults                  # list sites + env plan
    python -m repro_torch.faults demo             # replayable dispatcher
                                                  # chaos, on the card
    python -m repro_torch.faults demo --device cpu
    python -m repro_torch.faults portal-smoke     # kill-a-worker portal
                                                  # smoke, on the card

`demo` arms a seeded plan against a live `SpikeServer`, drives a fixed
request sequence through injected dispatcher crashes and poisoned
batches, then REPLAYS the identical plan on a fresh server and asserts
the two runs produced the same outcome sequence and the same response
digests — deterministic chaos, the property the test-suite matrix is
built on.

`portal-smoke` starts a multi-worker portal with `worker_exit` armed in
the workers (via REPRO_FAULTS, which spawned workers inherit), lets one
front-end process hard-exit mid-traffic, and verifies the parent
respawns it while every surviving response stays bit-exact.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.faults import SITES, FaultPlan, install, install_from_env, \
    uninstall


def _cmd_list(args) -> int:
    print("fault sites:")
    for name, action in SITES.items():
        print(f"  {name:<16} default action: {action}")
    plan = install_from_env()
    if plan is not None:
        print(f"env plan (REPRO_FAULTS): {plan.spec()!r} "
              f"seed={plan.seed}")
    else:
        print("no env plan (REPRO_FAULTS unset)")
    return 0


def _chaos_run(plan_spec: str, seed: int, n_requests: int, log_path,
               device: str) -> list:
    """One chaos pass: fresh server, fresh plan, fixed request
    sequence; returns the per-request outcome list."""
    import numpy as np

    from repro_torch.core.compile import compile_spec
    from repro_torch.portal.gateway import result_digest
    from repro_torch.serve import SpikeServer
    from repro_torch.serve.__main__ import demo_spec

    compiled = compile_spec(demo_spec(16, 64), target="engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    srv.add_model("demo", compiled, window=8, n_sessions=4, seed=0,
                  device=device)
    plan = install(FaultPlan.from_spec(plan_spec, seed=seed,
                                       log_path=log_path))
    outcomes = []
    try:
        with srv:
            rng = np.random.default_rng(0)
            for r in range(n_requests):
                counts = rng.integers(0, 2, (8, 16)).astype(np.int32)
                try:
                    res = srv.submit("demo", counts, seed=r).result(
                        timeout=60)
                    outcomes.append(
                        ("ok", result_digest(res.spikes, res.membrane)))
                except Exception as e:  # noqa: BLE001 — outcome record
                    outcomes.append(("err", type(e).__name__))
            hz = srv.health()
            outcomes.append(("health", hz["status"],
                             f"restarts={hz['restarts']}"))
    finally:
        uninstall()
    return outcomes


def _cmd_demo(args) -> int:
    spec = args.plan
    print(f"plan: {spec!r}  seed={args.seed}  "
          f"requests={args.requests}  device={args.device}")
    run1 = _chaos_run(spec, args.seed, args.requests, args.log,
                      args.device)
    run2 = _chaos_run(spec, args.seed, args.requests, args.log,
                      args.device)
    for i, o in enumerate(run1):
        print(f"  req[{i}] -> {o}")
    identical = run1 == run2
    print(f"replay bit-identical: {identical}")
    if args.log:
        print(f"fault log: {args.log}")
    return 0 if identical else 1


def _cmd_portal_smoke(args) -> int:
    import http.client
    import time

    import numpy as np

    from repro_torch.core.compile import compile_spec
    from repro_torch.portal.gateway import Portal
    from repro_torch.serve import SpikeServer
    from repro_torch.serve.__main__ import demo_spec

    # workers inherit the armed plan through the environment: the K-th
    # admitted request in SOME worker hard-exits that worker process
    os.environ["REPRO_FAULTS"] = args.plan
    os.environ["REPRO_FAULTS_SEED"] = str(args.seed)
    if args.log:
        os.environ["REPRO_FAULTS_LOG"] = os.path.abspath(args.log)

    compiled = compile_spec(demo_spec(16, 64), target="engine")
    srv = SpikeServer(max_batch=4, max_wait_ms=1.0)
    srv.add_model("demo", compiled, window=8, n_sessions=4, seed=0,
                  device=args.device)

    def req(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        payload = None if body is None else json.dumps(body)
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out = json.loads(r.read().decode("utf-8"))
        conn.close()
        return r.status, out

    counts = np.random.default_rng(0).integers(
        0, 2, (8, 16)).astype(np.int32).tolist()
    digests, retried = [], 0
    with srv, Portal(srv, port=0, workers=args.workers) as portal:
        for i in range(args.requests):
            for attempt in range(6):
                try:
                    s, out = req(portal.port, "POST",
                                 "/v1/demo/run",
                                 {"counts": counts, "seed": 0})
                except OSError:
                    # the connection we hit belonged to the dying
                    # worker — retry lands on a survivor (or the
                    # respawned one)
                    retried += 1
                    time.sleep(0.2)
                    continue
                break
            else:
                print("FAIL: request never succeeded after retries")
                return 1
            if s != 200:
                print(f"FAIL: request {i} -> HTTP {s}: {out}")
                return 1
            digests.append(out["digest"])
            time.sleep(args.spacing_s)
        deadline = time.monotonic() + 30
        while portal.worker_restarts < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        restarts = portal.worker_restarts
        s, hz = req(portal.port, "GET", "/healthz")
    ok = (restarts >= 1 and s == 200 and hz["status"] == "ok"
          and len(set(digests)) == 1)
    print(f"served {len(digests)} requests across worker kill "
          f"(retried {retried}); worker restarts: {restarts}; "
          f"final healthz: {hz['status']}; "
          f"digests identical: {len(set(digests)) == 1}; "
          f"device: {args.device}; digest: {digests[0]}")
    print("portal-smoke:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.faults")
    sub = ap.add_subparsers(dest="cmd")

    ls = sub.add_parser("list", help="show fault sites + the env plan")
    ls.set_defaults(fn=_cmd_list)

    d = sub.add_parser("demo", help="deterministic chaos replay "
                                    "against a live SpikeServer")
    d.add_argument("--plan",
                   default="dispatch_crash@2;batch_exception@5")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--requests", type=int, default=8)
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the demo model runs")
    d.add_argument("--log", default=None, metavar="PATH",
                   help="append NDJSON trigger records to PATH")
    d.set_defaults(fn=_cmd_demo)

    p = sub.add_parser("portal-smoke",
                       help="multi-worker portal; one worker "
                            "hard-exits mid-traffic and is respawned")
    p.add_argument("--plan", default="worker_exit@3")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--spacing-s", type=float, default=0.05)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the demo model runs")
    p.add_argument("--log", default=None, metavar="PATH")
    p.set_defaults(fn=_cmd_portal_smoke)

    args = ap.parse_args(argv)
    if not getattr(args, "fn", None):
        return _cmd_list(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
