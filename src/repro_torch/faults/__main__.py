"""`python -m repro_torch.faults` — chaos CLI for the port's serving
stack (the port of `python -m repro.faults`).

    python -m repro_torch.faults                  # list sites + env plan
    python -m repro_torch.faults demo             # replayable dispatcher
                                                  # chaos, on the card
    python -m repro_torch.faults demo --device cpu

`demo` arms a seeded plan against a live `SpikeServer`, drives a fixed
request sequence through injected dispatcher crashes and poisoned
batches, then REPLAYS the identical plan on a fresh server and asserts
the two runs produced the same outcome sequence and the same response
digests — deterministic chaos, the property the test-suite matrix is
built on. `portal-smoke` needs the portal (ROADMAP item 5b) and raises
`NotImplementedError` until it lands.
"""
from __future__ import annotations

import argparse
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
    raise NotImplementedError(
        "faults portal-smoke drives the portal, which the PyTorch port "
        "does not have yet (ROADMAP item 5b); run python -m repro.faults "
        "portal-smoke against the JAX package")


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
                       help="not ported yet (ROADMAP item 5b)")
    p.set_defaults(fn=_cmd_portal_smoke)

    args = ap.parse_args(argv)
    if not getattr(args, "fn", None):
        return _cmd_list(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
