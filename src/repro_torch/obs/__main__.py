"""CLI for the observability subsystem.

    python -m repro_torch.obs demo --out trace.json   # synthetic trace
    python -m repro_torch.obs validate trace.json     # structural check
    python -m repro_torch.obs fetch http://host:port --out trace.json
                                                # pull /trace from a
                                                # running portal

`validate` exits non-zero on any structural problem — it is the check
CI's trace-export smoke runs against generated files. `demo` emits a
small but realistic span tree (request -> bridge -> queue wait ->
dispatch) without needing a server, so the exporter/validator pair can
be smoked anywhere. `fetch` grabs a live portal's trace export (and
optionally its /metrics) using only stdlib HTTP.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from .trace import Tracer, chrome_trace, new_trace_id, \
    validate_chrome_trace

__all__ = ["main"]


def _demo_spans(tracer: Tracer, n_requests: int = 3) -> None:
    """Synthesize the canonical 4-stage request shape."""
    for i in range(n_requests):
        tid = new_trace_id()
        root = tracer.span("http_request", trace_id=tid,
                           method="POST", path="/v1/demo/run")
        bridge = tracer.span("gateway_call", ctx=root.ctx(), op="run")
        qw = tracer.span("queue_wait", ctx=bridge.ctx(), model="demo")
        time.sleep(0.001)
        qw.finish()
        disp = tracer.span("dispatch", ctx=bridge.ctx(),
                           model="demo", batch_size=i + 1,
                           bucket=1 << i)
        time.sleep(0.002)
        disp.finish()
        bridge.finish()
        root.finish(status=200)


def _cmd_demo(args) -> int:
    tracer = Tracer()
    _demo_spans(tracer, args.requests)
    doc = chrome_trace(tracer.spans())
    problems = validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"invalid: {p}", file=sys.stderr)
        return 1
    _write(args.out, doc)
    print(f"wrote {len(doc['traceEvents'])} events -> {args.out}")
    return 0


def _cmd_validate(args) -> int:
    with open(args.file, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    problems = validate_chrome_trace(doc)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    if problems:
        for p in problems:
            print(f"invalid: {p}", file=sys.stderr)
        return 1
    traces = {e["args"]["trace_id"] for e in events}
    print(f"ok: {len(events)} events, {len(traces)} trace(s)")
    return 0


def _cmd_fetch(args) -> int:
    base = args.url.rstrip("/")
    req = urllib.request.Request(base + "/trace")
    if args.token:
        req.add_header("Authorization", f"Bearer {args.token}")
    with urllib.request.urlopen(req, timeout=args.timeout) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    problems = validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"invalid: {p}", file=sys.stderr)
        return 1
    _write(args.out, doc)
    print(f"fetched {len(doc['traceEvents'])} events -> {args.out}")
    return 0


def _write(path: str, doc: dict) -> None:
    if path == "-":
        json.dump(doc, sys.stdout)
        sys.stdout.write("\n")
        return
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="write a synthetic Chrome trace")
    d.add_argument("--out", default="trace.json")
    d.add_argument("--requests", type=int, default=3)
    d.set_defaults(fn=_cmd_demo)

    v = sub.add_parser("validate",
                       help="structurally validate a Chrome trace file")
    v.add_argument("file")
    v.set_defaults(fn=_cmd_validate)

    f = sub.add_parser("fetch",
                       help="download /trace from a running portal")
    f.add_argument("url")
    f.add_argument("--out", default="trace.json")
    f.add_argument("--token", default=None)
    f.add_argument("--timeout", type=float, default=10.0)
    f.set_defaults(fn=_cmd_fetch)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
