"""The load sweep behind a served cell's fixed rate, run once on the card
when the cell is defined:

    python3 perfbench/sweep.py --workload hiaer_core.overload --seed <n> \
        --seconds 8 --rates 100 200 300 400

One set-up as the cell's runs make it, then an open-loop stream of
`--seconds` at each rate in turn; one JSON row a rate on standard output
(`drivers.served.sweep`). The highest rate at which every request
answers, the sender keeps its schedule and the latency does not grow
over the stream is the capacity; a cell's traffic file states the
share of it (or the multiple, above capacity) that the cell offers."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = run.prepare()
    if not run.cards_for(bench.cell(args.workload)):
        return 2
    ctx = run.context(bench, args.workload, args.seed, args.seconds, False)
    if ctx.traffic["driver"] != "served":
        raise SystemExit(f"{args.workload} is not a served cell")
    for row in bench.driver("served").sweep(ctx, args.rates, args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
