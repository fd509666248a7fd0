"""The control of a cell's `correct`, run on the card at the cell's own
size when its limits are set, never by the benchmark's own runs:

    python3 perfbench/control.py --workload <cell> --seconds 3 \
        --seeds <n> <n> <n>

For each seed, one short run of the cell as `run.py` makes it; its
sampled outputs are compared with the reference (the program's
readings), and then the reference computed with membranes of the next
precision below the configuration's is put in the program's place and
compared the same way (the control's readings). One JSON row a seed on
standard output: the numbers compared, program and control."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import run  # noqa: E402


def readings(bench, cell: str, seed: int, seconds: float,
             device: str = "cuda") -> dict:
    """{"program": {name: value}, "control": {name: value}} of one
    seed."""
    from perfbench.harness import check
    ctx = run.context(bench, cell, seed, seconds, False, device,
                      time.perf_counter())
    out = bench.driver(ctx.traffic["driver"]).run(ctx)
    run.release()
    args = (out["net"], out["dep_seed"])
    rows = {}
    for side, samples in (("program", out["samples"]),
                          ("control", check.control_samples(
                              *args, out["samples"], device))):
        c = check.compare(*args, samples, out["failed"],
                          out["min_checked"], device)
        rows[side] = {k: v["value"] for k, v in c.items()}
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = run.prepare()
    if not run.cards_for(bench.cell(args.workload)):
        return 2
    for seed in args.seeds:
        row = readings(bench, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
