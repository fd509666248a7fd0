"""Run one cell of the benchmark once, as the driver does:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks`, every number compared beside its limit
(also the last lines on standard error). Exits 2 with no result without a
CUDA card or with fewer cards than the cell asks for; 3 when the process
has loaded JAX or the JAX package."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    """One run's settings, handed to the cell's driver."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    max_windows: int = 0        # lanes cells: stop after so many windows


def release() -> None:
    """Hand the program's freed device memory back before the reference
    runs."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def prepare():
    """The checkout's packages on the path, its build and kernel caches
    at fixed paths inside it (the port's nvcc libraries go to
    build/repro_torch_kernels/ on their own); returns its `Bench`."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    from perfbench.harness.registry import Bench
    return Bench(ROOT)


def context(bench, cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = T_START) -> Context:
    w = bench.cell(cell)
    return Context(cell=cell, config=bench.config(w["config"]),
                   traffic=bench.traffic(w["traffic"]), seed=seed,
                   seconds=seconds, trace=trace, device=device,
                   t_start=t_start)


def cards_for(cell: dict) -> bool:
    """Whether this machine has the CUDA cards the cell asks for; says
    why not on standard error."""
    import torch
    if torch.cuda.is_available() \
            and torch.cuda.device_count() >= int(cell["chips"]):
        return True
    print(f"{cell['name']} needs {cell['chips']} CUDA card(s); found "
          f"{torch.cuda.device_count()}", file=sys.stderr)
    return False


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench, ctx: Context) -> dict:
    """Drive the cell once, then compare its sampled outputs with the
    reference, the program's state freed; assemble the result (without
    the device fields the card gives)."""
    from perfbench.harness import check
    out = bench.driver(ctx.traffic["driver"]).run(ctx)
    release()
    t0 = time.perf_counter()
    checks = check.compare(out["net"], out["dep_seed"], out["samples"],
                           out["failed"], out["min_checked"], ctx.device)
    print(f"reference check {time.perf_counter() - t0} s over "
          f"{len(out['samples'])} samples", file=sys.stderr, flush=True)
    checks.update(out["checks"])
    r = out["readings"]
    metrics = {}
    for m in bench.metrics(ctx.cell, ctx.trace):
        v = bench.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": check.holds(checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": {"memory_peak_bytes": int(out["memory_peak_bytes"])}}
    if ctx.trace and r.trace is not None:
        result["device"]["busy_s"] = r.trace.busy_s
        result["device"]["window_s"] = r.trace.window_s
        result["breakdown"] = r.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = prepare()
    cell = bench.cell(args.workload)
    if not cards_for(cell):
        return 2
    ctx = context(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    result = run_cell(bench, ctx)
    bad = loaded_forbidden()
    if bad:
        print(f"the process loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    import torch
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": int(cell["chips"]), **result["device"]}
    result["checks"] = result.pop("checks")
    from perfbench.harness import check
    check.report(result["checks"])
    for k, v in result["metrics"].items():
        if not math.isfinite(v["value"]):
            raise ValueError(f"metric {k} read {v['value']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
