"""A tiny copy of the benchmark for the CPU tests: the harness copied
under a temporary root with BENCHMARK.json's configurations shrunk in
scale (fewer neurons, axons and synapses out of each), one cell a path
(the fused engine, the hiaer tier on one core and on eight, the server)
and the metrics' entries mapped onto them."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CELLS = {               # tiny cell -> (the cell it stands for, config)
    "tiny_core.lanes": ("hiaer_core.lanes64", "tiny_core"),
    "tiny_tier.lanes": ("hiaer_tier.lanes16", "tiny_tier"),
    "tiny_8core.lanes": ("hiaer_tier.lanes16", "tiny_8core"),
    "tiny_core.served": ("hiaer_core.overload", "tiny_core"),
}
SCALE = {"tiny_core": ("hiaer_core", {"neurons_per_core": 1500}),
         "tiny_tier": ("hiaer_tier", {"neurons_per_core": 1500}),
         "tiny_8core": ("hiaer_tier", {"neurons_per_core": 200, "cores": 8,
                                       "hierarchy": [2, 2, 2]})}
SHRINK = {"axons": 64, "synapses_per_source": 24}
TRAFFIC = {"lanes": {"lanes": 4, "window": 8, "pool": 4,
                     "session_windows": 3, "check_lanes": 1,
                     "min_checked": 1, "trace_windows": 2},
           "served": {"rate": 20.0, "window": 8, "pool": 8,
                      "max_batch": 8, "check_share": 0.5,
                      "min_checked": 1, "trace_seconds": 0.5}}


def copy_harness(dest: Path) -> Path:
    """`perfbench/` (without its tests and caches) and BENCHMARK.json
    under `dest`; returns `dest`."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def make_root(dest: Path) -> Path:
    """The tiny benchmark under `dest`."""
    copy_harness(dest)
    pb = dest / "perfbench"
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, (src, scale) in SCALE.items():
        cfg = json.loads((pb / "configs" / f"{src}.json").read_text())
        cfg.update(scale, **SHRINK)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
    for cell, (real, cfg) in CELLS.items():
        w = next(w for w in bench["workloads"] if w["name"] == real)
        mix = json.loads((pb / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        mix.update(TRAFFIC[mix["driver"]])
        tiny_mix = cell.replace(".", "_")
        (pb / "traffic" / f"{tiny_mix}.json").write_text(json.dumps(mix))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": tiny_mix, "chips": 1,
                                   "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def run_tiny(bench, cell: str, seed: int, trace: bool = False,
             seconds: float = 1.0, windows: int = 4) -> dict:
    """One run of a tiny cell on the CPU (lanes cells: `windows` windows),
    as `run.py` makes it but for the card's fields."""
    from perfbench import run
    ctx = run.context(bench, cell, seed, seconds, trace, "cpu",
                      time.perf_counter())
    ctx.max_windows = windows
    return run.run_cell(bench, ctx)
