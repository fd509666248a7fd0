"""Everything of a cell is found by name: its entry in BENCHMARK.json
names its configuration (whose `file` lies under `perfbench/configs/`)
and its traffic mix (`perfbench/traffic/<mix>.json`, whose `driver` names
`perfbench/drivers/<driver>.py`); each metric is read by
`perfbench/metrics/<metric>.py`. Adding a cell, a configuration, a mix or
a metric adds files and entries; no existing file changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Bench:
    """BENCHMARK.json of the checkout at `root` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json")
                          .read_text())

    def driver(self, name: str):
        return _load_module(self.dir / "drivers" / f"{name}.py",
                            f"perfbench_driver_{name}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` reports: with trace 0 the
        end-to-end ones, with trace 1 the per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if _applies(m, cell)]

    def reader(self, metric: str):
        """`read(readings)` of `perfbench/metrics/<metric>.py`."""
        mod = _load_module(self.dir / "metrics" / f"{metric}.py",
                           "perfbench_metric_" + metric.replace(".", "_"))
        return mod.read
