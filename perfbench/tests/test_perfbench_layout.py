"""What the benchmark may load, how it finds a cell's files by name, and
BENCHMARK.json against the contract the harness is written to."""
import ast
import hashlib
import json
import re
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.harness.registry import Bench
from perfbench.tests import tiny_bench

ROOT = tiny_bench.ROOT
PB = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    """Top-level names of every module `path` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("part", ["harness", "reference", "counts",
                                  "drivers", "metrics", "tests", "."])
def test_no_module_imports_jax_or_the_jax_package(part):
    files = sorted((PB / part).glob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & FORBIDDEN
        if part == "reference":
            bad |= _imports(f) & {"repro_torch"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def _fresh_modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT}/src"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax_and_the_reference_no_port(tmp_path):
    tiny_bench.make_root(tmp_path)
    loaded = _fresh_modules(
        "import json, sys\n"
        "from perfbench.harness.registry import Bench\n"
        "from perfbench.tests import tiny_bench\n"
        f"b = Bench({str(tmp_path)!r})\n"
        "tiny_bench.run_tiny(b, 'tiny_core.lanes', 5, windows=2)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" in loaded and not loaded & FORBIDDEN
    ref = _fresh_modules(
        "import json, sys\n"
        "import perfbench.reference.snn, perfbench.reference.threefry\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref & (FORBIDDEN | {"repro_torch"})


def test_run_refuses_without_a_card():
    if run.cards_for({"name": "x", "chips": 1}):
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hiaer_core.lanes64", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    root = tiny_bench.make_root(tmp_path)
    before = _digest(root)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "tiny_core.json").read_text())
    cfg["neurons_per_core"] = 700
    (pb / "configs" / "later_core.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny_core_lanes.json").read_text())
    mix["lanes"] = 3
    (pb / "traffic" / "later_lanes3.json").write_text(json.dumps(mix))
    (pb / "metrics" / "later_windows.py").write_text(
        '"""Windows run in the measured window."""\n\n\n'
        "def read(r):\n    return r.steps // 8 if r.steps else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "later_core", "source": "tiny",
                             "file": "perfbench/configs/later_core.json",
                             "reduced": [], "why": "a later PR's"})
    bench["workloads"].append({"name": "later_core.lanes3",
                               "config": "later_core",
                               "traffic": "later_lanes3", "chips": 1,
                               "why": "a later PR's"})
    for m in bench["end_to_end"]:
        if "tiny_core.lanes" in m.get("workloads", ()):
            m["workloads"].append("later_core.lanes3")
    bench["end_to_end"].append({"name": "later_windows", "unit": "windows",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["later_core.lanes3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(root)
    assert {k: after[k] for k in before} == before
    b = Bench(root)
    res = tiny_bench.run_tiny(b, "later_core.lanes3", 7, windows=3)
    assert res["correct"] is True
    assert res["metrics"]["later_windows"]["value"] == 3
    assert {"setup_s", "lane_steps_per_s"} <= set(res["metrics"])
    assert res["attempted"] == 3 * 3


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "perfbench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]) \
            .is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = _spec()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = w["name"]
        mine = [m for m in b["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in b["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert layer
        for m in layer:   # each moves an end-to-end metric the cell reports
            assert m["moves"] in e2e
            assert cell in e2e[m["moves"]].get("workloads", [cell])

