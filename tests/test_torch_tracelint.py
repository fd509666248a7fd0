"""The port's step-path lint (`repro_torch.analysis.tracelint`) — the
counterpart of `tests/test_tracelint.py` for eager torch: rule detection,
roots from the table, closure across modules, the per-file allowlist,
the inline silencer, the CLI's exit codes and the shipped `src/repro_torch`
being clean. `tests/test_tracelint.py` keeps scanning `src/repro` only.
"""
import textwrap
from pathlib import Path

from repro_torch.analysis import tracelint
from repro_torch.analysis.tracelint import lint_file, lint_paths, main

SRC_ROOT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

BAD = textwrap.dedent("""\
    import numpy as np
    import torch


    def step(x, n):
        y = x.sum().item()
        z = np.maximum(3, 0)
        k = int(n)
        i = torch.nonzero(x)
        w = torch.where(x > 0)
        torch.cuda.synchronize()
        return helper(x) + y + z + k + i.sum() + w[0].sum()


    def helper(x):
        m = x.masked_select(x > 0)
        return x.cpu().numpy().sum() + m.tolist()[0]


    class Engine:
        def _run(self, x):
            return self._inner(x)

        def _inner(self, x):
            return bool(x)


    def not_a_root(x):
        return np.zeros(3) + x.item()
    """)
ROOTS = {"bad": ("step", "Engine._run")}


def write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return p


def rules_by_qualname(findings):
    out = {}
    for f in findings:
        out.setdefault(f.qualname, set()).add(f.rule)
    return out


def test_rules_roots_and_closure(tmp_path):
    findings = lint_file(write(tmp_path, "bad.py", BAD), ROOTS)
    got = rules_by_qualname(findings)
    # a root from the table: .item(), int() of a parameter,
    # synchronize, numpy, nonzero and one-argument where
    assert got["step"] == {"host-sync", "numpy-call", "data-shape"}
    assert sum(f.qualname == "step" and f.rule == "data-shape"
               for f in findings) == 2
    # reached through step's call: .cpu(), .numpy(), .tolist(),
    # masked_select
    assert got["helper"] == {"host-sync", "data-shape"}
    # a method root reaches self's methods: bool() of a parameter
    assert got["Engine._inner"] == {"host-sync"}
    # outside the table's closure: invisible however dirty
    assert "not_a_root" not in got
    f = findings[0]
    assert f.render().startswith(f"{f.path}:{f.line}: [")


def test_host_sync_only_for_parameters(tmp_path):
    src = textwrap.dedent("""\
        def step(x):
            n = int(3.5)
            return x * n + float(len(x.shape))
    """)
    assert lint_file(write(tmp_path, "m.py", src), {"m": ("step",)}) == []


def test_closure_across_modules(tmp_path):
    """A root's calls into other modules of the tree are chased: by a
    module alias and by a name imported from a module."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    write(pkg, "__init__.py", "")
    write(pkg, "a.py", textwrap.dedent("""\
        from pkg import b
        from pkg.c import far


        def root(x):
            return b.near(x) + far(x)
    """))
    write(pkg, "b.py", "def near(x):\n    return x.item()\n")
    write(pkg, "c.py", "def far(x):\n    return x.nonzero()\n"
                       "def untouched(x):\n    return x.item()\n")
    got = rules_by_qualname(lint_paths(pkg, {"pkg.a": ("root",)}))
    assert got == {"near": {"host-sync"}, "far": {"data-shape"}}


def test_roots_table_names_real_functions():
    """Every root of the table is a function of the shipped tree: a root
    that went stale would leave its step unscanned."""
    mods = tracelint._load_modules(SRC_ROOT)
    for mod, quals in tracelint.ROOTS.items():
        for q in quals:
            assert q in mods[mod].funcs, (mod, q)


def test_inline_allow_comment(tmp_path):
    src = textwrap.dedent("""\
        def step(x):
            return x.item()  # tracelint: allow=host-sync
    """)
    assert lint_file(write(tmp_path, "m.py", src), {"m": ("step",)}) == []
    # the comment silences ONLY the named rule
    src2 = src.replace("allow=host-sync", "allow=numpy-call")
    p2 = write(tmp_path, "m2.py", src2)
    assert [f.rule for f in lint_file(p2, {"m2": ("step",)})] == \
        ["host-sync"]


def test_file_allowlist(tmp_path, monkeypatch):
    src = "def step(x):\n    return x.item()\n"
    p = write(tmp_path, "homed_reader.py", src)
    roots = {"homed_reader": ("step",)}
    assert [f.rule for f in lint_file(p, roots)] == ["host-sync"]
    monkeypatch.setitem(tracelint.ALLOWLIST, "homed_reader.py",
                        {"host-sync": "a test's deliberate read"})
    assert lint_file(p, roots) == []


def test_allowlist_entries_point_at_real_files():
    """Every ALLOWLIST suffix names a file of the tree, and every silenced
    rule carries its reason."""
    for suffix, rules in tracelint.ALLOWLIST.items():
        assert (SRC_ROOT / suffix).is_file(), suffix
        for rule, why in rules.items():
            assert rule in ("host-sync", "data-shape", "numpy-call")
            assert isinstance(why, str) and len(why) > 20, (suffix, rule)


def test_main_exit_codes(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tracelint, "ROOTS", ROOTS)
    bad = write(tmp_path, "bad.py", BAD)
    assert main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[host-sync]" in out and "finding(s)" in out
    clean = write(tmp_path, "clean.py", "import torch\n")
    assert main([str(clean)]) == 0
    assert main([]) == 2


def test_shipped_tree_is_lint_clean():
    """The gate: src/repro_torch's step paths have no finding (modulo the
    reasoned ALLOWLIST and the inline silencers)."""
    findings = lint_paths(SRC_ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)
