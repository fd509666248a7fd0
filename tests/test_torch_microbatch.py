"""Gradient accumulation over microbatches on more than one rank (ROADMAP
item 10.6): the port's `make_train_step(microbatches=2)` held to JAX's
jitted `make_train_step(microbatches=2)` on the same (data, model)
meshes, on the CPU.

The port's four gloo ranks (`tests/_torch_dist_ranks.py mb`) and JAX on
8 virtual devices (`tests/_jax_dist_ref.py mb`) run `MB_CASES` together;
JAX takes each step from the state the ranks started it from. The cases,
reduced widths in fp32, two steps each:
  * qwen2_5_3b on (data 2, model 1) with ZeRO-1 moments, B = 4;
  * the same with the int8 compressor (both compress the port's reduced
    gradients, JAX's own held to them within 1e-4, as
    tests/test_torch_compression.py does: int8 rounding is a step
    function);
  * qwen2_5_3b on (2, 2) in "heads";
  * deepseek_moe_16b expert-parallel on (1, 2);
  * B = 2 on (2, 1): a microbatch's one row does not divide over 'data',
    so each rank runs it whole, counted once; JAX's step runs it too;
and B = 3, which the port refuses with `ValueError` where JAX's reshape
raises.

Tolerances (those of tests/test_torch_model_axis.py's training step):
the loss within 1e-5; moments within 1e-5 of max(1, their largest
magnitude); parameters within 1e-5 where Adam's step is well-conditioned
(sqrt(nu_hat) >= 1e-6) and within 2 lr elsewhere, the ill-conditioned
elements under 1 %. The port reduces the fp32 sum of the microbatches'
gradients once, where JAX's program may reduce each microbatch's: the
sums are reordered, which these tolerances hold.

Serial time of the file: CHANGES.md (PR 31).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from _torch_dist_ranks import (MB_STEPS, mb_cases, mb_state,  # noqa: E402
                               tp_cfg)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

CASES = mb_cases()
TOL = 1e-5
B2 = 0.95               # AdamWConfig's default b2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks and JAX's process, started together (JAX runs
    what needs nothing of the ranks first)."""
    d = tmp_path_factory.mktemp("mb")
    cmds = [[sys.executable, str(ROOT / "tests" / "_jax_dist_ref.py"), "mb",
             str(d)],
            [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
             "mb", str(d), str(d / "store")]]
    logs = [d / f"proc{i}.log" for i in range(len(cmds))]
    procs = []
    try:
        for cmd, log in zip(cmds, logs):     # a file each: no pipe fills
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT,
                                              cwd=str(ROOT)))
        for p in procs[::-1]:
            p.wait(timeout=500)
            if p.returncode:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-6000:]
    return (np.load(d / "jax_mb.npz"),
            [np.load(d / f"rank{r}.npz") for r in range(4)])


def _nest(out, prefix):
    tree = {}
    for k in out.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = out[k]
    return tree


def _pairs(c, jax_out, ranks, t, kind, jkind=None):
    """{name: (the port's leaf assembled from the ranks' blocks, JAX's)}
    after step t."""
    cfg = tp_cfg(get_reduced, c)
    pre = f"{c['name']}/{t}/{jkind or kind}/"
    want = params_from_jax(_nest(jax_out, pre), cfg)
    got = mb_state(ranks, c, t, kind, cfg)
    assert want and got.keys() == want.keys()
    return {n: (got[n], want[n].numpy()) for n in want}


def _near(got, want, tol=TOL):
    gap = float(np.abs(got - want).max())
    assert gap <= tol * max(1.0, float(np.abs(want).max())), gap


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_microbatched_step_matches_jax(runs, c):
    """Each of the two steps: the loss on every rank, the moments and the
    parameters assembled from the ranks' blocks (the module
    docstring)."""
    jax_out, ranks = runs
    name, n_ranks = c["name"], int(np.prod(c["shape"]))
    for t in range(MB_STEPS):
        for r in range(n_ranks):
            assert abs(float(ranks[r][f"{name}/{t}/loss"])
                       - float(jax_out[f"{name}/{t}/loss"])) <= TOL, (t, r)
            assert float(ranks[r][f"{name}/{t}/lr"]) == \
                float(jax_out[f"{name}/{t}/lr"])
        for k in ("mu", "nu"):
            for n, (got, want) in _pairs(c, jax_out, ranks, t, k).items():
                _near(got, want)
        nu = _pairs(c, jax_out, ranks, t, "nu")
        lr = float(jax_out[f"{name}/{t}/lr"])
        n_ill = n_all = 0
        for n, (got, want) in _pairs(c, jax_out, ranks, t,
                                     "params").items():
            v = nu[n][1]
            gap = np.abs(got - want)
            well = (v == 0) | (np.sqrt(v / (1 - B2 ** (t + 1))) >= 1e-6)
            assert gap[well].max(initial=0) <= TOL, (t, n)
            assert gap.max() <= 2 * lr, (t, n)
            n_ill += int((~well).sum())
            n_all += gap.size
        assert n_ill < 1e-2 * n_all, (t, n_ill, n_all)


def test_compressed_case_hands_jax_its_gradients(runs):
    """The int8 case: the reduced gradients the port hands its compressor
    equal JAX's own within 1e-4 of their largest magnitude (the port's
    are what both compress)."""
    jax_out, ranks = runs
    c, = [c for c in CASES if c["compress"]]
    for t in range(MB_STEPS):
        pairs = _pairs(c, jax_out, ranks, t, "handed", "own")
        for n, (got, want) in pairs.items():
            assert np.abs(want).max() > 0, n
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), n


def test_all_reduce_moves_the_fp32_gradients_once(runs):
    """On (2, 1) every leaf's gradient is summed over 'data': the step's
    all-reduce is the fp32 size of the rank's leaves once, not once a
    microbatch (no leaf is cut, so the norm needs no collective)."""
    _, ranks = runs
    c = CASES[0]
    assert c["shape"] == (2, 1)
    cfg = tp_cfg(get_reduced, c)
    n = sum(int(np.prod(s)) for s in lm.param_shapes(cfg).values())
    for t in range(MB_STEPS):
        for r in (0, 1):
            assert int(ranks[r][f"{c['name']}/{t}/wire"]) == 4 * n


def test_rows_that_do_not_cut_into_microbatches_raise(runs):
    """B = 3 rows in 2 microbatches: the port's ranks raise `ValueError`
    before any collective, JAX's reshape raises `TypeError`."""
    jax_out, ranks = runs
    assert str(jax_out["odd/raised"]) == "TypeError"
    for r in (0, 1):
        assert "3 rows" in str(ranks[r]["odd/raised"]), r
