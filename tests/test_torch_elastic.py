"""Data parallelism with ZeRO-1 moments and the elastic restart
(`repro_torch.launch.steps`, `distributed.elastic.reshard_tree`, the
checkpoint store's blocks), on the CPU.

Two gloo ranks (`tests/_torch_dist_ranks.py dp`) train reduced
qwen2_5_3b on a (data 2, model 1) mesh at B = 4 (two rows a rank, their
loss masks keeping ~90 % and ~40 % of the tokens, so a mean of the
ranks' means would be wrong): three steps against JAX's jitted step
from the same parameters on a (2, 1) mesh of 2 virtual devices
(`tests/_jax_dist_ref.py dp`), and against the same steps at world size
1 on the whole batch (rank 0 runs them too): losses within
1e-5, moments within 1e-5 (each rank's ZeRO-1 blocks assembled),
parameters within 1e-5 where Adam's step is well-conditioned
(`test_train_step_matches_jax`'s rule). With the int8 compressor the
ranks stay bit for bit equal (each compresses the same reduced
gradients); a world-size-1 run is not held to them, since rounding a
gradient that sits on a quantization boundary one way or the other is a
step of lr.
After step 2 both ranks save (each its moment blocks as shards) and rank
0 restores onto world size 1 through `reshard_tree`: the tree equals the
ranks' state bit for bit, and its next step equals the ranks' third.
Then JAX's `tests/test_elastic.py` scenario at the shape level: a (2, 4)
mesh's blocks resharded onto (4, 2), every block put back bit for bit,
the specs JAX's own."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dist_ranks import dp_batch
from repro.configs import get_reduced as jget_reduced
from repro.distributed import context as jcontext
from repro.launch.sharding import ShardingRules as JRules
from repro_torch.checkpoint.store import restore_tree, save_tree
from repro_torch.configs import get_reduced
from repro_torch.distributed.context import Mesh, mesh_context
from repro_torch.distributed.elastic import reshard_tree
from repro_torch.launch.sharding import ShardingRules, assemble
from repro_torch.models import lm as tlm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = [1e-2 * t / 2 for t in (1, 2, 2)]   # lr 1e-2, warmup 2, steps 1-3
DP = Mesh((2, 1), ("data", "model"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' npz, JAX's npz of its jitted step on 2 virtual
    devices from each state the ranks stepped from, `tests/
    _jax_dist_ref.py dp`)."""
    d = tmp_path_factory.mktemp("dp")
    for cmd in ([sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
                 "dp", str(d), str(d / "store")],
                [sys.executable, str(ROOT / "tests" / "_jax_dist_ref.py"),
                 "dp", str(d)]):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=str(ROOT))
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return [np.load(d / f"rank{r}.npz") for r in range(2)], \
        np.load(d / "jax_dp.npz")


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


def names(out, prefix):
    return [k[len(prefix):] for k in out.files if k.startswith(prefix)]


def moments(ranks, t, key):
    """The ranks' ZeRO-1 blocks of mu or nu after step t, assembled."""
    rules = ShardingRules(get_reduced("qwen2_5_3b"), DP, "heads")
    out = {}
    for n in names(ranks[0], f"dp/{t}/{key}/"):
        full = ranks[0][f"dp/{t}/params/{n}"]
        spec = rules.held_moment_spec(n, full.shape)
        out[n] = assemble([r[f"dp/{t}/{key}/{n}"] for r in ranks], spec,
                          full.shape, DP)
    return out


def held(got, want, nu, lr_sum, t):
    """Parameters within TOL where sqrt(nu_hat) >= 1e-6, within 2 lr a
    step elsewhere; returns (ill-conditioned, all) element counts."""
    gap = np.abs(got - want)
    well = (nu == 0) | (np.sqrt(nu / (1 - 0.95 ** (t + 1))) >= 1e-6)
    assert gap[well].max(initial=0) < TOL
    assert gap.max() <= 2 * lr_sum
    return int((~well).sum()), gap.size


def test_ranks_loss_masks_differ():
    m = dp_batch()["loss_mask"]
    assert m[:2].sum() > 1.5 * m[2:].sum()


@pytest.mark.parametrize("t", [0, 1, 2])
def test_data_parallel_step_matches_world_one(ranks, t):
    r0 = ranks[0]
    assert abs(float(r0[f"dp/loss{t}"]) - float(r0[f"w1/loss{t}"])) < TOL
    assert float(ranks[1][f"dp/loss{t}"]) == float(r0[f"dp/loss{t}"])
    mom = {k: moments(ranks, t, k) for k in ("mu", "nu")}
    n_ill = n_all = 0
    for n in names(r0, f"dp/{t}/params/"):
        for k in ("mu", "nu"):
            want = r0[f"w1/{t}/{k}/{n}"]
            assert np.max(np.abs(mom[k][n] - want)) < TOL, (k, n)
        want = r0[f"w1/{t}/params/{n}"]
        for r in ranks:
            i, a = held(r[f"dp/{t}/params/{n}"], want, r0[f"w1/{t}/nu/{n}"],
                        sum(LR[:t + 1]), t)
            n_ill, n_all = n_ill + i, n_all + a
    assert n_ill < 1e-2 * n_all


@pytest.mark.parametrize("t", [0, 1, 2])
def test_data_parallel_step_matches_jax(runs, t):
    """The two ranks' step t against JAX's jitted step on 2 virtual
    devices (batch by `batch_specs`, moments by `opt_specs`) from the
    same state (the ranks' state before step t, their moments'
    ZeRO-1 blocks assembled), with `test_torch_train.py`'s tolerances
    on a step: the loss and the assembled moments within 1e-5,
    parameters within 1e-5 where Adam's step is well-conditioned
    (sqrt(nu_hat) >= 1e-6, by JAX's nu), within 2 lr elsewhere, under
    1 % of the elements ill-conditioned. Each step starts from the
    ranks' state, so an ill-conditioned element's step of order lr does
    not carry into the next step's gradients."""
    ranks, jax_out = runs
    from repro_torch.checkpoint.store import layer_of
    for r in ranks:
        assert abs(float(r[f"dp/loss{t}"])
                   - float(jax_out[f"loss{t}"])) < TOL
    mom = {k: moments(ranks, t, k) for k in ("mu", "nu")}

    def jax_leaf(key, n):
        path, i = layer_of(n)
        a = jax_out[f"{t}/{key}/" + "/".join(path)]
        return a if i is None else a[i]
    n_ill = n_all = 0
    for n in names(ranks[0], f"dp/{t}/params/"):
        for k in ("mu", "nu"):
            want = jax_leaf(k, n)
            assert mom[k][n].shape == want.shape, (k, n)
            assert np.max(np.abs(mom[k][n] - want)) < TOL, (k, n)
        for r in ranks:
            i, a = held(r[f"dp/{t}/params/{n}"], jax_leaf("params", n),
                        jax_leaf("nu", n), LR[t], t)
            n_ill, n_all = n_ill + i, n_all + a
    assert n_ill < 1e-2 * n_all, (n_ill, n_all)


def test_compressed_ranks_agree_and_compress(ranks):
    """int8 on the reduced gradients: both ranks hold the same
    parameters, the first loss is the plain run's, and the update is not
    the plain one."""
    r0, r1 = ranks
    assert float(r0["dpc/loss0"]) == float(r0["dp/loss0"])
    moved = 0
    for t in (0, 1):
        for n in names(r0, f"dpc/{t}/params/"):
            assert np.array_equal(r0[f"dpc/{t}/params/{n}"],
                                  r1[f"dpc/{t}/params/{n}"]), n
            moved += not np.array_equal(r0[f"dpc/{t}/params/{n}"],
                                        r0[f"dp/{t}/params/{n}"])
    assert moved > 0


def test_train_step_records_its_collectives(ranks):
    """`train_step.wire`: each rank's all-reduce carries every gradient
    (fp32) and its all-gather the other rank's half of every cut leaf,
    each with the milliseconds it took; nothing at world size 1."""
    r0 = ranks[0]
    n_el = sum(r0[f"dp/0/params/{n}"].size for n in names(r0, "dp/0/params/"))
    cut = sum(r0[f"dp/0/params/{n}"].size for n in names(r0, "dp/0/mu/")
              if r0[f"dp/0/mu/{n}"].size * 2 == r0[f"dp/0/params/{n}"].size)
    for r in ranks:
        for t in range(3):
            ar, ag, ar_ms, ag_ms = r[f"dp/wire{t}"]
            assert ar == 4 * n_el and ag == 4 * cut
            assert ar_ms > 0 and ag_ms > 0
    assert not r0["w1/wire0"].any()


def test_moments_are_zero1_blocks(ranks):
    """Each rank holds half of every moment leaf that has a dim of even
    size; the parameters whole."""
    r0 = ranks[0]
    halves = 0
    for n in names(r0, "dp/0/mu/"):
        p, m = r0[f"dp/0/params/{n}"], r0[f"dp/0/mu/{n}"]
        halves += m.size * 2 == p.size
        assert m.size in (p.size, p.size // 2)
    assert halves > 0


def test_elastic_restore_onto_world_one_is_bit_exact(ranks):
    r0 = ranks[0]
    assert int(r0["el/step"]) == 2 and int(r0["el/aux_step"]) == 2
    mom = {k: moments(ranks, 1, k) for k in ("mu", "nu")}
    ps = names(r0, "dp/1/params/")
    assert ps == names(r0, "el/restored/params/")
    for n in ps:
        assert np.array_equal(r0[f"el/restored/params/{n}"],
                              r0[f"dp/1/params/{n}"]), n
        for k in ("mu", "nu"):
            assert np.array_equal(r0[f"el/restored/{k}/{n}"], mom[k][n]), n


def test_elastic_next_step_matches_the_ranks(ranks):
    r0 = ranks[0]
    assert abs(float(r0["el/loss2"]) - float(r0["dp/loss2"])) < TOL
    n_ill = n_all = 0
    nu = moments(ranks, 2, "nu")
    for n in names(r0, "el/2/params/"):
        i, a = held(r0[f"el/2/params/{n}"], r0[f"dp/2/params/{n}"], nu[n],
                    LR[2], 2)
        n_ill, n_all = n_ill + i, n_all + a
    assert n_ill < 1e-2 * n_all


# ------------------------------------------------------------ shape level
class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


def _jspec(jrules, name, shape):
    """JAX's spec of a port leaf (its stacked leaf's, less the layer
    axis)."""
    from jax.tree_util import DictKey
    from repro_torch.checkpoint.store import layer_of
    path, i = layer_of(name)
    jshape = ((2,) + tuple(shape)) if i is not None else tuple(shape)

    class Leaf:
        pass
    leaf = Leaf()
    leaf.shape = jshape
    spec = tuple(jrules.param_spec([DictKey(p) for p in path], leaf))
    return spec[1:] if i is not None else spec


@pytest.mark.parametrize("a,b", [((2, 4), (4, 2))])
def test_reshard_between_meshes_at_the_shape_level(tmp_path, a, b):
    """JAX's test_elastic scenario (reduced gemma_7b, a (2, 4) mesh
    rebuilt as (4, 2)) without eight processes: every rank's blocks
    under one mesh, saved as shards, restored and resharded onto the
    other; the blocks assemble to the parameters bit for bit, the specs
    equal JAX's `ShardingRules` on each mesh, and the loss is
    unchanged."""
    cfg = get_reduced("gemma_7b")
    model = tlm.init_params(cfg, 0, torch.float32, "cpu")
    state = model.state_dict()
    batch = {"tokens": torch.ones((2, 16), dtype=torch.long)}
    loss_a = tlm.loss_fn(model, cfg, batch)[0]
    for shape in (a, b):
        mesh = Mesh(shape, ("data", "model"))
        prev = getattr(jcontext._state, "mesh", None)
        jcontext._state.mesh = FakeMesh(shape)
        try:
            jrules = JRules(jget_reduced("gemma_7b"), FakeMesh(shape),
                            "heads")
            with mesh_context(mesh):
                rules = ShardingRules(cfg, mesh, "heads")
                for n, t in state.items():
                    assert rules.param_spec(n, t.shape) == _jspec(
                        jrules, n, t.shape), n
        finally:
            jcontext._state.mesh = prev
    src = Mesh(a, ("data", "model"))
    # every rank of mesh a writes its moment-style blocks (ZeRO-1 over
    # 'data') as shards; restored, then resharded onto mesh b
    rules = ShardingRules(cfg, src, "heads")
    specs = {n: rules.held_moment_spec(n, t.shape) for n, t in state.items()}
    for r in reversed(range(src.size)):
        m = Mesh(a, ("data", "model"), rank=r)
        blocks = reshard_tree({"mu": state, "nu": state, "step":
                               torch.tensor(0)}, cfg, m, "opt",
                              device="cpu")["mu"]
        save_tree(tmp_path / "ck", {"params": blocks}, specs={
            "params": specs}, mesh=m, attempt="one")
    back, _ = restore_tree(tmp_path / "ck",
                           {"params": dict.fromkeys(state)})
    for n in state:
        assert torch.equal(back["params"][n], state[n]), n
    dst = Mesh(b, ("data", "model"))
    rules_b = ShardingRules(cfg, dst, "heads")
    per_rank = [reshard_tree({"mu": back["params"], "nu": back["params"],
                              "step": torch.tensor(0)}, cfg,
                             Mesh(b, ("data", "model"), rank=r), "opt",
                             device="cpu")["mu"] for r in range(dst.size)]
    for n, t in state.items():
        spec = rules_b.held_moment_spec(n, t.shape)
        full = assemble([p[n] for p in per_rank], spec, t.shape, dst)
        assert torch.equal(full, t), n
    model.load_state_dict(back["params"])
    assert torch.equal(tlm.loss_fn(model, cfg, batch)[0], loss_a)


def test_a_save_ignores_what_an_interrupted_save_left(tmp_path,
                                                      monkeypatch):
    """A step saved again after an interrupted save of it (an elastic
    restart): the leftover directory holds every rank's marker, old and
    of another attempt, and stale blocks. Rank 0 of the new attempt does
    not finish on those markers (it times out while rank 1's own is
    missing); once rank 1 has written, the checkpoint holds the new
    blocks and nothing of the old save. A shape-only mesh's save must
    name its attempt."""
    from repro_torch.checkpoint import store
    monkeypatch.setattr(store, "MARKER_TIMEOUT_S", 0.2)
    mesh = [Mesh((2, 1), ("data", "model"), rank=r) for r in (0, 1)]
    full = torch.arange(8, dtype=torch.float32)
    specs = {"w": ("data",)}
    tmp = tmp_path / "step_1.tmp"
    tmp.mkdir()
    for r in (0, 1):
        (tmp / f".done{r}").write_text("")
        (tmp / f".done{r}.old").write_text("")
        np.save(tmp / f"w.shard{r}.npy", np.full(4, -1, np.float32))
    np.save(tmp / "v.npy", np.zeros(3, np.float32))
    with pytest.raises(TimeoutError, match="attempt new"):
        save_tree(tmp_path / "step_1", {"w": full[:4]}, specs=specs,
                  mesh=mesh[0], attempt="new")
    assert not (tmp_path / "step_1").exists()
    save_tree(tmp_path / "step_1", {"w": full[4:]}, specs=specs,
              mesh=mesh[1], attempt="new")
    save_tree(tmp_path / "step_1", {"w": full[:4]}, specs=specs,
              mesh=mesh[0], attempt="new")
    assert sorted(p.name for p in (tmp_path / "step_1").iterdir()) == [
        "index.json", "w.shard0.npy", "w.shard1.npy"]
    back, _ = restore_tree(tmp_path / "step_1", {"w": None})
    assert torch.equal(back["w"], full)
    with pytest.raises(ValueError, match="attempt"):
        save_tree(tmp_path / "step_2", {"w": full[:4]}, specs=specs,
                  mesh=mesh[0])


def test_reshard_tree_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        reshard_tree({}, get_reduced("gemma_7b"),
                     Mesh((1, 1), ("data", "model")), "cache", device="cpu")


def test_launch_train_local_mesh_under_torchrun_then_world_one(tmp_path,
                                                              capsys):
    """`torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh
    local --compress int8` on the reduced MoE: a (1, 2) mesh, experts
    and the dense layers' heads, d_ff and vocab split over the two
    ranks, rank 0 logging each step; its checkpoint (the held blocks as
    shards, the norms whole) resumes at world size 1 through
    `reshard_tree` and runs on."""
    import os
    import re
    ck = tmp_path / "ck"
    args = ["--arch", "deepseek_moe_16b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--log-every", "1", "--compress",
            "int8", "--ckpt-dir", str(ck)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
         "--mesh", "local", "--steps", "2"], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"], lines
    files = {p.name for p in (ck / "step_00000002").iterdir()}
    assert "params__blocks__moe__w_in.shard1.npy" in files
    assert "params__embed__table.shard1.npy" in files
    assert "params__final_norm__scale.npy" in files
    assert all(np.isfinite(float(re.search(r"loss=(\S+)", ln).group(1)))
               for ln in lines)
    from repro_torch.launch import train as ttrain
    capsys.readouterr()
    loss = ttrain.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[resume] from step 2" in out and "step 2: loss=" in out
    assert np.isfinite(loss)
