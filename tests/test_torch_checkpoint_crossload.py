"""Checkpoints across the two packages (`repro_torch.checkpoint.store`,
`models.weights.params_to_jax` / `opt_state_to_jax`), on the CPU.

For every LM family (dense, MoE, SSM, hybrid, MLA, VLM, audio; reduced
configs, MusicGen's in bf16) the JAX package saves parameters and an
AdamW state with `save_tree`, whole and sharded over a (2, 4) mesh of 8
virtual devices (`tests/_jax_dist_ref.py ckpt`, a subprocess). The
port restores both into its per-layer names bit for bit equal to
`params_from_jax` / `opt_state_from_jax` of JAX's own restore, with the
aux. The other way, the port's `CheckpointManager` saves the same state
whole and as every rank's blocks of a (2, 4) mesh (each rank of a
shape-only mesh writing its held blocks, rank 0 the index), and JAX's
`restore_tree` gives back its tree bit for bit. `params_to_jax` inverts
`params_from_jax` exactly. Then a run that JAX's `train.main --reduced`
checkpointed at step 2 resumes in the port's `train.main --device cpu`,
and step 3's loss is JAX's within 1e-5."""
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as jrestore_tree
from repro.configs import get_reduced as jget_reduced
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch.checkpoint import CheckpointManager, restore_tree
from repro_torch.configs import get_reduced
from repro_torch.distributed.context import Mesh
from repro_torch.distributed.elastic import reshard_tree
from repro_torch.launch import train as ttrain
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models.weights import (opt_state_from_jax, opt_state_to_jax,
                                        params_from_jax, params_to_jax)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["qwen2_5_3b", "deepseek_moe_16b", "mamba2_780m",
            "recurrentgemma_2b", "deepseek_v2_236b", "llava_next_mistral_7b",
            "musicgen_medium"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("crossload")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_jax_dist_ref.py"), "ckpt",
         str(d)], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return d


def jax_like(arch):
    cfg = jget_reduced(arch)
    dt = jax.numpy.bfloat16 if arch == "musicgen_medium" \
        else jax.numpy.float32
    p = jax.eval_shape(lambda k: jlm.init_params(cfg, k, dt),
                       jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    mom = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                      jax.numpy.float32), p)
    return {"params": p, "opt": {"mu": mom, "nu": mom,
                                 "step": jax.ShapeDtypeStruct(
                                     (), jax.numpy.int32)}}


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def t_bits(t):
    t = t.detach()
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


def port_like(names):
    return {"params": dict.fromkeys(names),
            "opt": {"mu": dict.fromkeys(names), "nu": dict.fromkeys(names),
                    "step": None}}


def jax_state(saved, arch):
    """JAX's own restore of its plain save, as numpy, and its aux."""
    tree, aux = jrestore_tree(saved / arch / "plain", jax_like(arch))
    return as_numpy(tree), aux


def assert_tree_bits(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    for path, x in fa:
        y = fb[path]
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        assert np.array_equal(bits(x), bits(y)), path


@pytest.mark.parametrize("layout", ["plain", "sharded"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_port_restores_jax_checkpoints(saved, arch, layout):
    ref, aux = jax_state(saved, arch)
    cfg = get_reduced(arch)
    want_p = params_from_jax(ref["params"], cfg)
    want_o = opt_state_from_jax(ref["opt"], cfg)
    got, got_aux = restore_tree(saved / arch / layout, port_like(want_p))
    assert got_aux == aux == {"seed": FAMILIES.index(arch), "step": 3,
                              "step_counter": 7}
    for n, t in want_p.items():
        assert got["params"][n].dtype == t.dtype, n
        assert np.array_equal(t_bits(got["params"][n]), t_bits(t)), n
        for k in ("mu", "nu"):
            assert torch.equal(got["opt"][k][n], want_o[k][n]), (k, n)
    assert int(got["opt"]["step"]) == 7
    if arch == "musicgen_medium":
        assert next(iter(got["params"].values())).dtype == torch.bfloat16


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "blocks"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_jax_restores_port_checkpoints(saved, tmp_path, arch, sharded):
    ref, aux = jax_state(saved, arch)
    cfg = get_reduced(arch)
    state = params_from_jax(ref["params"], cfg)
    opt = opt_state_from_jax(ref["opt"], cfg)
    mgr = CheckpointManager(tmp_path / "port")
    if not sharded:
        mgr.save(7, {"params": state, "opt": opt}, aux=aux)
    else:
        rules = ShardingRules(cfg, Mesh((2, 4), ("data", "model")), "heads")
        specs = {"params": rules.held_params_specs(state),
                 "opt": rules.held_opt_specs(state)}
        assert any("model" in s for s in specs["params"].values())
        for r in reversed(range(8)):          # rank 0 last: the index
            m = Mesh((2, 4), ("data", "model"), rank=r)
            blocks = {"params": reshard_tree(state, cfg, m, "params",
                                             device="cpu"),
                      "opt": reshard_tree(opt, cfg, m, "opt", device="cpu")}
            mgr.save(7, blocks, aux=aux, specs=specs, mesh=m,
                     attempt="one")
        files = [p.name for p in (tmp_path / "port" / "step_00000007")
                 .iterdir()]
        assert any(".shard7.npy" in f for f in files) or cfg.moe is None
        assert any(".shard4.npy" in f for f in files)    # data block 1
    tree, jaux = jrestore_tree(tmp_path / "port" / "step_00000007",
                               jax_like(arch))
    assert jaux == {**aux, "step": 7}
    assert_tree_bits(as_numpy(tree), ref)


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_restores_its_blocks_of_a_sharded_jax_save(saved, arch,
                                                        monkeypatch):
    """JAX's save sharded by `ShardingRules` on (data 2, model 4):
    `restore_blocks` gives each rank the blocks it holds (`held_spec`,
    `held_moment_spec`) bit for bit equal to the slices of JAX's own
    restore, reading only the shard files that overlap each block (a
    model-sharded leaf: one shard of four), never the whole leaf."""
    from repro_torch.checkpoint import store
    from repro_torch.launch.sharding import local_slice, rank_coords
    ref, aux = jax_state(saved, arch)
    cfg = get_reduced(arch)
    state = params_from_jax(ref["params"], cfg)
    opt = opt_state_from_jax(ref["opt"], cfg)
    mesh = Mesh((2, 4), ("data", "model"))
    rules = ShardingRules(cfg, mesh, "heads")
    specs = {"params": rules.held_params_specs(state),
             "opt": rules.held_opt_specs(state)}
    read = []
    load = store.np.load
    monkeypatch.setattr(store.np, "load", lambda f, *a, **k: (
        read.append(Path(f).name), load(f, *a, **k))[1])
    monkeypatch.setattr(store, "_load", None)      # no whole-leaf reads
    for r in range(8):
        coords = rank_coords(mesh, r)
        read.clear()
        got, gaux = store.restore_blocks(saved / arch / "sharded",
                                         port_like(state), specs, mesh,
                                         coords)
        assert gaux == aux
        for kind, tree in (("params", state), ("mu", opt["mu"]),
                           ("nu", opt["nu"])):
            blocks = got["params"] if kind == "params" else got["opt"][kind]
            sp = specs["params"] if kind == "params" else \
                specs["opt"][kind]
            for n, t in tree.items():
                want = t[local_slice(sp[n], t.shape, mesh, coords)]
                assert blocks[n].dtype == want.dtype, (kind, n)
                assert np.array_equal(t_bits(blocks[n]), t_bits(want)), \
                    (r, kind, n)
        assert int(got["opt"]["step"]) == int(opt["step"])
        mine = [f for f in read if f.startswith("params__embed__table")]
        assert len(mine) == 1, mine


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_to_jax_inverts_params_from_jax(saved, arch):
    ref, _ = jax_state(saved, arch)
    cfg = get_reduced(arch)
    back = params_to_jax(params_from_jax(ref["params"], cfg), cfg)
    opt = opt_state_to_jax(opt_state_from_jax(ref["opt"], cfg), cfg)
    to_np = lambda t: t_bits(t) if torch.is_tensor(t) else t  # noqa: E731
    assert_tree_bits(jax.tree.map(to_np, back),
                     jax.tree.map(bits, ref["params"]))
    assert_tree_bits(jax.tree.map(to_np, opt["mu"]), ref["opt"]["mu"])
    with pytest.raises(ValueError, match="layers"):
        params_to_jax({"blocks.0.ln1.scale": torch.ones(2)}, cfg)


def test_port_resumes_a_jax_run(tmp_path, capsys):
    """JAX's launcher trains 2 steps and checkpoints; the port's resumes
    from that checkpoint (cursor, parameters, moments, step) and its
    step 3 gives JAX's loss (JAX resuming a copy) within 1e-5."""
    args = ["--arch", "qwen2_5_3b", "--reduced", "--batch", "2", "--seq",
            "32", "--log-every", "1"]
    jtrain.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    capsys.readouterr()
    want = jtrain.main(args + ["--steps", "3", "--ckpt-dir",
                               str(tmp_path / "b")])
    got = ttrain.main(args + ["--steps", "3", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert out.count("[resume] from step 2") == 2
    assert abs(got - want) < 1e-5, (got, want)
