"""The multi-rank half of tests/test_torch_{moe_parallel,elastic}.py:
gloo ranks on the CPU, started from a `FileStore`, that never import
jax.

    python tests/_torch_dist_ranks.py moe DIR STORE    # four ranks
    python tests/_torch_dist_ranks.py dp DIR STORE     # two ranks

`moe`: DIR holds `cases.json` (the expert-parallel cases: name, mesh
shape and axis names, arch, config changes, B, S) and `jax_moe.npz`
(each case's layer parameters and input, as `tests/_jax_dist_ref.py
moe` wrote them, and the expert-parallel training case's initial
parameters and batch). Every rank builds every mesh (the ranks outside
a mesh idle through it) and writes `rank{r}.npz`:
  * per case: the rank's output rows, aux and dropped-event count from
    `moe.apply_with_keep` (for a case marked `routed_only`, also the
    rows of the layer less its shared experts), and on rank 0
    `moe_apply_sharded_ref`'s (y, aux, dropped per shard) on the whole
    input;
  * the expert-parallel step on a (1, 2) mesh over ranks 0 and 1:
    loss, grad norm, the rank's parameters and moments after one
    `make_train_step`.
`dp` writes `rank{r}.npz` with three data-parallel steps on a (2, 1)
mesh at B = 4 with loss masks whose counts differ between the ranks'
rows, which rank 0 also runs at world size 1 on the whole batch; two
more steps with the int8 compressor; and the elastic round trip: the
state after step 2 saved by both ranks (each its ZeRO-1 blocks), then
saved again over what an interrupted save of it left (zeroed blocks,
every rank's marker), and restored on rank 0 through `reshard_tree`
onto world size 1, then stepped once more.
Prints DIST-RANKS-OK when every rank passed.
"""
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.store import restore_tree  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed import mesh as pg  # noqa: E402
from repro_torch.distributed.compression import ErrorFeedback  # noqa: E402
from repro_torch.distributed.context import (Mesh,  # noqa: E402
                                             batch_axes, mesh_context)
from repro_torch.distributed.elastic import reshard_tree  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import (held_specs,  # noqa: E402
                                      init_opt_state, make_train_step)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

WORLD = 4
OC = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def case_cfg(c):
    cfg = get_reduced(c["arch"])
    mo = dataclasses.replace(cfg.moe, **c.get("moe", {}))
    return dataclasses.replace(cfg, moe=mo, **c.get("cfg", {}))


def nest(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def moe_layer(cfg, ref, name):
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32)
    flat = {k[len(f"{name}/p/"):].replace("/", "."): torch.from_numpy(ref[k])
            for k in ref.files if k.startswith(f"{name}/p/")}
    layer.load_state_dict(flat)
    return layer


def moe_cases(rank, d, ref, out):
    cases = json.loads((d / "cases.json").read_text())
    for c in cases:
        name = c["name"]
        cfg = case_cfg(c)
        shape, names = tuple(c["shape"]), tuple(c["names"])
        n = int(np.prod(shape))
        mesh = make_mesh(shape, names, ranks=list(range(n)))
        x = torch.from_numpy(ref[f"{name}/x"])
        if rank == 0:
            y, aux, dropped = moe.moe_apply_sharded_ref(
                moe_layer(cfg, ref, name), x, cfg, shape)
            out[f"{name}/ref_y"] = y.numpy()
            out[f"{name}/ref_aux"] = aux.numpy()
            out[f"{name}/ref_dropped"] = np.asarray(dropped)
        if mesh is None:
            continue
        layer = moe.shard_experts(moe_layer(cfg, ref, name), cfg, mesh,
                                  decode=x.shape[1] == 1)
        with mesh_context(mesh), torch.no_grad():
            b, nb = mesh.index(batch_axes()), mesh.axis_size(batch_axes())
            B = x.shape[0]
            rows = x[b * B // nb:(b + 1) * B // nb]
            y, aux, keep = moe.apply_with_keep(layer, rows, cfg)
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/aux"] = aux.numpy()
        out[f"{name}/dropped"] = np.asarray(int((~keep).sum()))
        if c.get("routed_only"):
            del layer.shared
            with mesh_context(mesh), torch.no_grad():
                out[f"{name}/y_routed"] = moe.moe_apply(
                    layer, rows, cfg)[0].numpy()


def ep_train(rank, ref, out):
    cfg = case_cfg({"arch": "deepseek_moe_16b",
                    "moe": {"capacity_factor": 0.5}})
    mesh = make_mesh((1, 2), ("data", "model"), ranks=[0, 1])
    if mesh is None:
        return
    tree = nest({k: ref[k] for k in ref.files}, "ep/init/")
    model = lm.init_params(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    with mesh_context(mesh):
        moe.shard_experts(model, cfg, mesh)
        oc = AdamWConfig(**OC)
        opt = init_opt_state(model, oc, cfg, mesh)
        step = make_train_step(cfg, oc, device="cpu")
        model, opt, m = step(model, opt, {"tokens": ref["ep/tokens"]})
    out["ep/loss"] = m["loss"].numpy()
    out["ep/grad_norm"] = m["grad_norm"].numpy()
    for n, t in model.state_dict().items():
        out[f"ep/params/{n}"] = t.numpy()
    for k in ("mu", "nu"):
        for n, t in opt[k].items():
            out[f"ep/{k}/{n}"] = t.numpy()


def dp_batch():
    rng = np.random.default_rng(21)
    cfg = get_reduced("qwen2_5_3b")
    tokens = rng.integers(0, cfg.vocab_size, (4, 32))
    keep = np.concatenate([np.full((2, 32), 0.9), np.full((2, 32), 0.4)])
    return {"tokens": tokens,
            "loss_mask": (rng.random((4, 32)) < keep).astype(np.float32)}


def dp_run(mesh, out, tag, steps=3, compress=False, save=None):
    """`steps` steps on `mesh` (a trivial mesh: world size 1), with the
    int8 compressor when `compress`; the state after each step into
    `out`, and `save` called after the second."""
    cfg = get_reduced("qwen2_5_3b")
    batch = dp_batch()
    oc = AdamWConfig(**OC)
    with mesh_context(mesh):
        model = lm.init_params(cfg, 5, torch.float32, "cpu")
        opt = init_opt_state(model, oc, cfg, mesh)
        ef = ErrorFeedback("int8")
        res = {}

        def int8(g):
            if not res:
                res.update(ef.init(g))
            o, r = ef.apply(g, res)
            res.update(r)
            return o
        step = make_train_step(cfg, oc, compressor=int8 if compress
                               else None, device="cpu")
        for t in range(steps):
            model, opt, m = step(model, opt, batch)
            out[f"{tag}/loss{t}"] = m["loss"].numpy()
            out[f"{tag}/wire{t}"] = np.asarray([step.wire[k] for k in (
                "all_reduce", "all_gather", "all_reduce_ms",
                "all_gather_ms")], np.float64)
            for n, p in model.state_dict().items():
                out[f"{tag}/{t}/params/{n}"] = p.numpy().copy()
            for k in ("mu", "nu"):
                for n, p in opt[k].items():
                    out[f"{tag}/{t}/{k}/{n}"] = p.numpy().copy()
            if t == 1 and save is not None:
                save(model, opt, mesh, cfg)
    return model, opt


def dp_and_elastic(rank, d, out):
    mesh = make_mesh((2, 1), ("data", "model"), ranks=[0, 1])
    if mesh is None:
        return
    mgr = CheckpointManager(d / "ckpt")

    def save(model, opt, mesh, cfg):
        def once():
            mgr.save(2, {"params": model.state_dict(), "opt": opt},
                     aux={"step_counter": 2},
                     specs=held_specs(model, cfg, mesh), mesh=mesh)
        once()
        # an interrupted save of step 2 left its directory behind (every
        # block zeroed, every rank's marker); the step is saved again
        if rank == 0:
            step = d / "ckpt" / "step_00000002"
            tmp = step.with_suffix(".tmp")
            shutil.copytree(step, tmp)
            for f in tmp.glob("*.shard*.npy"):
                np.save(f, np.zeros_like(np.load(f)))
            for r in range(2):
                (tmp / f".done{r}").write_text("")
        torch.distributed.barrier()
        once()
    dp_run(mesh, out, "dp", save=save)
    dp_run(mesh, out, "dpc", steps=2, compress=True)
    if rank != 0:
        return
    dp_run(Mesh((1, 1), ("data", "model")), out, "w1")
    # the elastic restart: onto world size 1, from the two ranks' blocks
    cfg = get_reduced("qwen2_5_3b")
    names = list(lm.init_params(cfg, 5, torch.float32, "cpu").state_dict())
    like = {"params": dict.fromkeys(names),
            "opt": {"mu": dict.fromkeys(names), "nu": dict.fromkeys(names),
                    "step": None}}
    tree, aux = restore_tree(d / "ckpt" / "step_00000002", like)
    one = Mesh((1, 1), ("data", "model"))
    params = reshard_tree(tree["params"], cfg, one, "params", device="cpu")
    opt = reshard_tree(tree["opt"], cfg, one, "opt", device="cpu")
    for n, t in params.items():
        out[f"el/restored/params/{n}"] = t.numpy().copy()
    for k in ("mu", "nu"):      # copies: the next step updates in place
        for n, t in opt[k].items():
            out[f"el/restored/{k}/{n}"] = t.numpy().copy()
    out["el/step"] = opt["step"].numpy().copy()
    out["el/aux_step"] = np.asarray(aux["step_counter"])
    model = lm.init_params(cfg, 5, torch.float32, "cpu")
    model.load_state_dict(params)
    oc = AdamWConfig(**OC)
    with mesh_context(one):
        model, opt, m = make_train_step(cfg, oc, device="cpu")(
            model, opt, dp_batch())
    out["el/loss2"] = m["loss"].numpy()
    for n, p in model.state_dict().items():
        out[f"el/2/params/{n}"] = p.numpy()


def moe_body(rank, world, d):
    torch.set_num_threads(1)
    d = Path(d)
    ref = np.load(d / "jax_moe.npz")
    out = {}
    moe_cases(rank, d, ref, out)
    ep_train(rank, ref, out)
    np.savez(d / f"rank{rank}.npz", **out)
    torch.distributed.barrier()


def dp_body(rank, world, d):
    torch.set_num_threads(1)
    d = Path(d)
    out = {}
    dp_and_elastic(rank, d, out)
    np.savez(d / f"rank{rank}.npz", **out)
    torch.distributed.barrier()


def main(argv):
    mode, d, store = argv[1], argv[2], argv[3]
    body, world = {"moe": (moe_body, 4), "dp": (dp_body, 2)}[mode]
    pg.spawn(body, world, store, args=(d,), timeout_s=240.0,
             collective_timeout_s=120.0)
    print("DIST-RANKS-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
