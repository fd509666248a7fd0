"""The multi-rank half of tests/test_torch_{moe_parallel,elastic}.py:
gloo ranks on the CPU, started from a `FileStore`, that never import
jax.

    python tests/_torch_dist_ranks.py moe DIR STORE    # four ranks
    python tests/_torch_dist_ranks.py dp DIR STORE     # two ranks
    python tests/_torch_dist_ranks.py tp DIR STORE     # four ranks
    python tests/_torch_dist_ranks.py tally DIR STORE [mb]  # four ranks
    python tests/_torch_dist_ranks.py mb DIR STORE     # four ranks

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
`tp` (the model axis): for each case of `TP_CASES` (arch, config
changes, (data, model) mesh, attention layout, B, S, decode length,
whether it trains) the case's ranks build the model's held blocks from the seed
(`lm.init_params(..., mesh=)`), then write to `rank{r}.npz`: the
prefill's logits and caches (`make_prefill_step`), the logits of
`tp_ticks`' decode ticks over the prefill's caches extended to the
decode length (`lm.extend_cache`, `make_decode_step`) and the caches
after them, and for a case that trains the reduced gradients
(`reduced_grads`), then one `make_train_step`'s loss, parameters and
moments; rank 0 also runs the 2-D cache cases and `W1_DECODE`'s at
world size 1 (`world_one`'s names). Ranks 0 and 1 take one case's gradients on a thread
that opened no mesh context (`tp_threaded_backward`). Then `TP_SERVE`'s
servers: each mesh's ranks serve
two requests (`tp_serve`), and rank 0 serves them at world size 1. `tests/_jax_dist_ref.py tp` runs the same cases in
JAX.
`tally` (the dry-run's collectives, tests/test_torch_dryrun.py): on a
(1, 4) mesh each rank runs `TALLY_CASES`' prefill, decode and training
steps (`launch.dryrun.lm_step` on the CPU) under `distributed.mesh.tally`
and writes each step's {collective: [calls, bytes]} to `rank{r}.json`;
with `mb`, the training step with `TALLY_MB` microbatches instead
(`tally_mb_shape`).
`mb` (gradient accumulation on more than one rank, ROADMAP item 10.6,
tests/test_torch_microbatch.py): for each case of `MB_CASES` the case's
ranks hold the model's blocks from seed 5 and run `MB_STEPS` steps of
`make_train_step(microbatches=MB)` on `mb_batch`, writing the loss,
learning rate, parameters and moments after each step to `rank{r}.npz`
(and, for a compressed case, the reduced gradients handed to the
compressor); then the ranks of a (2, 1) mesh call the step on
`MB_ODD` rows, which must raise `ValueError`. Rank 0 writes
DIR/ranks.done once every rank has written its file.
`tests/_jax_dist_ref.py mb` runs the same steps in JAX.
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
from repro_torch.launch.sharding import shard_params  # noqa: E402
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
    model = lm.init_params(cfg, dtype=torch.float32, device="cpu",
                           mesh=mesh)
    model.load_state_dict(shard_params(params_from_jax(tree, cfg), cfg,
                                       mesh))
    with mesh_context(mesh):
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


# the model axis's cases: name, arch, config changes (a dict for a
# nested config: its fields), (data, model), layout, B, S, decode length
# (every case decodes `TP_TICKS` ticks), whether it trains
TP_TICKS = 4
TP_CASES = [
    ("qwen25_heads_1x4", "qwen2_5_3b", {}, (1, 4), "heads", 2, 16, 24, True),
    ("qwen2_heads_1x2", "qwen2_7b", {}, (1, 2), "heads", 2, 16, 24, True),
    ("qwen2_seq_1x4", "qwen2_7b", {}, (1, 4), "seq", 2, 16, 24, True),
    ("gemma_heads_2x2", "gemma_7b", {}, (2, 2), "heads", 2, 16, 24, True),
    ("llava_seq_2x2", "llava_next_mistral_7b", {}, (2, 2), "seq", 2, 16,
     32, True),
    ("musicgen_seq_1x2", "musicgen_medium", {}, (1, 2), "seq", 2, 16, 24,
     True),
    ("moe_heads_1x2", "deepseek_moe_16b", {}, (1, 2), "heads", 2, 16, 24,
     True),
    ("moe_heads_1x4", "deepseek_moe_16b", {}, (1, 4), "heads", 2, 16, 24,
     False),
    ("qwen25_seq_2x2", "qwen2_5_3b", {}, (2, 2), "seq", 2, 16, 24, True),
    ("llama_fsdp_2x2", "llama3_405b", {"fsdp": True}, (2, 2), "heads", 2,
     16, 24, True),
    # MLA, the SSM and the RG-LRU (item 10.3c): MLA's heads at tp = 4,
    # and with FSDP on (2, 2); the SSM's heads at tp = 4 and beside a
    # data axis; the RG-LRU in "heads" with 4 gate blocks of 16 (2 a
    # rank) and in "seq" with 6 heads (not dividing over 4, as
    # RecurrentGemma-2B's 10) at S = 48, the window of 32 reaching over
    # the ranks' blocks of 12 rows, its one gate block of 64 cut by the
    # ranks' 16 channels
    ("mla_heads_1x4", "deepseek_v2_236b", {}, (1, 4), "heads", 2, 16, 24,
     True),
    ("mla_fsdp_2x2", "deepseek_v2_236b", {"fsdp": True}, (2, 2), "heads", 2,
     16, 24, True),
    ("mamba_1x4", "mamba2_780m", {}, (1, 4), "heads", 2, 16, 24, True),
    ("mamba_2x2", "mamba2_780m", {}, (2, 2), "heads", 2, 16, 24, True),
    ("rg_heads_1x2", "recurrentgemma_2b", {"rglru": {"gate_block": 16}},
     (1, 2), "heads", 2, 16, 24, True),
    ("rg_seq_1x4", "recurrentgemma_2b", {"n_heads": 6}, (1, 4), "seq", 2,
     48, 56, True),
    # the 2-D cache: a prefill at S = 4,096 decoded in a T = 8,192 cache
    # held over 'model'
    ("cache2d_1x2", "qwen2_7b", {}, (1, 2), "heads", 1, 4096, 8192, False),
    ("mla_cache2d_1x2", "deepseek_v2_236b", {}, (1, 2), "heads", 1, 4096,
     8192, False),
]
TP_KEYS = ("name", "arch", "cfg", "shape", "layout", "B", "S", "max_len",
           "train")
# the cases whose decode is held to the port at world size 1, not to JAX:
# JAX's FSDP MoE decode (`_decode_moe_2d`) adds the data shards'
# different rows in its shared experts (ROADMAP §3)
W1_DECODE = ("mla_fsdp_2x2",)


def tp_cases():
    return [dict(zip(TP_KEYS, c)) for c in TP_CASES]


def world_one(c):
    """The name of a case's world size 1 run on rank 0: the 2-D caches'
    and `W1_DECODE`'s."""
    return c["name"].rsplit("_", 1)[0] + "_w1"


def tp_cfg(get_reduced_fn, c):
    """A case's config from a package's `get_reduced` (a dict of changes
    applied to the nested config of its name)."""
    base = get_reduced_fn(c["arch"])
    over = {k: dataclasses.replace(getattr(base, k), **v)
            if isinstance(v, dict) else v for k, v in c["cfg"].items()}
    return dataclasses.replace(base, **over)


def tp_batch(cfg, c):
    """A case's global batch (numpy): tokens, and 8 seeded patch
    embeddings a row for a vision_patches config."""
    rng = np.random.default_rng(c["S"] + 31 * c["B"])
    out = {"tokens": rng.integers(0, cfg.vocab_size, (c["B"], c["S"]))}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = rng.normal(
            0, 1, (c["B"], cfg.n_patch_tokens, cfg.d_model)).astype(
                np.float32)
    return out


def tp_ticks(cfg, c):
    """The decode ticks' tokens (TP_TICKS, B)."""
    rng = np.random.default_rng(7 + c["B"])
    return rng.integers(0, cfg.vocab_size, (TP_TICKS, c["B"]))


def tp_length(cfg, c) -> int:
    """The prefill's positions: S plus the patches."""
    return c["S"] + (cfg.n_patch_tokens if cfg.frontend == "vision_patches"
                     else 0)


def flat_tree(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat_tree(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = v.detach().numpy().copy()


def tp_case(c, mesh, out):
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, reduced_grads)
    name, layout = c["name"], c["layout"]
    cfg = tp_cfg(get_reduced, c)
    batch = {k: torch.from_numpy(v) for k, v in tp_batch(cfg, c).items()}
    model = lm.init_params(cfg, 5, torch.float32, "cpu", mesh=mesh,
                           layout=layout)
    logits, caches = make_prefill_step(cfg, layout)(model, batch)
    out[f"{name}/logits"] = logits.numpy()
    flat_tree(caches, f"{name}/cache/", out)
    S_tot = tp_length(cfg, c)
    cache = lm.extend_cache(caches, cfg, S_tot, c["max_len"])
    step = make_decode_step(cfg, layout, max_len=c["max_len"])
    for t, tok in enumerate(tp_ticks(cfg, c)):
        lg, cache = step(model, torch.from_numpy(tok[:, None]), cache,
                         S_tot + t)
        out[f"{name}/tick{t}"] = lg.numpy()
    flat_tree(cache, f"{name}/decoded/", out)
    if not c["train"]:
        return
    oc = AdamWConfig(**OC)
    opt = init_opt_state(model, oc, cfg, mesh, layout)
    _, grads, _ = reduced_grads(model, cfg, batch, mesh, layout=layout)
    for n, g in grads.items():
        out[f"{name}/grad/{n}"] = g.numpy()
    model, opt, m = make_train_step(cfg, oc, layout=layout,
                                    device="cpu")(model, opt, batch)
    out[f"{name}/loss"] = m["loss"].numpy()
    for n, p in model.state_dict().items():
        out[f"{name}/params/{n}"] = p.numpy()
    for k in ("mu", "nu"):
        for n, t in opt[k].items():
            out[f"{name}/{k}/{n}"] = t.numpy()


# the Server on a mesh with a model axis: arch, (data, model), layout
TP_SERVE = [("qwen2_5_3b", (1, 4), "heads"), ("qwen2_7b", (1, 2), "seq"),
            ("deepseek_v2_236b", (1, 4), "heads"),
            ("mamba2_780m", (1, 4), "heads"),
            ("recurrentgemma_2b", (1, 4), "heads")]


def tp_serve(arch, layout, out, key):
    """Two requests through a 2-slot `Server` (seed 5, fp32), 4 ticks:
    the slots' greedy tokens into `out`."""
    from repro_torch.launch.serve import Server
    cfg = get_reduced(arch)
    srv = Server(cfg, max_len=24, slots=2, seed=5, device="cpu",
                 layout=layout)
    rng = np.random.default_rng(11)
    for _ in range(2):
        srv.admit(rng.integers(1, cfg.vocab_size, 6).tolist())
    for _ in range(4):
        srv.tick()
    out[key] = np.asarray(srv.outputs)


def tp_threaded_backward(mesh, out):
    """The "qwen2_heads_1x2" case's loss (remat on) under the mesh's
    context, its gradients taken, while the context is open, on a thread
    that opened none (as autograd's CUDA backward thread, which runs the
    checkpoints' recompute): "threaded/grad/<name>"."""
    import threading
    c = next(c for c in tp_cases() if c["name"] == "qwen2_heads_1x2")
    cfg = tp_cfg(get_reduced, c)
    assert cfg.remat
    batch = {k: torch.from_numpy(v) for k, v in tp_batch(cfg, c).items()}
    model = lm.init_params(cfg, 5, torch.float32, "cpu", mesh=mesh)
    names, leaves = zip(*model.named_parameters())
    got = {}
    with mesh_context(mesh):
        loss, _ = lm.loss_fn(model, cfg, batch)
        t = threading.Thread(target=lambda: got.update(zip(
            names, torch.autograd.grad(loss, leaves))))
        t.start()
        t.join()
    for n, g in got.items():
        out[f"threaded/grad/{n}"] = g.numpy()


def tp_body(rank, world, d):
    torch.set_num_threads(1)
    d = Path(d)
    out = {}
    for c in tp_cases():
        n = int(np.prod(c["shape"]))
        mesh = make_mesh(c["shape"], ("data", "model"), ranks=list(range(n)))
        if mesh is None:
            continue
        with mesh_context(mesh):
            tp_case(c, mesh, out)
    for arch, shape, layout in TP_SERVE:
        n = int(np.prod(shape))
        mesh = make_mesh(shape, ("data", "model"), ranks=list(range(n)))
        if mesh is not None:
            with mesh_context(mesh):
                tp_serve(arch, layout, out, f"serve/{arch}/{layout}")
        if rank == 0:
            with mesh_context(Mesh((1, 1), ("data", "model"))):
                tp_serve(arch, layout, out, f"serve/{arch}/w1")
    mesh = make_mesh((1, 2), ("data", "model"), ranks=[0, 1])
    if mesh is not None:
        tp_threaded_backward(mesh, out)
    if rank == 0:       # the 2-D caches and W1_DECODE at world size 1
        one = Mesh((1, 1), ("data", "model"))
        for c in tp_cases():
            if "cache2d" in c["name"] or c["name"] in W1_DECODE:
                with mesh_context(one):
                    tp_case(dict(c, name=world_one(c), train=False), one,
                            out)
    np.savez(d / f"rank{rank}.npz", **out)
    torch.distributed.barrier()


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


# the dry-run's collective cases: (arch, config changes) of reduced
# configs with a head dim the flash kernels take, and the steps' shapes
TALLY_CASES = (("qwen2_5_3b", {"head_dim": 64}),
               ("deepseek_moe_16b", {"head_dim": 64}))
TALLY_SHAPES = (("train", 64, 2), ("prefill", 64, 2), ("decode", 64, 2))


def tally_cfg(arch, changes):
    return dataclasses.replace(get_reduced(arch), **changes)


def tally_shapes():
    from repro_torch.configs import ShapeSpec
    return [ShapeSpec(f"{k}_{s}", k, s, b) for k, s, b in TALLY_SHAPES]


TALLY_MB = 2            # the microbatched training step's count


def tally_mb_shape():
    """The microbatched training step's shape: `TALLY_SHAPES`' training
    step at twice the rows, so that each microbatch has its rows."""
    from repro_torch.configs import ShapeSpec
    (k, s, b), = [t for t in TALLY_SHAPES if t[0] == "train"]
    return ShapeSpec(f"{k}_{s}_mb{TALLY_MB}", k, s, b * TALLY_MB)


def tally_body(rank, world, d, which="base"):
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import attn_layout
    torch.set_num_threads(1)
    mesh = make_mesh((1, world), ("data", "model"))
    runs = [(s, 1) for s in tally_shapes()] if which == "base" else \
        [(tally_mb_shape(), TALLY_MB)]
    out = {}
    for arch, changes in TALLY_CASES:
        cfg = tally_cfg(arch, changes)
        oc = AdamWConfig(moment_dtype=cfg.opt_dtype)
        for shape, m in runs:
            with mesh_context(mesh):
                step, args, _ = dryrun.lm_step(
                    cfg, shape, oc, attn_layout(cfg, world), mesh, m,
                    device="cpu")
                with pg.tally() as wire:
                    step(*args)
            out[f"{arch}/{shape.name}"] = {k: v[:2]
                                           for k, v in wire.items()}
    (Path(d) / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()


# gradient accumulation on more than one rank: name, arch, config
# changes, (data, model), B, compressor; every case "heads", S = 32
MB = 2
MB_STEPS = 2
MB_ODD = 3              # rows that do not cut into MB microbatches
MB_CASES = [
    ("qwen_zero1_2x1", "qwen2_5_3b", {}, (2, 1), 4, None),
    ("qwen_int8_2x1", "qwen2_5_3b", {}, (2, 1), 4, "int8"),
    ("qwen_heads_2x2", "qwen2_5_3b", {}, (2, 2), 4, None),
    ("moe_ep_1x2", "deepseek_moe_16b", {}, (1, 2), 4, None),
    # a microbatch's one row does not divide over 'data': each rank runs
    # it whole, counted once
    ("qwen_rows_2x1", "qwen2_5_3b", {}, (2, 1), 2, None),
]
MB_KEYS = ("name", "arch", "cfg", "shape", "B", "compress")


def mb_cases():
    return [dict(zip(MB_KEYS, c)) for c in MB_CASES]


def mb_batch(cfg, B):
    """B rows of 32 tokens, the loss masks' keep rate 0.9 and 0.4 on
    alternate rows, so the ranks' token counts differ in every
    microbatch."""
    rng = np.random.default_rng(40 + B)
    keep = np.where(np.arange(B)[:, None] % 2 == 0, 0.9, 0.4)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, 32)),
            "loss_mask": (rng.random((B, 32)) < keep).astype(np.float32)}


def mb_state(ranks, c, t, kind, cfg):
    """{name: the global leaf} of one case's parameters, moments or
    handed gradients after step t, assembled from the ranks' blocks
    (`held_spec`; the moments by `held_moment_spec`)."""
    from repro_torch.launch.sharding import ShardingRules, assemble
    mesh = Mesh(tuple(c["shape"]), ("data", "model"))
    rules = ShardingRules(cfg, mesh, "heads")
    shapes = lm.param_shapes(cfg)
    pre = f"{c['name']}/{t}/{kind}/"
    out = {}
    for n in (k[len(pre):] for k in ranks[0].files if k.startswith(pre)):
        shape = shapes[n]
        spec = rules.held_moment_spec(n, shape) if kind in ("mu", "nu") \
            else rules.held_spec(n, shape)
        out[n] = assemble([r[pre + n] for r in ranks[:mesh.size]], spec,
                          shape, mesh)
    return out


def mb_case(c, mesh, out):
    cfg = tp_cfg(get_reduced, c)
    name = c["name"]
    oc = AdamWConfig(**OC)
    model = lm.init_params(cfg, 5, torch.float32, "cpu", mesh=mesh)
    opt = init_opt_state(model, oc, cfg, mesh)
    handed = []
    compressor = None
    if c["compress"]:
        ef, res = ErrorFeedback(c["compress"]), {}

        def compressor(g):
            handed.append({n: t.clone() for n, t in g.items()})
            if not res:
                res.update(ef.init(g))
            o, r = ef.apply(g, res)
            res.update(r)
            return o
    step = make_train_step(cfg, oc, microbatches=MB, compressor=compressor,
                           device="cpu")
    batch = mb_batch(cfg, c["B"])
    for t in range(MB_STEPS):
        model, opt, m = step(model, opt, batch)
        for k in ("loss", "lr", "grad_norm"):
            out[f"{name}/{t}/{k}"] = m[k].numpy()
        out[f"{name}/{t}/wire"] = np.asarray(step.wire["all_reduce"])
        for n, p in model.state_dict().items():
            out[f"{name}/{t}/params/{n}"] = p.numpy().copy()
        for k in ("mu", "nu"):
            for n, p in opt[k].items():
                out[f"{name}/{t}/{k}/{n}"] = p.numpy().copy()
        for n, g in (handed[-1] if handed else {}).items():
            out[f"{name}/{t}/handed/{n}"] = g.numpy()


def mb_body(rank, world, d):
    torch.set_num_threads(1)
    d = Path(d)
    out = {}
    for c in mb_cases():
        n = int(np.prod(c["shape"]))
        mesh = make_mesh(c["shape"], ("data", "model"), ranks=list(range(n)))
        if mesh is not None:
            with mesh_context(mesh):
                mb_case(c, mesh, out)
    mesh = make_mesh((2, 1), ("data", "model"), ranks=[0, 1])
    if mesh is not None:
        cfg = get_reduced("qwen2_5_3b")
        oc = AdamWConfig(**OC)
        with mesh_context(mesh):
            model = lm.init_params(cfg, 5, torch.float32, "cpu", mesh=mesh)
            step = make_train_step(cfg, oc, microbatches=MB, device="cpu")
            try:
                step(model, init_opt_state(model, oc, cfg, mesh),
                     mb_batch(cfg, MB_ODD))
                out["odd/raised"] = np.asarray("")
            except ValueError as e:
                out["odd/raised"] = np.asarray(str(e))
    np.savez(d / f"rank{rank}.npz", **out)
    torch.distributed.barrier()
    if rank == 0:                   # tests/_jax_dist_ref.py mb waits
        (d / "ranks.done").write_text("")


def main(argv):
    mode, d, store = argv[1], argv[2], argv[3]
    body, world = {"moe": (moe_body, 4), "dp": (dp_body, 2),
                   "tp": (tp_body, 4), "tally": (tally_body, 4),
                   "mb": (mb_body, 4)}[mode]
    pg.spawn(body, world, store, args=(d, *argv[4:]), timeout_s=240.0,
             collective_timeout_s=120.0)
    print("DIST-RANKS-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
