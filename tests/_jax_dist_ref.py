"""The JAX package's side of tests/test_torch_{moe_parallel,
checkpoint_crossload}.py, run in a subprocess with 8 virtual CPU
devices (`--xla_force_host_platform_device_count`, which must be set
before jax is imported).

    python tests/_jax_dist_ref.py moe DIR
    python tests/_jax_dist_ref.py ckpt DIR
    python tests/_jax_dist_ref.py dp DIR
    python tests/_jax_dist_ref.py tp DIR [I/N]
    python tests/_jax_dist_ref.py mb DIR

`moe`: for each case of DIR/cases.json, one MoE layer (`moe_init`,
fp32) and a seeded input through `moe_apply` under `shard_map` on the
case's mesh (for a case marked `routed_only`, also the layer less its
shared experts), and each shard's dropped events as its own routing and
packing give them (the rank's rows, and at tp > 1 in prefill its S/tp
positions); then one jitted `make_train_step` of reduced
deepseek_moe_16b on a (1, 2) mesh. Writes DIR/jax_moe.npz.
`dp`: reduced qwen2_5_3b, one jitted `make_train_step` on a (data 2,
model 1) mesh of 2 virtual devices for each of the three steps of
`tests/_torch_dist_ranks.py dp` (whose DIR/rank{r}.npz it reads), each
from the state the ranks started that step from: the port's initial
parameters (its `lm.init_params`, seed 5) first, then the ranks' state
after their previous step (rank 0's parameters, the moments assembled
from both ranks' ZeRO-1 blocks); the batch `dp_batch` sharded by
`batch_specs`, the parameters and the AdamW state by `params_specs` and
`opt_specs`: the loss, parameters, mu and nu after each step. Writes
DIR/jax_dp.npz.
`tp`: each case of `tests/_torch_dist_ranks.py`'s `TP_CASES` on its
(data, model) mesh of virtual devices, from the port's seeded parameters
(its `lm.init_params`, seed 5, through `weights.params_to_jax`), placed
by `params_specs` (the batch by `batch_specs`, the caches by
`cache_specs`, the AdamW state by `opt_specs`): the jitted
`make_prefill_step(cfg, layout)`'s logits and caches, `TP_TICKS` ticks
of the jitted `make_decode_step` over the prefill's caches written into
`init_cache(cfg, B, max_len)` (fp32, `place`), and for a case that trains the
gradients of `loss_fn(..., layout)` and one jitted `make_train_step(cfg,
oc, layout)`: loss, parameters, mu and nu. With I/N (default 0/1) only
every N-th case from the I-th, so that N processes share the cases.
Writes DIR/jax_tp{I}.npz.
`mb`: each case of `tests/_torch_dist_ranks.py`'s `MB_CASES` (whose
DIR/rank{r}.npz it reads) on its (data, model) mesh of virtual devices:
`MB_STEPS` jitted steps of `make_train_step(cfg, oc, microbatches=MB)`,
each from the state the ranks started that step from: the port's
initial parameters (its `lm.init_params`, seed 5) first, then the ranks'
state after their previous step, assembled from their blocks
(`mb_state`). A compressed case's compressor, as
tests/test_torch_compression.py's, returns JAX's own gradients and
compresses the port's handed ones in their place; its error-feedback
residual is an argument and an output of the jitted step, so one trace
serves every step. The first steps of the other cases run while the
ranks do; then DIR/ranks.done is awaited. The batch
`mb_batch` placed by `batch_specs`, the parameters and the AdamW state
by `params_specs` and `opt_specs`: the loss, learning rate, parameters,
mu and nu after each step. Then `MB_ODD` rows, which the step must
refuse (the exception's type). Writes DIR/jax_mb.npz.
`ckpt`: for every family, reduced parameters (the shapes and dtypes of
`lm.init_params`, the values drawn from numpy) and a random AdamW state
saved with `save_tree` unsharded (DIR/<arch>/plain) and sharded over a
(2, 4) mesh by `ShardingRules` (DIR/<arch>/sharded), with aux.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import dataclasses  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_tree  # noqa: E402
from repro.compat import make_mesh  # noqa: E402
from repro.configs import get_reduced  # noqa: E402
from repro.distributed.context import mesh_context  # noqa: E402
from repro.launch.sharding import ShardingRules, to_named  # noqa: E402
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.optim import AdamWConfig, adamw_init  # noqa: E402

FAMILIES = ["qwen2_5_3b", "deepseek_moe_16b", "mamba2_780m",
            "recurrentgemma_2b", "deepseek_v2_236b",
            "llava_next_mistral_7b", "musicgen_medium"]
OC = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def case_cfg(c):
    cfg = get_reduced(c["arch"])
    mo = dataclasses.replace(cfg.moe, **c.get("moe", {}))
    return dataclasses.replace(cfg, moe=mo, **c.get("cfg", {}))


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def mesh_of(shape, names):
    n = int(np.prod(shape))
    return make_mesh(tuple(shape), tuple(names), devices=jax.devices()[:n])


def dropped_per_shard(p, x, cfg, shape, names):
    """Each shard's dropped events, as shard_map's blocks route them."""
    B, S, d = x.shape
    tp = shape[names.index("model")]
    baxes = [a for a in ("pod", "data") if a in names]
    nb = int(np.prod([shape[names.index(a)] for a in baxes]))
    seq = S > 1 and tp > 1
    out = []
    for r in range(int(np.prod(shape))):
        c = dict(zip(names, np.unravel_index(r, shape)))
        b = 0
        for a in baxes:
            b = b * shape[names.index(a)] + int(c[a])
        xl = x[b * B // nb:(b + 1) * B // nb]
        if seq:
            s = S // tp
            xl = xl[:, int(c["model"]) * s:(int(c["model"]) + 1) * s]
        xt = jnp.asarray(xl.reshape(-1, d))
        w, ids, _ = moe._route(xt, p["router"], cfg)
        C = moe._capacity(xt.shape[0], cfg)
        keep = moe._pack(xt, ids, w, C, cfg.moe.n_routed)[2]
        out.append(int((~np.asarray(keep)).sum()))
    return np.asarray(out)


def run_moe(d):
    cases = json.loads((d / "cases.json").read_text())
    out = {}
    for c in cases:
        cfg = case_cfg(c)
        name, B, S = c["name"], c["B"], c["S"]
        p = moe.moe_init(jax.random.PRNGKey(c["seed"]), cfg, jnp.float32)
        x = np.random.default_rng(c["seed"]).normal(
            0, 1, (B, S, cfg.d_model)).astype(np.float32)
        with mesh_context(mesh_of(c["shape"], c["names"])):
            y, aux = jax.jit(lambda p, x: moe.moe_apply(
                p, x, cfg, decode=S == 1))(p, jnp.asarray(x))
        out.update(flat(p, f"{name}/p/"))
        out[f"{name}/x"] = x
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/aux"] = np.asarray(aux)
        out[f"{name}/dropped"] = dropped_per_shard(
            p, x, cfg, tuple(c["shape"]), tuple(c["names"]))
        if c.get("routed_only"):
            # the layer less its shared experts: JAX's `_decode_moe_2d`
            # mixes the data shards' rows in the shared experts (ROADMAP
            # §3), so the port is held to it on the routed experts only
            pr = {k: v for k, v in p.items() if k != "shared"}
            with mesh_context(mesh_of(c["shape"], c["names"])):
                yr, _ = jax.jit(lambda p, x: moe.moe_apply(
                    p, x, cfg, decode=S == 1))(pr, jnp.asarray(x))
            out[f"{name}/y_routed"] = np.asarray(yr)
    # one training step of the reduced MoE LM on a (1, 2) mesh
    cfg = case_cfg({"arch": "deepseek_moe_16b",
                    "moe": {"capacity_factor": 0.5}})
    oc = AdamWConfig(**OC)
    params = lm.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))
    out.update(flat(params, "ep/init/"))
    out["ep/tokens"] = tokens
    with mesh_context(mesh_of((1, 2), ("data", "model"))):
        opt = adamw_init(params, oc)
        params, opt, m = jax.jit(make_train_step(cfg, oc))(
            params, opt, {"tokens": jnp.asarray(tokens)})
    out.update(flat(params, "ep/params/"))
    out.update(flat(opt["mu"], "ep/mu/"))
    out.update(flat(opt["nu"], "ep/nu/"))
    out["ep/loss"] = np.asarray(m["loss"])
    out["ep/grad_norm"] = np.asarray(m["grad_norm"])
    np.savez(d / "jax_moe.npz", **out)


def run_dp(d):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    from _torch_dist_ranks import dp_batch
    from repro_torch.configs import get_reduced as tget_reduced
    from repro_torch.distributed.context import Mesh as TMesh
    from repro_torch.launch.sharding import ShardingRules as TRules
    from repro_torch.launch.sharding import assemble
    from repro_torch.models import lm as tlm
    from repro_torch.models.weights import params_to_jax
    tcfg = tget_reduced("qwen2_5_3b")
    cfg = get_reduced("qwen2_5_3b")
    oc = AdamWConfig(**OC)
    ranks = [np.load(d / f"rank{r}.npz") for r in range(2)]
    tmesh = TMesh((2, 1), ("data", "model"))
    trules = TRules(tcfg, tmesh, "heads")
    as_jax = lambda state: jax.tree.map(  # noqa: E731
        lambda t: jnp.asarray(t.numpy()), params_to_jax(state, tcfg))

    def port_state(t):
        """The ranks' state after their step t: parameters (rank 0's) and
        the moments assembled from both ranks' ZeRO-1 blocks."""
        pre = f"dp/{t}/params/"
        names = [k[len(pre):] for k in ranks[0].files if k.startswith(pre)]
        state = {n: torch.from_numpy(ranks[0][pre + n]) for n in names}
        mom = {k: {n: torch.from_numpy(assemble(
            [r[f"dp/{t}/{k}/{n}"] for r in ranks],
            trules.held_moment_spec(n, state[n].shape), state[n].shape,
            tmesh)) for n in names} for k in ("mu", "nu")}
        return as_jax(state), {"mu": as_jax(mom["mu"]),
                               "nu": as_jax(mom["nu"]),
                               "step": jnp.asarray(t + 1, jnp.int32)}
    out = {}
    batch0 = {k: jnp.asarray(v) for k, v in dp_batch().items()}
    mesh = mesh_of((2, 1), ("data", "model"))
    with mesh_context(mesh):
        params = as_jax(tlm.init_params(tcfg, 5, torch.float32,
                                        "cpu").state_dict())
        opt = adamw_init(params, oc)
        rules = ShardingRules(cfg, mesh, "heads")
        shapes = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
        ps = rules.params_specs(shapes)
        put = lambda t, s: jax.tree.map(  # noqa: E731
            lambda a, sh: jax.device_put(a, sh), t, to_named(s, mesh))
        batch = put(batch0, rules.batch_specs(batch0))
        step = jax.jit(make_train_step(cfg, oc))
        for t in range(3):
            if t:
                params, opt = port_state(t - 1)
            params, opt, m = step(put(params, ps),
                                  put(opt, rules.opt_specs(shapes, ps)),
                                  batch)
            out[f"loss{t}"] = np.asarray(m["loss"])
            out.update(flat(params, f"{t}/params/"))
            out.update(flat(opt["mu"], f"{t}/mu/"))
            out.update(flat(opt["nu"], f"{t}/nu/"))
    np.savez(d / "jax_dp.npz", **out)


def place(cfg, full, caches, S_tot):
    """A prefill's caches of S_tot positions written into decode caches
    `full`: K/V and MLA's rows first; a windowed layer's last rows each
    in its ring slot (position % the ring's slots); the recurrent states
    ({conv, ssd}, {conv, h}) whole."""
    def one(path, z, p):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("conv", "ssd", "h"):
            return p.astype(z.dtype)
        if cfg.family == "hybrid" and "attn" in keys:
            n = p.shape[2]
            return z.at[:, :, (S_tot - n + np.arange(n)) % z.shape[2]].set(p)
        return z.at[:, :, :S_tot].set(p)
    return jax.tree_util.tree_map_with_path(one, full, caches)


def run_tp(d, part="0/1"):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    from _torch_dist_ranks import (TP_TICKS, tp_batch, tp_cases, tp_cfg,
                                   tp_length, tp_ticks)
    from repro.launch.steps import make_decode_step, make_prefill_step
    from repro.optim import AdamWConfig as JOC
    from repro_torch.configs import get_reduced as tget_reduced
    from repro_torch.models import lm as tlm
    from repro_torch.models.weights import params_to_jax
    i, n = (int(x) for x in part.split("/"))
    out = {}
    for c in tp_cases()[i::n]:
        t0 = time.perf_counter()
        name, layout = c["name"], c["layout"]
        cfg, tcfg = tp_cfg(get_reduced, c), tp_cfg(tget_reduced, c)
        mesh = mesh_of(c["shape"], ("data", "model"))
        batch0 = tp_batch(tcfg, c)
        with mesh_context(mesh):
            rules = ShardingRules(cfg, mesh, layout)
            params = jax.tree.map(
                lambda t: jnp.asarray(t.numpy()),
                params_to_jax(tlm.init_params(tcfg, 5, torch.float32,
                                              "cpu").state_dict(), tcfg))
            shapes = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
            ps = rules.params_specs(shapes)
            put = lambda t, s: jax.tree.map(  # noqa: E731
                lambda a, sh: jax.device_put(a, sh), t, to_named(s, mesh))
            params = put(params, ps)
            batch = put({k: jnp.asarray(v) for k, v in batch0.items()},
                        rules.batch_specs(batch0))
            logits, caches = jax.jit(make_prefill_step(cfg, layout))(
                params, batch)
            out[f"{name}/logits"] = np.asarray(logits)
            out.update(flat(caches, f"{name}/cache/"))
            S_tot, T = tp_length(cfg, c), c["max_len"]
            full = place(cfg, lm.init_cache(cfg, c["B"], T,
                                            dtype=jnp.float32), caches,
                         S_tot)
            cache = put(full, rules.cache_specs(full))
            dstep = jax.jit(make_decode_step(cfg, layout))
            for t, tok in enumerate(tp_ticks(cfg, c)):
                lg, cache = dstep(params, jnp.asarray(tok[:, None]), cache,
                                  jnp.int32(S_tot + t))
                out[f"{name}/tick{t}"] = np.asarray(lg)
            out.update(flat(cache, f"{name}/decoded/"))
            if c["train"]:
                oc = JOC(**OC)
                grads = jax.jit(jax.grad(lambda p, b: lm.loss_fn(
                    p, cfg, b, layout=layout)[0]))(params, batch)
                out.update(flat(grads, f"{name}/grad/"))
                opt = put(adamw_init(params, oc),
                          rules.opt_specs(shapes, ps))
                params, opt, m = jax.jit(make_train_step(
                    cfg, oc, layout=layout))(params, opt, batch)
                out[f"{name}/loss"] = np.asarray(m["loss"])
                out.update(flat(params, f"{name}/params/"))
                out.update(flat(opt["mu"], f"{name}/mu/"))
                out.update(flat(opt["nu"], f"{name}/nu/"))
        print(f"{name}: {time.perf_counter() - t0:.1f} s ({TP_TICKS} "
              f"ticks)", flush=True)
    np.savez(d / f"jax_tp{i}.npz", **out)


def run_mb(d):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    from _torch_dist_ranks import (MB, MB_ODD, MB_STEPS, mb_batch, mb_cases,
                                   mb_state, tp_cfg)
    from repro.distributed import compression as jc
    from repro_torch.configs import get_reduced as tget_reduced
    from repro_torch.models import lm as tlm
    from repro_torch.models.weights import params_to_jax
    oc = AdamWConfig(**OC)
    out, ranks = {}, []

    def case(c):
        """The case's mesh, placement, jitted step and first state."""
        cfg, tcfg = tp_cfg(get_reduced, c), tp_cfg(tget_reduced, c)
        mesh = mesh_of(c["shape"], ("data", "model"))
        as_jax = lambda state: jax.tree.map(  # noqa: E731
            lambda t: jnp.asarray(np.asarray(t)),
            params_to_jax({n: torch.as_tensor(v) for n, v in state.items()},
                          tcfg))
        batch0 = mb_batch(tcfg, c["B"])
        with mesh_context(mesh):
            params = as_jax(tlm.init_params(tcfg, 5, torch.float32,
                                            "cpu").state_dict())
            rules = ShardingRules(cfg, mesh, "heads")
            shapes = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
            ps = rules.params_specs(shapes)
            put = lambda t, s: jax.tree.map(  # noqa: E731
                lambda a, sh: jax.device_put(a, sh), t, to_named(s, mesh))
            batch = put({k: jnp.asarray(v) for k, v in batch0.items()},
                        rules.batch_specs(batch0))
        ef = jc.ErrorFeedback(c["compress"]) if c["compress"] else None

        def compressed(params, opt, batch, handed, res):
            # the port's gradients in the place of JAX's own (returned),
            # the residual an argument: one trace serves every step
            box = {}

            def compressor(g):
                box["own"] = g
                o, box["res"] = ef.apply(handed, res)
                return o
            p, o, m = make_train_step(cfg, oc, microbatches=MB,
                                      compressor=compressor)(params, opt,
                                                             batch)
            return p, o, m, box["own"], box["res"]
        step = jax.jit(compressed if ef else make_train_step(
            cfg, oc, microbatches=MB))
        return dict(c=c, tcfg=tcfg, mesh=mesh, as_jax=as_jax, put=put,
                    batch=batch, ps=ps, shapes=shapes, rules=rules,
                    step=step, ef=ef, res=None, params=params,
                    opt=adamw_init(params, oc))

    def run(k, t):
        c, put, as_jax, name = k["c"], k["put"], k["as_jax"], k["c"]["name"]
        if t:
            k["params"] = as_jax(mb_state(ranks, c, t - 1, "params",
                                          k["tcfg"]))
            k["opt"] = {n: as_jax(mb_state(ranks, c, t - 1, n, k["tcfg"]))
                        for n in ("mu", "nu")}
            k["opt"]["step"] = jnp.asarray(t, jnp.int32)
        with mesh_context(k["mesh"]):
            args = (put(k["params"], k["ps"]),
                    put(k["opt"], k["rules"].opt_specs(k["shapes"],
                                                       k["ps"])),
                    k["batch"])
            if k["ef"] is not None:
                handed = as_jax(mb_state(ranks, c, t, "handed", k["tcfg"]))
                if k["res"] is None:
                    k["res"] = k["ef"].init(handed)
                params, opt, m, own, k["res"] = k["step"](*args, handed,
                                                          k["res"])
                out.update(flat(own, f"{name}/{t}/own/"))
            else:
                params, opt, m = k["step"](*args)
        for key in ("loss", "lr", "grad_norm"):
            out[f"{name}/{t}/{key}"] = np.asarray(m[key])
        out.update(flat(params, f"{name}/{t}/params/"))
        out.update(flat(opt["mu"], f"{name}/{t}/mu/"))
        out.update(flat(opt["nu"], f"{name}/{t}/nu/"))

    t0 = time.perf_counter()
    cases = [case(c) for c in mb_cases()]
    for k in cases:                 # needs nothing of the ranks
        if k["ef"] is None:
            run(k, 0)
    print(f"first steps: {time.perf_counter() - t0:.1f} s", flush=True)
    done = d / "ranks.done"
    while not done.exists():
        if time.perf_counter() - t0 > 400:
            raise TimeoutError("the ranks wrote no ranks.done")
        time.sleep(0.2)
    ranks.extend(np.load(d / f"rank{r}.npz") for r in range(4))
    for k in cases:
        if k["ef"] is not None:
            run(k, 0)
        for t in range(1, MB_STEPS):
            run(k, t)
    print(f"all steps: {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = get_reduced("qwen2_5_3b")
    with mesh_context(mesh_of((2, 1), ("data", "model"))):
        params = lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        try:
            jax.jit(make_train_step(cfg, oc, microbatches=MB))(
                params, adamw_init(params, oc),
                {k: jnp.asarray(v) for k, v in mb_batch(cfg, MB_ODD).items()})
            out["odd/raised"] = np.asarray("")
        except Exception as e:          # the type is the record
            out["odd/raised"] = np.asarray(type(e).__name__)
    np.savez(d / "jax_mb.npz", **out)


def run_ckpt(d):
    mesh = mesh_of((2, 4), ("data", "model"))
    for i, arch in enumerate(FAMILIES):
        cfg = get_reduced(arch)
        dtype = jnp.bfloat16 if arch == "musicgen_medium" else jnp.float32
        t0 = time.perf_counter()
        rng = np.random.default_rng(100 + i)
        shapes = jax.eval_shape(lambda k: lm.init_params(cfg, k, dtype),
                                jax.ShapeDtypeStruct((2,), jnp.uint32))
        params = jax.tree.map(
            lambda a: rng.normal(0, 1, a.shape).astype(a.dtype), shapes)
        mom = lambda: jax.tree.map(  # noqa: E731
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
        opt = {"mu": mom(), "nu": mom(), "step": np.asarray(7, np.int32)}
        aux = {"seed": i, "step": 3, "step_counter": 7}
        save_tree(d / arch / "plain", {"params": params, "opt": opt},
                  aux=aux)
        with mesh_context(mesh):
            rules = ShardingRules(cfg, mesh, "heads")
            shapes = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
            ps = rules.params_specs(shapes)
            sh = {"params": to_named(ps, mesh),
                  "opt": to_named(rules.opt_specs(shapes, ps), mesh)}
            tree = jax.tree.map(lambda a, s: jax.device_put(a, s),
                                {"params": params, "opt": opt}, sh)
            save_tree(d / arch / "sharded", tree, aux=aux)
        print(f"{arch}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    mode, d = sys.argv[1], Path(sys.argv[2])
    {"moe": run_moe, "ckpt": run_ckpt, "dp": run_dp, "tp": run_tp,
     "mb": run_mb}[mode](
        d, *sys.argv[3:])
    print("JAX-REF-OK")
