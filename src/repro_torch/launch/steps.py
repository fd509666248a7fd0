"""Step functions: `make_train_step`, `make_prefill_step` and
`make_decode_step`, the port of `repro/launch/steps.py`. PyTorch runs
eagerly, so there is nothing to jit.

Under a mesh of more than one rank (the context mesh when the step is
made) the training step computes what JAX's jitted step computes with
the batch sharded by `batch_specs`, the parameters by `params_specs`
and the moments by `opt_specs` (ZeRO-1), on the layout the port holds
(`ShardingRules.held_spec` under the step's attention `layout`):
  * each rank runs its rows of the batch (the batch axes' block; the
    whole batch where it does not divide) on the blocks it holds: at tp
    > 1 the layers are tensor-parallel (Megatron's f and g,
    `models.layers`, `models.attention`, `models.ssm`, `models.rglru`),
    the MoE layers expert-parallel; an FSDP config's leaves are gathered
    over 'data' inside each layer's checkpoint and their gradients
    reduce-scattered back (`models.lm`);
  * the loss is the global token mean: the masked cross-entropy sums and
    the token counts are added over the batch axes (not a mean of the
    ranks' means, which is wrong when the masks differ), plus the MoE
    aux loss as the layers' pmean gives it;
  * each rank differentiates its rows' share of that loss (its sum over
    the global count, divided among the data ranks that hold the same
    rows; the aux loss divided among all ranks); the ranks of one model
    group each differentiate the whole of it, as Megatron does, so a
    replicated value's gradient is whole on each of them;
  * each gradient is then summed over the batch axes its leaf is not
    held over (`_Plan.axes`), and over 'model' too where each rank's is
    partial: a leaf held whole whose rank computed on its own rows,
    heads or channels (`_partial`);
  * the global norm counts each block of a leaf held over an axis once
    and each replicated leaf once (JAX's value);
  * the compressor acts on the reduced gradients, as JAX's code does
    (under tp > 1 on each rank's blocks: int8's blocks of 256 fall as
    JAX's when a block's size divides by 256; top-k picks within the
    block);
  * each rank updates only its ZeRO-1 block of each leaf's mu and nu
    (`held_moment_spec`'s 'data' dim) and the same block of the
    parameter, then the parameters' blocks are gathered over 'data'. A
    leaf no dim of which divides stays replicated and is updated on every
    rank; an FSDP leaf is its own block (its moments shard nothing
    more).
At one rank every collective is the identity and the step is the
single-device step.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import mesh as pg
from repro_torch.distributed.context import Mesh, batch_axes, get_mesh
from repro_torch.launch.sharding import ShardingRules, local_slice
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import _square_sum, global_norm, named_leaves


class _Plan:
    """Per leaf of a held model (global shapes from the config): its held
    and moment specs, the live axes it is held over (`sharded`), the
    axes its gradient is summed over (`axes`) and its ZeRO-1 block (the
    slices into the held leaf, and the dim cut over 'data')."""

    def __init__(self, leaves: Dict[str, torch.Tensor], cfg, mesh: Mesh,
                 layout: str = "heads"):
        rules = ShardingRules(cfg, mesh, layout)
        shapes = lm.param_shapes(cfg)
        tp = mesh.shape["model"]
        seq = tp > 1 and layout == "seq"
        self.specs, self.sharded, self.axes = {}, {}, {}
        self.blocks, self.dims = {}, {}
        for n, p in leaves.items():
            spec = rules.held_spec(n, shapes[n])
            mom = rules.held_moment_spec(n, shapes[n])
            self.specs[n] = (spec, mom)
            held = _live(spec, mesh)
            self.sharded[n] = tuple(a for a in mesh.axis_names if a in held)
            red = {a for a in batch_axes() if a not in held}
            if tp > 1 and _partial(n, cfg, seq, rules, shapes):
                red.add("model")
            self.axes[n] = tuple(a for a in mesh.axis_names if a in red)
            zero = tuple("data" if a == "data" and "data" not in held
                         else None for a in mom)
            self.dims[n] = zero.index("data") if "data" in zero \
                and mesh.shape["data"] > 1 else None
            self.blocks[n] = local_slice(zero, tuple(p.shape), mesh)

    def moment_shape(self, n: str, p: torch.Tensor) -> tuple:
        return tuple(p[self.blocks[n]].shape)


def _live(spec, mesh: Mesh) -> set:
    """The axes of size > 1 a spec holds a leaf over."""
    out = set()
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            if mesh.shape[a] > 1:
                out.add(a)
    return out


_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _partial(name: str, cfg, seq: bool, rules, shapes) -> bool:
    """Whether a leaf's gradient on one rank is a partial sum at tp > 1:
    the MoE router (each rank routes its own positions), a GQA leaf of
    the "seq" layout (the rank's rows), the block norms of a sequence-
    parallel residual (the rank's rows), and a leaf held whole beside a
    sibling cut over 'model', which the rank uses in its slice: a whole
    `wk`/`wv`/`bk`/`bv` beside query heads held in blocks, the SSM's
    per-head `a_log`, `dt_bias`, `d_skip` and its `out_norm` scale beside
    a cut `w_out`, the RG-LRU's `conv_w` and a whole `w_i`/`w_r` beside a
    cut `w_x`."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    if leaf == "router":
        return True

    def cut_beside(up: int, sib: str) -> bool:
        other = ".".join(parts[:-up] + [sib])
        held = lambda n: "model" in _live(  # noqa: E731
            rules.held_spec(n, shapes[n]), rules.mesh)
        return other in shapes and held(other) and not held(name)
    if parent == "attn" and leaf in _ATTN:
        return seq or (leaf in ("wk", "wv", "bk", "bv")
                       and cut_beside(1, "wq"))
    if parent == "ssm" and leaf in ("a_log", "dt_bias", "d_skip"):
        return cut_beside(1, "w_out")
    if parent == "out_norm" and len(parts) > 2 and parts[-3] == "ssm":
        return cut_beside(2, "w_out")
    if parent == "rec" and leaf in ("conv_w", "w_i", "w_r"):
        return cut_beside(1, "w_x")
    return bool(cfg.seq_parallel) and parent in ("ln1", "ln2")


def held_specs(params, cfg, mesh=None, layout: str = "heads") -> dict:
    """The specs (over global shapes) of the training state a rank holds
    under `mesh` (default: the context mesh): {"params": {name: spec},
    "opt": {"mu", "nu": {name: spec}, "step": ()}}, for the checkpoint
    store's blocks."""
    mesh = get_mesh() if mesh is None else mesh
    plan = _Plan(named_leaves(params), cfg, mesh, layout)
    mom = {n: m for n, (_, m) in plan.specs.items()}
    return {"params": {n: p for n, (p, _) in plan.specs.items()},
            "opt": {"mu": mom, "nu": dict(mom), "step": ()}}


def init_opt_state(params, oc: AdamWConfig, cfg, mesh=None,
                   layout: str = "heads"):
    """`adamw_init` of the rank's ZeRO-1 blocks of its held leaves under
    `mesh` (default: the context mesh); the held leaves whole on a mesh
    whose 'data' axis has size 1."""
    mesh = get_mesh() if mesh is None else mesh
    leaves = named_leaves(params)
    if mesh.shape["data"] == 1:
        return adamw_init(leaves, oc)
    plan = _Plan(leaves, cfg, mesh, layout)
    dt = getattr(torch, oc.moment_dtype)
    dev = next(iter(leaves.values())).device
    mom = {n: p.new_zeros(plan.moment_shape(n, p), dtype=dt)
           for n, p in leaves.items()}
    return {"mu": mom, "nu": {n: t.clone() for n, t in mom.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def local_batch(batch, cfg, mesh=None):
    """The rank's rows of a global batch: the batch axes' block of every
    array whose rows divide over them (`batch_specs`), the whole array
    otherwise."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh.size == 1:
        return batch
    specs = ShardingRules(cfg, mesh, "heads").batch_specs(batch)
    return {k: v[local_slice(specs[k], v.shape, mesh)]
            for k, v in batch.items()}


def reduced_grads(params, cfg, batch, mesh=None, plan=None,
                  layout: str = "heads"):
    """(the global loss, {name: gradient summed over `_Plan.axes`}, the
    bytes each rank put on the all-reduce) for the global `batch`
    (tensors on the rank's device; the rank runs its rows,
    `local_batch`) under `mesh` (default: the context mesh)."""
    mesh = get_mesh() if mesh is None else mesh
    loss, grads = _rank_grads(params, cfg, batch, mesh, layout)
    wire = 0
    if mesh.size > 1:
        plan = _Plan(named_leaves(params), cfg, mesh, layout) \
            if plan is None else plan
        wire = _reduce(grads, plan, mesh)
    return loss, grads, wire


def _rank_grads(params, cfg, batch, mesh: Mesh, layout: str = "heads"):
    """(the global loss, the rank's gradients of its share of it) before
    any gradient is reduced: the module docstring."""
    leaves = named_leaves(params)
    split = ShardingRules(cfg, mesh, layout)._bdiv(
        batch["tokens"].shape[0])
    tot, cnt, aux = lm.loss_terms(params, cfg, local_batch(batch, cfg, mesh),
                                  layout)
    if mesh.size == 1:
        n, copies, total = cnt.clamp(min=1.0), 1, tot.detach()
    else:
        baxes = batch_axes()
        with torch.no_grad():
            if split:
                sums = mesh.psum(torch.stack([tot.detach(), cnt]), baxes)
                total, n = sums[0], sums[1].clamp(min=1.0)
            else:
                total, n = tot.detach(), cnt.clamp(min=1.0)
        copies = 1 if split else mesh.axis_size(baxes)
    obj = tot / (n * copies) + aux / mesh.size
    grads = dict(zip(leaves, torch.autograd.grad(obj, list(leaves.values()))))
    return (total / n + aux).detach(), grads


def _reduce(grads, plan: _Plan, mesh: Mesh) -> int:
    """Sum each gradient, in place, over its `_Plan.axes`, the leaves of
    one set of axes together in order; returns the bytes this rank put
    on the all-reduce."""
    wire = 0
    groups: Dict[tuple, list] = {}
    for k in grads:
        groups.setdefault(plan.axes[k], []).append(k)
    for axes, names in groups.items():
        if axes and mesh.axis_size(axes) > 1:
            wire += pg.all_reduce_buckets([grads[k] for k in names],
                                          mesh.group(axes, grads[names[0]]))
    return wire


def _norm(grads, plan, mesh: Mesh):
    """The global norm: each leaf's squares summed over the axes it is
    held over (each block once), a replicated leaf's once; the one-
    device norm when every leaf is held whole."""
    if plan is None or not any(plan.sharded.values()):
        return global_norm(grads)
    by: Dict[tuple, list] = {}
    for n, g in grads.items():
        by.setdefault(plan.sharded[n], []).append(_square_sum(g))
    total = None
    for axes, sq in by.items():
        part = torch.stack(sq).sum()
        part = mesh.psum(part, axes) if axes else part
        total = part if total is None else total + part
    return total.sqrt()


def make_train_step(cfg, oc: AdamWConfig, layout: str = "heads",
                    microbatches: int = 1, compressor=None, device=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): `lm.loss_fn` and its gradients,
    `compressor` (a function of the gradient dict, such as an
    `ErrorFeedback`'s apply with its state) on them when given, then one
    AdamW update, in place on `params` (the `lm.LM` module, held under
    `layout` on a mesh) and `opt_state` (from `init_opt_state`). The
    global batch's arrays (numpy or tensors) go to the rank's `device`,
    the card unless "cpu" is asked for.

    With `microbatches` = m > 1 the global batch of B rows (B % m == 0,
    else `ValueError`, as JAX's reshape refuses it) is cut into m
    contiguous blocks of rows [i B/m, (i+1) B/m), the rows of JAX's
    reshape-and-scan. Each block's gradients are summed in fp32 and
    divided by m; the loss is the blocks' mean. Under a mesh a block's
    gradients are the rank's share of that block's own global loss,
    before any reduction: its rows of the block, or all of them counted
    once where they do not divide over the batch axes. The fp32 sum is
    then reduced ONCE. JAX's GSPMD program may reduce each microbatch's
    gradients as it goes; in fp32 that only reorders the sums. The
    all-reduce moves the fp32 size of the reduced leaves once a step.

    Under a mesh of more than one rank: the module
    docstring; `train_step.wire` then holds the last step's collectives
    after its gradients (`distributed.mesh.tally`): each rank's bytes
    put in its all-reduces (the gradients', the norm's) and gathered in
    by its all-gather ("all_reduce", "all_gather"), and their
    milliseconds ("all_reduce_ms", "all_gather_ms": on the card from
    CUDA events around each call, read at the step's end)."""
    mesh = get_mesh()
    dev = pg.rank_device(device)
    state = {"plan": None}

    def grads_of(params, batch):
        if mesh.size > 1:
            return _rank_grads(params, cfg, batch, mesh, layout)
        leaves = named_leaves(params)
        loss, _ = lm.loss_fn(params, cfg, batch, layout)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        leaves = named_leaves(params)
        plan = state["plan"]
        if mesh.size > 1 and plan is None:
            plan = state["plan"] = _Plan(leaves, cfg, mesh, layout)
        if microbatches > 1:
            rows = batch["tokens"].shape[0]
            if rows % microbatches:
                raise ValueError(f"a batch of {rows} rows does not cut "
                                 f"into {microbatches} microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in leaves.items()}
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grads_of(params, mb)
                for n, t in g.items():
                    acc[n] += t
                loss = loss + l
                del g
            grads = {n: t / microbatches for n, t in acc.items()}
            loss = loss / microbatches
        else:
            loss, grads = grads_of(params, batch)
        with pg.tally() as wire:              # read at the step's end
            if plan is not None:
                _reduce(grads, plan, mesh)
            if compressor is not None:
                grads = compressor(grads)
            norm = _norm(grads, plan, mesh)
            if plan is None or mesh.shape["data"] == 1:
                params, opt_state, om = adamw_update(params, grads,
                                                     opt_state, oc, norm=norm)
            else:
                blocks = {n: p.data[plan.blocks[n]]
                          for n, p in leaves.items()}
                gb = {n: g[plan.blocks[n]] for n, g in grads.items()}
                _, opt_state, om = adamw_update(blocks, gb, opt_state, oc,
                                                norm=norm)
                cut = [n for n in leaves if plan.dims[n] is not None]
                if cut:
                    pg.all_gather_blocks([leaves[n].data for n in cut],
                                         [plan.dims[n] for n in cut],
                                         mesh.group("data", leaves[cut[0]]))
        ar, ag = (wire.get(k, (0, 0, 0.0)) for k in ("all_reduce",
                                                      "all_gather"))
        # the all-gather's bytes as a rank gathered them in: every
        # member's block
        train_step.wire = {"all_reduce": ar[1],
                           "all_gather": ag[1] * mesh.shape.get("data", 1),
                           "all_reduce_ms": ar[2], "all_gather_ms": ag[2]}
        return params, opt_state, {"loss": loss, **om}

    train_step.wire = {"all_reduce": 0, "all_gather": 0,
                       "all_reduce_ms": 0.0, "all_gather_ms": 0.0}
    return train_step


def make_prefill_step(cfg, layout: str = "heads"):
    """prefill_step(params, batch) -> (logits, caches): `lm.prefill`;
    under a mesh of more than one rank the rank's rows of the global
    batch (`local_batch`), its caches held by `cache_specs`."""
    mesh = get_mesh()

    def prefill_step(params, batch):
        if mesh.size > 1:
            batch = local_batch(batch, cfg, mesh)
        return lm.prefill(params, cfg, batch, layout)
    return prefill_step


def make_decode_step(cfg, layout: str = "heads", max_len=None):
    """decode_step(params, token, cache, cache_pos) -> (logits, cache):
    `lm.decode_step`; under a mesh of more than one rank the rank's rows
    of the global tokens, its cache (`lm.init_cache` under the mesh, of
    `max_len` rows in all) held by `cache_specs`."""
    mesh = get_mesh()
    cache_len = None if max_len is None else int(max_len)

    def decode_step(params, token, cache, cache_pos):
        if mesh.size > 1:
            token = local_batch({"tokens": token}, cfg, mesh)["tokens"]
        return lm.decode_step(params, cfg, token, cache, cache_pos, layout,
                              cache_len)
    return decode_step
