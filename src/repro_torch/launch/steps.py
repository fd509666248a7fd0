"""Step functions: `make_train_step`, `make_prefill_step` and
`make_decode_step`, the port of `repro/launch/steps.py`. PyTorch runs
eagerly, so there is nothing to jit.

Under a mesh of more than one rank (the context mesh when the step is
made) the training step computes what JAX's jitted step computes with
the batch sharded by `batch_specs` and the moments by `opt_specs`
(ZeRO-1), on the layout the port holds (`ShardingRules.held_spec`):
  * each rank runs its rows of the batch (the batch axes' block; the
    whole batch where it does not divide) and, at tp > 1, every dense
    layer on the whole sequence, the MoE layers expert-parallel;
  * the loss is the global token mean: the masked cross-entropy sums and
    the token counts are added over the batch axes (not a mean of the
    ranks' means, which is wrong when the masks differ), plus the MoE
    aux loss as the layers' pmean gives it;
  * each rank differentiates its share of that loss (its sum over the
    global count, divided among the ranks that hold the same rows; the
    aux loss divided among all ranks), and the gradients are summed over
    every axis a leaf is replicated on (the batch axes and 'model'; a
    routed expert's block over the batch axes only), so each rank holds
    them whole and the global norm is the one-device norm;
  * the compressor acts on the reduced gradients, as JAX's code does
    (under tp > 1 on each rank's expert blocks: int8's blocks of 256
    fall as JAX's when a block's size divides by 256; top-k picks within
    the block);
  * each rank updates only its ZeRO-1 block of each leaf's mu and nu
    ('data' on the first dim that divides) and the same block of the
    parameter, then the parameters' blocks are gathered over 'data'. A
    leaf no dim of which divides stays replicated and is updated on every
    rank.
At one rank every collective is the identity and the step is the
single-device step.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch.distributed import mesh as pg
from repro_torch.distributed.context import Mesh, batch_axes, get_mesh
from repro_torch.launch.sharding import ShardingRules, local_slice
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import _square_sum, global_norm, named_leaves


class _Plan:
    """Per leaf of a held model: whether it is a routed expert's block
    (sharded over 'model'), its global shape and its ZeRO-1 block (the
    slices into the held leaf, and the dim cut over 'data')."""

    def __init__(self, leaves: Dict[str, torch.Tensor], cfg, mesh: Mesh):
        rules = ShardingRules(cfg, mesh, "heads")
        tp = mesh.shape["model"]
        self.expert, self.blocks, self.dims, self.specs = {}, {}, {}, {}
        for n, p in leaves.items():
            held = tuple(p.shape)
            glob = (held[0] * tp,) + held[1:] if tp > 1 and \
                rules._is_expert(n, held) else held
            spec = rules.held_spec(n, glob)
            self.expert[n] = "model" in spec and tp > 1
            mom = rules.held_moment_spec(n, glob)
            self.specs[n] = (spec, mom)
            data = tuple(a if a == "data" else None for a in mom)
            self.dims[n] = data.index("data") if "data" in data else None
            self.blocks[n] = local_slice(data, held, mesh)

    def moment_shape(self, n: str, p: torch.Tensor) -> tuple:
        return tuple(p[self.blocks[n]].shape)


def held_specs(params, cfg, mesh=None) -> dict:
    """The specs (over global shapes) of the training state a rank holds
    under `mesh` (default: the context mesh): {"params": {name: spec},
    "opt": {"mu", "nu": {name: spec}, "step": ()}}, for the checkpoint
    store's blocks."""
    mesh = get_mesh() if mesh is None else mesh
    plan = _Plan(named_leaves(params), cfg, mesh)
    mom = {n: m for n, (_, m) in plan.specs.items()}
    return {"params": {n: p for n, (p, _) in plan.specs.items()},
            "opt": {"mu": mom, "nu": dict(mom), "step": ()}}


def init_opt_state(params, oc: AdamWConfig, cfg, mesh=None):
    """`adamw_init` of the rank's ZeRO-1 blocks under `mesh` (default:
    the context mesh); the whole leaves on a mesh whose 'data' axis has
    size 1."""
    mesh = get_mesh() if mesh is None else mesh
    leaves = named_leaves(params)
    if mesh.shape["data"] == 1:
        return adamw_init(leaves, oc)
    plan = _Plan(leaves, cfg, mesh)
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


def reduced_grads(params, cfg, batch, mesh=None, plan=None):
    """(the global loss, {name: gradient summed over the axes its leaf is
    replicated on}, the bytes each rank put on the all-reduce) for the
    global `batch` (tensors on the rank's device; the rank runs its rows,
    `local_batch`) under `mesh` (default: the context mesh)."""
    mesh = get_mesh() if mesh is None else mesh
    loss, grads = _rank_grads(params, cfg, batch, mesh)
    wire = 0
    if mesh.size > 1:
        plan = _Plan(named_leaves(params), cfg, mesh) if plan is None \
            else plan
        wire = _reduce(grads, plan, mesh)
    return loss, grads, wire


def _rank_grads(params, cfg, batch, mesh: Mesh):
    """(the global loss, the rank's gradients of its share of it) before
    any gradient is reduced: the module docstring."""
    leaves = named_leaves(params)
    split = ShardingRules(cfg, mesh, "heads")._bdiv(
        batch["tokens"].shape[0])
    tot, cnt, aux = lm.loss_terms(params, cfg, local_batch(batch, cfg, mesh))
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
        copies = mesh.shape["model"] if split else mesh.size
    obj = tot / (n * copies) + aux / mesh.size
    grads = dict(zip(leaves, torch.autograd.grad(obj, list(leaves.values()))))
    return (total / n + aux).detach(), grads


def _reduce(grads, plan: _Plan, mesh: Mesh) -> int:
    """Sum each gradient, in place, over the axes its leaf is replicated
    on; returns the bytes this rank put on the all-reduce."""
    wire = 0
    for experts, axes in ((False, mesh.axis_names), (True, batch_axes())):
        names = [k for k in grads if plan.expert[k] == experts]
        if names and mesh.axis_size(axes) > 1:
            wire += pg.all_reduce_buckets([grads[k] for k in names],
                                          mesh.group(axes))
    return wire


class _Span:
    """The milliseconds a part of the step takes: between two CUDA
    events on the card (recorded on the stream, read once the step's
    last event has completed, so the step adds no synchronization before
    its end), on the host's clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True)
                       for _ in range(2)]
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> "_Span":
        if self.cuda:
            self.ev[1].record()
        else:
            self.ms = 1e3 * (time.perf_counter() - self.t0)
        return self

    def read(self) -> float:
        if self.cuda:
            self.ev[1].synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return self.ms


def _norm(grads, plan, mesh: Mesh):
    """The global norm of gradients held whole but for the routed
    experts' blocks (their squares summed over 'model')."""
    if plan is None or not any(plan.expert.values()):
        return global_norm(grads)
    own = torch.stack([_square_sum(g) for n, g in grads.items()
                       if not plan.expert[n]]).sum()
    ex = torch.stack([_square_sum(g) for n, g in grads.items()
                      if plan.expert[n]]).sum()
    return (own + mesh.psum(ex, "model")).sqrt()


def make_train_step(cfg, oc: AdamWConfig, microbatches: int = 1,
                    compressor=None, device=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): `lm.loss_fn` and its gradients,
    `compressor` (a function of the gradient dict, such as an
    `ErrorFeedback`'s apply with its state) on them when given, then one
    AdamW update, in place on `params` (the `lm.LM` module) and
    `opt_state` (from `init_opt_state`). The global batch's arrays
    (numpy or tensors) go to the rank's `device`, the card unless "cpu"
    is asked for. With `microbatches` > 1 (one rank only) the batch is
    split along its rows, each part's gradients summed in fp32 and
    divided by the count, as JAX's `lax.scan` does; the loss is the
    parts' mean. Under a mesh of more than one rank: the module
    docstring; `train_step.wire` then holds the last step's collectives,
    each rank's bytes ("all_reduce", "all_gather") and milliseconds
    ("all_reduce_ms", "all_gather_ms": on the card from CUDA events
    around each, the wait for its inputs included where the host
    blocks on it)."""
    mesh = get_mesh()
    dev = pg.rank_device(device)
    if microbatches > 1 and mesh.size > 1:
        raise ValueError("microbatches > 1 run on one rank only: JAX's "
                         "microbatches cut the global batch's rows, not "
                         "each rank's")
    state = {"plan": None}

    def grads_of(params, batch):
        leaves = named_leaves(params)
        loss, _ = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        leaves = named_leaves(params)
        plan = state["plan"]
        if mesh.size > 1 and plan is None:
            plan = state["plan"] = _Plan(leaves, cfg, mesh)
        wire = {"all_reduce": 0, "all_gather": 0}
        spans = {}
        if microbatches > 1:
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
        elif mesh.size == 1:
            loss, grads = grads_of(params, batch)
        else:
            loss, grads = _rank_grads(params, cfg, batch, mesh)
            spans["all_reduce"] = _Span(dev)
            wire["all_reduce"] = _reduce(grads, plan, mesh)
            spans["all_reduce"].stop()
        if compressor is not None:
            grads = compressor(grads)
        norm = _norm(grads, plan, mesh)
        if plan is None or mesh.shape["data"] == 1:
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 oc, norm=norm)
        else:
            blocks = {n: p.data[plan.blocks[n]] for n, p in leaves.items()}
            gb = {n: g[plan.blocks[n]] for n, g in grads.items()}
            _, opt_state, om = adamw_update(blocks, gb, opt_state, oc,
                                            norm=norm)
            cut = [n for n in leaves if plan.dims[n] is not None]
            if cut:
                spans["all_gather"] = _Span(dev)
                wire["all_gather"] = pg.all_gather_blocks(
                    [leaves[n].data for n in cut],
                    [plan.dims[n] for n in cut], mesh.group("data"))
                spans["all_gather"].stop()
        for k in ("all_reduce", "all_gather"):
            wire[k + "_ms"] = spans[k].read() if k in spans else 0.0
        train_step.wire = wire
        return params, opt_state, {"loss": loss, **om}

    train_step.wire = {"all_reduce": 0, "all_gather": 0,
                       "all_reduce_ms": 0.0, "all_gather_ms": 0.0}
    return train_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, cache, cache_pos):
        return lm.decode_step(params, cfg, token, cache, cache_pos)
    return decode_step
