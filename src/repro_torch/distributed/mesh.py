"""The process-group side of the mesh tier: what `repro.compat.make_mesh`
and `jax.devices()` give the JAX package.

One rank per device. With no process group initialised the world is one
rank, rank 0 of 1: the twin of JAX on a one-device host. A multi-rank
world is started by the caller, either by `torchrun` and
`init_process_group` (NCCL when each rank has a card of its own), or by
`init_for_tests` / `spawn` (gloo from a `FileStore`: CPU ranks, or ranks
that share one card, which NCCL refuses).

    rank, world = mesh.world()
    dev = mesh.rank_device(None)          # cuda:local_rank, or cuda:0
    groups = mesh.stage_groups(stages)    # this rank's group per stage
    y = mesh.all_gather(x, group)         # (m * x.shape[0], ...)

The wire. Collectives take the tensors where they lie, on either
backend: NCCL gathers CUDA tensors on the card, and gloo gathers and
broadcasts CUDA tensors as well as host ones in the card machine's torch
2.11 (PyTorch's backend table lists gloo GPU support for broadcast and
all_reduce only; gloo's CUDA work copies through pinned host memory
itself). A collective that fails raises; nothing is retried another
way.

The distribution slice's collectives (`all_reduce_ad`, `all_gather_ad`,
`all_to_all_ad`, the model axis's region functions below, and
`all_reduce_buckets` / `all_gather_blocks` for the training step) use
only the tensor forms: `all_reduce`,
`all_gather_into_tensor`, `reduce_scatter_tensor` and
`all_to_all_single`. On the card machine's torch 2.11 gloo takes all
four on CUDA tensors, in fp32 and bf16, and refuses the list form of
`all_to_all` ("Backend gloo does not support alltoall"), which
`torch.distributed.nn.functional` falls back on for some backwards; so
the port carries its own autograd functions, one wire for both
backends, with no host staging of its own (a 512 MB bf16 all_to_all
staged through `.cpu()` took 1.24 s against gloo's own 0.52 s on the
H100's host). The `_ad` functions are autograd-aware: the backward of
an all_reduce is an all_reduce, of an all_gather a reduce-scatter (a
sum over the members, each keeping its block), of an all_to_all the
reverse all_to_all.

A shape-only mesh (`context.Mesh` without groups: the dry-run's 256 or
512 ranks in one process) hands out a `ShapeGroup` in place of a process
group. Every collective here takes it for meta tensors only: the output
is allocated in its shape (an all-gather's dim times the group's size, a
reduce-scatter's divided by it, the rest unchanged), counted by `tally`
and by an open `launch.op_analysis.OpCounter`, and nothing is sent; a
real tensor raises RuntimeError.

The model axis (Megatron's tensor parallelism) takes the region
functions in pairs, each the other's transpose: `copy_to_ad` (f:
identity forward, sum backward) at a column-parallel input and
`reduce_from_ad` (g: sum forward, identity backward) at a row-parallel
output; `split_ad` (a member's block forward, the blocks gathered
backward) where a replicated value enters a sharded region and
`gather_from_ad` (gathered forward, the member's block backward) where
it leaves; `reduce_scatter_ad` (summed and cut forward, gathered
backward) where a row-parallel output enters a sequence-sharded
residual. A replicated value's gradient is whole on every member, so
`all_reduce_ad` (a sum both ways, psum's transpose under `shard_map`)
would count it once a member there.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve
from repro_torch.launch import op_analysis

__all__ = ["world", "rank_device", "init_from_env", "init_for_tests",
           "spawn", "stage_groups", "all_gather", "broadcast",
           "all_reduce_ad", "all_gather_ad", "all_to_all_ad",
           "copy_to_ad", "reduce_from_ad", "split_ad", "gather_from_ad",
           "reduce_scatter_ad", "all_reduce_max",
           "all_reduce_buckets", "all_gather_blocks", "ShapeGroup"]

# the groups every rank has built, keyed by their ranks: new_group is a
# collective of the whole world, so each group is built once, by every
# rank, in the same order
_GROUPS: Dict[Tuple[int, ...], object] = {}
# the model's collectives, one record a `tally` open: {op: [calls,
# bytes, ms or the CUDA event pairs to read]}
_TALLIES: List[dict] = []


@contextlib.contextmanager
def tally():
    """Count the model's collectives (the autograd functions below and
    `all_gather`) while open: yields {op: [calls, bytes a rank put in,
    ms]}, the ms from CUDA events around each call on the card (read
    when the block closes, after a synchronize), the host's clock on the
    CPU. Every tally open counts every collective of this module: the
    training step opens its own around its gradient all-reduce and
    parameter all-gather (`train_step.wire`), and a tally around the
    step counts those too."""
    got: dict = {}
    _TALLIES.append(got)
    out = {}
    try:
        yield out
    finally:
        _TALLIES.remove(got)
        for op, (n, b, spans) in got.items():
            ms = 0.0
            for sp in spans:
                if isinstance(sp, tuple):
                    sp[1].synchronize()
                    ms += sp[0].elapsed_time(sp[1])
                else:
                    ms += sp
            out[op] = [n, b, ms]


class ShapeGroup(NamedTuple):
    """A shape-only mesh's group over some axes: its size and this rank's
    index in it (the module docstring)."""
    size: int
    rank: int


def _size(group) -> int:
    return group.size if isinstance(group, ShapeGroup) \
        else dist.get_world_size(group)


def _rank(group) -> int:
    return group.rank if isinstance(group, ShapeGroup) \
        else dist.get_rank(group)


def _wire(op: str, t: torch.Tensor, out: torch.Tensor, group, fn) -> None:
    """Run the collective `fn` on `t` (its result `out`, allocated),
    counted when `tally` or an op counter is open; over a `ShapeGroup`,
    nothing is sent, and only meta tensors pass."""
    shape_only = isinstance(group, ShapeGroup)
    if shape_only:
        if t.device.type != "meta":
            raise RuntimeError(f"{op} over a shape-only mesh (no process "
                               f"group): only meta tensors pass, got one on "
                               f"{t.device}")
        fn = None
    op_analysis.collective(op, out)
    if not _TALLIES:
        if fn is not None:
            fn()
        return
    n = t.numel() * t.element_size()
    if fn is None:
        span = 0.0
    elif t.is_cuda:
        span = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[0].record()
        fn()
        span[1].record()
    else:
        t0 = time.perf_counter()
        fn()
        span = 1e3 * (time.perf_counter() - t0)
    for got in _TALLIES:
        rec = got.setdefault(op, [0, 0, []])
        rec[0] += 1
        rec[1] += n
        rec[2].append(span)


def world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) when torch.distributed is not
    initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local() -> Tuple[int, int]:
    """(local rank, ranks on this host): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else the global pair (one host)."""
    rank, size = world()
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", size)))


def rank_device(device=None) -> torch.device:
    """The rank's torch device: `device` as `device.resolve` reads it
    (None is the card), and for a CUDA device without an index,
    cuda:local_rank when each rank on the host has a card of its own and
    cuda:0 when the ranks share one."""
    dev = resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local_rank, local_size = _local()
    own = torch.cuda.device_count() >= local_size
    return torch.device("cuda", local_rank if own else 0)


def init_from_env(device=None) -> bool:
    """Join the world `torchrun` describes (RANK, WORLD_SIZE and the
    MASTER_* rendezvous in the environment): NCCL when `device` is the
    card and each rank on the host has one of its own, gloo otherwise;
    then make the rank's card current. Returns True when this call
    started the world (the caller destroys it), False outside torchrun
    or with a world already up."""
    if "RANK" not in os.environ or dist.is_initialized():
        return False
    dev = resolve(device)
    own = dev.type == "cuda" and torch.cuda.device_count() >= int(
        os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    dist.init_process_group("nccl" if own else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(device))
    return True


def init_for_tests(store_path, rank: int, world_size: int,
                   timeout_s: float = 300.0) -> None:
    """Start a gloo world from a `FileStore` at `store_path` (never a TCP
    port: test workers run side by side). Every rank passes the same
    path; the file must not hold an earlier world's store. A collective
    that waits `timeout_s` for a peer raises."""
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_entry(rank: int, fn, world_size: int, store_path, args,
                timeout_s: float = 300.0) -> None:
    init_for_tests(store_path, rank, world_size, timeout_s)
    try:
        fn(rank, world_size, *args)
    finally:
        _GROUPS.clear()
        dist.destroy_process_group()


def spawn(fn, world_size: int, store_path, args: Sequence = (),
          timeout_s: float = 600.0,
          collective_timeout_s: float = 300.0) -> None:
    """Run `fn(rank, world_size, *args)` in `world_size` spawned
    processes over one gloo world (`init_for_tests` at `store_path`,
    collectives waiting `collective_timeout_s` at most). `fn` must be
    importable by the children (a module-level function). Returns when
    every rank has returned; raises when one raised (the others are
    terminated) or when `timeout_s` passes first."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_entry, nprocs=world_size, join=False,
                             args=(fn, world_size, str(store_path),
                                   tuple(args), collective_timeout_s),
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world_size} ranks did not finish in "
                               f"{timeout_s:.0f} s")


def stage_groups(stages: List[List[List[int]]]) -> List[Optional[object]]:
    """One process group for every group of every stage of an
    `exchange.collective_stages` plan, built by every rank in plan order
    (members or not) and cached; returns this rank's group at each stage
    (None where the rank is in none, as ranks past the plan's devices
    are). The gather concatenates in the group's rank order, which
    new_group sorts: the plan's groups must be ascending."""
    rank, _ = world()
    mine: List[Optional[object]] = []
    for groups in stages:
        own = None
        for g in groups:
            if list(g) != sorted(g):
                raise ValueError(f"stage group {g} is not ascending: the "
                                 f"gather would reorder its blocks")
            key = tuple(int(r) for r in g)
            if key not in _GROUPS:
                _GROUPS[key] = dist.new_group(list(key))
            if rank in key:
                own = _GROUPS[key]
                got = dist.get_process_group_ranks(own)
                if list(got) != list(key):
                    raise RuntimeError(f"group {key} gathers in rank order "
                                       f"{got}")
        mine.append(own)
    return mine


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's `x` concatenated along dim 0 in the group's rank
    order: (m * x.shape[0],) + x.shape[1:], on x's device."""
    m = _size(group)
    x = x.contiguous()
    out = torch.empty((m * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _wire("all_gather", x, out, group, lambda: dist.all_gather_into_tensor(
        out, x, group=group))
    return out


def broadcast(tensors: Sequence[torch.Tensor], src: int = 0,
              group=None) -> List[torch.Tensor]:
    """`src`'s tensors on every rank, as ONE broadcast of their bytes;
    the other ranks pass tensors of the same shapes and dtypes to be
    filled. Returns new tensors on each input's device. Each tensor's
    bytes start on an 8-byte boundary, so every slice views back as its
    dtype."""
    flat = []
    for t in tensors:
        b = t.contiguous().view(-1).view(torch.uint8)
        flat += [b, b.new_zeros(-b.numel() % 8)]
    buf = torch.cat(flat)
    dist.broadcast(buf, src, group=group)
    out, o = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(buf[o:o + n].view(t.dtype).view(t.shape))
        o += n + (-n % 8)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _wire("all_reduce", y, y, group, lambda: dist.all_reduce(
            y, group=group))
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _wire("all_reduce", g, g, ctx.group, lambda: dist.all_reduce(
            g, group=ctx.group))
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        y = all_gather(x.movedim(dim, 0), group)
        return y.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        m = _size(ctx.group)
        out = g.new_empty((g.shape[0] // m,) + tuple(g.shape[1:]))
        _wire("reduce_scatter", g, out, ctx.group,
              lambda: dist.reduce_scatter_tensor(out, g, group=ctx.group))
        return out.movedim(0, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        y = torch.empty_like(x)
        _wire("all_to_all", x, y, group, lambda: dist.all_to_all_single(
            y, x, group=group))
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        _wire("all_to_all", g, out, ctx.group,
              lambda: dist.all_to_all_single(out, g, group=ctx.group))
        return out, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _wire("all_reduce", g, g, ctx.group, lambda: dist.all_reduce(
            g, group=ctx.group))
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        _wire("all_reduce", y, y, group, lambda: dist.all_reduce(
            y, group=group))
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _block(x, group, dim):
    m = _size(group)
    k = _rank(group)
    n = x.shape[dim] // m
    return x.narrow(dim, k * n, n)


class _Split(torch.autograd.Function):
    """This member's block along `dim` forward, the blocks gathered
    backward: a replicated value entering a sharded region."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        y = all_gather(g.movedim(ctx.dim, 0), ctx.group)
        return y.movedim(0, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    """The blocks gathered along `dim` forward, this member's block of
    the gradient backward: a sharded value leaving for a replicated
    region (whose gradient every member holds whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    """The members' x summed, each keeping its block along `dim`,
    forward; the blocks gathered backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        g = x.movedim(dim, 0).contiguous()
        m = _size(group)
        out = g.new_empty((g.shape[0] // m,) + tuple(g.shape[1:]))
        _wire("reduce_scatter", g, out, group,
              lambda: dist.reduce_scatter_tensor(out, g, group=group))
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        y = all_gather(g.movedim(ctx.dim, 0), ctx.group)
        return y.movedim(0, ctx.dim), None, None


def copy_to_ad(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient summed over the group (Megatron's f,
    at a column-parallel input)."""
    return _CopyTo.apply(x, group)


def reduce_from_ad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every member's x; its gradient passed through
    (Megatron's g, at a row-parallel output)."""
    return _ReduceFrom.apply(x, group)


def split_ad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This member's block of x along `dim` (blocks in group rank
    order); the backward gathers the gradient's blocks."""
    return _Split.apply(x, group, dim)


def gather_from_ad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's x concatenated along `dim`; the backward keeps
    this member's block of the gradient (`split_ad`'s inverse)."""
    return _GatherFrom.apply(x, group, dim)


def reduce_scatter_ad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of every member's x, this member's block along `dim`;
    the backward gathers the gradient's blocks."""
    return _ReduceScatter.apply(x, group, dim)


def all_reduce_ad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every member's x, on every member."""
    return _AllReduce.apply(x, group)


def all_gather_ad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every member's x concatenated along `dim` in the group's rank
    order."""
    return _AllGather.apply(x, group, dim)


def all_to_all_ad(x: torch.Tensor, group) -> torch.Tensor:
    """x (m, ...) over a group of m: block i to member i; block j of the
    result from member j."""
    return _AllToAll.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every member's x, without a gradient."""
    y = x.detach().contiguous().clone()
    _wire("all_reduce", y, y, group, lambda: dist.all_reduce(
        y, dist.ReduceOp.MAX, group=group))
    return y


BUCKET_BYTES = 256 << 20


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """Runs of consecutive tensors of one dtype and device, each run
    under `bucket_bytes` (a larger tensor is a run of its own)."""
    run, size = [], 0
    for i, t in enumerate(tensors):
        n = t.numel() * t.element_size()
        if run and (t.dtype != tensors[run[0]].dtype
                    or t.device != tensors[run[0]].device
                    or size + n > bucket_bytes):
            yield run
            run, size = [], 0
        run.append(i)
        size += n
    if run:
        yield run


def all_reduce_buckets(tensors: Sequence[torch.Tensor], group,
                       bucket_bytes: int = BUCKET_BYTES) -> int:
    """Sum each tensor over the group, in place, a bucket of consecutive
    tensors (one dtype) at a time: one all_reduce of their concatenated
    bytes. Returns the bytes each rank put on the wire's input."""
    sent = 0
    for run in _buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        _wire("all_reduce", flat, flat, group,
              lambda: dist.all_reduce(flat, group=group))
        o = 0
        for i in run:
            t = tensors[i]
            t.copy_(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()
        sent += flat.numel() * flat.element_size()
    return sent


def all_gather_blocks(fulls: Sequence[torch.Tensor], dims: Sequence[int],
                      group, bucket_bytes: int = BUCKET_BYTES) -> int:
    """Each full tensor holds, along `dims[i]`, m equal blocks of which
    this rank (index k in the group) has brought block k up to date; put
    every member's block in place on every member, a bucket of tensors
    (one dtype) at a time: one all_gather of the concatenated blocks.
    Returns the bytes each rank gathered in."""
    m = _size(group)
    k = _rank(group)
    got = 0
    for run in _buckets(fulls, bucket_bytes):
        blocks = [fulls[i].movedim(dims[i], 0) for i in run]
        mine = [b.reshape((m, -1) + tuple(b.shape[1:]))[k].reshape(-1)
                for b in blocks]
        out = all_gather(torch.cat(mine), group).view(m, -1)
        o = 0
        for b, piece in zip(blocks, mine):
            n = piece.numel()
            b.copy_(out[:, o:o + n].reshape(b.shape))
            o += n
        got += out.numel() * out.element_size()
    return got
