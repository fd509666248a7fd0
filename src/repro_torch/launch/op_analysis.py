"""One rank's cost of a step, counted as it runs — the port's counterpart
of `repro/launch/hlo_analysis.py`.

JAX's dry-run reads its costs from the compiled HLO text. Eager PyTorch
has no HLO: `OpCounter`, a `TorchDispatchMode`, counts each aten op as it
runs, on any device — the meta device (the dry-run: shapes only, nothing
allocated or computed), the CPU or the card:

  flops            — 2 * prod(result) * prod(contracting dims) for every
                     mm, bmm, addmm and baddbmm (an einsum dispatches
                     these): `hlo_analysis._dot_flops`' rule
  hbm_bytes        — operand + result bytes of every op that is not a view
                     or an empty allocation. The port runs eagerly, so
                     unlike JAX's estimate at fusion boundaries this is the
                     traffic it has
  hbm_bytes_tight  — the same less copies and dtype casts (JAX's `_CASTY`)
  collective_bytes — the result bytes of each collective of
                     `distributed.mesh` (JAX's rule); `collective_breakdown`
                     gives them under JAX's names
  memory           — argument, output and temp bytes and the peak of the
                     live storages, each tracked by a weakref finaliser, so
                     a tensor counts until the program lets its storage go

Kernel calls. Each wrapper of `repro_torch.kernels` reports its call
(`kernel`): one op, charged with the work of the function it computes,
whatever implements it (PERF.md §6's bound rule): attention 2 products
forward and 5 backward over the (query, key) pairs its causal mask,
window and offset keep; the SNN kernels the bytes of the rows that are
live (every row on meta, where no event is known: `snn_rows_assumed`
says so). The wrapper's own torch ops, and on the CPU its plain
version's, are not counted, so the CPU, the meta device and the card
give one count; on the CPU the wrapper's launch path is replayed on meta
for the memory, so the peak is the card's there too. `kernel_calls`
counts each kernel as the wrappers' `launches` counters count the
card's launches.

JAX needed while-loop trip counts because XLA:CPU visits a loop body
once; the port's Python loops over layers and chunks run, and are
counted as they run.

    with OpCounter() as c:
        c.arguments(params, opt_state, batch)
        out = step(params, opt_state, batch)
        c.outputs(out)
    c.record()      # {"analysis", "collectives", "memory", "kernel_calls"}
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# the product ops: (index of the left operand, in the op's arguments)
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1}
# views the schema does not mark as aliasing, and allocations that move
# no data
_VIEWS = {aten._unsafe_view, aten.lift_fresh}
_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
# copies and casts: what `hbm_bytes_tight` leaves out
_CASTY = {aten._to_copy, aten.copy_, aten.clone, aten._copy_from}

# `distributed.mesh`'s collectives under JAX's names
COLLECTIVES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

_STACK: List["OpCounter"] = []      # counters open, innermost last


def active() -> Optional["OpCounter"]:
    """The innermost open counter, or None."""
    return _STACK[-1] if _STACK else None


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree (a module's parameters and buffers)."""
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            out += list(t.parameters()) + list(t.buffers())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def meta_like(t: torch.Tensor) -> torch.Tensor:
    """A meta tensor of t's shape, strides and dtype."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


class OpCounter(TorchDispatchMode):
    """Counts the ops run while it is open (module docstring). Open it
    around one step; `record()` gives the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.hbm_bytes_tight = 0
        self.n_ops = 0
        self.collectives: Dict[str, List[int]] = {}   # name: [calls, bytes]
        self.kernel_calls: Dict[str, int] = {}
        self.kernel_flops: Dict[str, int] = {}
        self.snn_rows_assumed = False
        self._lock = threading.Lock()
        self._live: Dict[int, int] = {}    # storage key: bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._args: set = set()
        self._quiet = 0          # > 0 inside a kernel call: no op counted
        self._untracked = 0      # > 0 inside a plain version: no storage

    # ------------------------------------------------------------ storages
    def _track(self, t: torch.Tensor, nbytes: Optional[int] = None) -> int:
        """Count t's storage live until it is freed (once); returns the
        key."""
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._live:
                return key
            n = st.nbytes() if nbytes is None else nbytes
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    def arguments(self, *trees) -> None:
        """The step's inputs: live from the start, `argument_size_in_bytes`
        (a view counts its own bytes: a rank's rows of a global batch)."""
        for t in _tensors(trees):
            if t.untyped_storage()._cdata in self._live:
                continue
            self._args.add(self._track(t, _nbytes(t)))
            self.argument_bytes += _nbytes(t)

    def outputs(self, *trees) -> None:
        """The step's results: `output_size_in_bytes` counts the storages
        among them that are not arguments."""
        seen = set()
        for t in _tensors(trees):
            key = t.untyped_storage()._cdata
            if key in self._args or key in seen:
                continue
            seen.add(key)
            self.output_bytes += self._live.get(key, 0)

    # ----------------------------------------------------------- the mode
    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        view = func.is_view or packet in _VIEWS
        if not self._untracked and not view:
            ret = func._schema.returns
            for i, t in enumerate(_tensors(out)):
                if i < len(ret) and ret[i].alias_info is not None:
                    continue                      # in place: no new storage
                self._track(t)
        if self._quiet:
            return out
        self.n_ops += 1
        if packet in _DOTS:
            a = args[_DOTS[packet]]
            self.flops += 2 * out.numel() * a.shape[-1]
        if view or packet in _EMPTY:
            return out
        b = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in _tensors(out))
        self.hbm_bytes += b
        if packet not in _CASTY:
            self.hbm_bytes_tight += b
        return out

    # ------------------------------------------------------ kernel calls
    @contextlib.contextmanager
    def _kernel(self, names, cost, launch, inputs, where: str):
        self._quiet += 1
        call = _Call()
        if callable(cost):
            self._untracked += 1
            try:
                cost = cost()
            finally:
                self._untracked -= 1
        flops, nbytes = (int(c) for c in cost)
        try:
            if where == "cpu":
                self._untracked += 1
                try:
                    yield call
                finally:
                    self._untracked -= 1
                # the launch path's allocations, replayed on meta: the
                # memory the card's call takes, in place of the plain
                # version's
                self._untracked += 1
                try:            # the inputs are the call's, not new
                    like = [meta_like(t) for t in inputs]
                finally:
                    self._untracked -= 1
                mirror = _tensors(launch(*like))
                del like
                sizes = [t.untyped_storage().nbytes() for t in mirror]
                del mirror
                for t, n in zip(_tensors(call.result), sizes):
                    self._track(t, n)
            else:
                yield call
        finally:
            self._quiet -= 1
        for n in names:
            self.kernel_calls[n] = self.kernel_calls.get(n, 0) + 1
        if names:
            self.n_ops += 1
            self.flops += flops
            self.hbm_bytes += nbytes
            self.hbm_bytes_tight += nbytes
            k = names[0]
            self.kernel_flops[k] = self.kernel_flops.get(k, 0) + flops

    def _collective(self, op: str, out: torch.Tensor) -> None:
        rec = self.collectives.setdefault(COLLECTIVES[op], [0, 0])
        rec[0] += 1
        rec[1] += _nbytes(out)

    # ------------------------------------------------------------ results
    def analysis(self) -> Dict[str, float]:
        return {"flops": float(self.flops),
                "hbm_bytes": float(self.hbm_bytes),
                "hbm_bytes_tight": float(self.hbm_bytes_tight),
                "collective_bytes": float(sum(
                    b for _, b in self.collectives.values())),
                "ops": self.n_ops}

    def collective_breakdown(self) -> Dict[str, float]:
        """Result bytes by collective, under JAX's names."""
        return {n: float(b) for n, (_, b) in sorted(self.collectives.items())}

    def memory(self) -> Dict[str, int]:
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": max(0, self.peak_bytes
                                          - self.argument_bytes
                                          - self.output_bytes),
                "peak_bytes": self.peak_bytes}

    def record(self) -> dict:
        return {"analysis": self.analysis(),
                "collectives": self.collective_breakdown(),
                "collective_calls": {n: c for n, (c, _) in
                                     sorted(self.collectives.items())},
                "memory": self.memory(),
                "kernel_calls": dict(sorted(self.kernel_calls.items())),
                "kernel_flops": dict(sorted(self.kernel_flops.items())),
                "snn_rows_assumed": self.snn_rows_assumed}


class _Call:
    __slots__ = ("result",)

    def __init__(self):
        self.result = None


class _Uncounted:
    """`kernel` with no counter open: a fresh `_Call`, nothing else."""
    __slots__ = ()

    def __enter__(self):
        return _Call()

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------ the wrappers' hooks
def kernel(names: Iterable[str], cost, launch, inputs, where: str):
    """Around a kernel wrapper's call: `names` the kernels the card
    launches for it (its `launches` counters), `cost` the work of the
    function, (flops, bytes) or a function giving them (called only
    while a counter is open, uncounted: it may read the data), `launch`
    the wrapper's launch path (called on meta copies of `inputs` to
    replay its allocations when the call runs the plain version on the
    CPU), `where` "cpu", "meta" or "cuda". The caller sets the entered
    object's `result` to its outputs."""
    c = active()
    if c is None:
        return _Uncounted()
    return c._kernel(tuple(names), cost, launch, inputs, where)


def collective(op: str, out: torch.Tensor) -> None:
    """A collective of `distributed.mesh` with result `out`."""
    c = active()
    if c is not None:
        c._collective(op, out)


def live_rows(live, n: int) -> int:
    """The rows an SNN kernel reads: `live()` (a bool tensor, one entry
    a row) counted on real tensors; all `n` on meta, where no event is
    known, and the open counter records that it assumed so."""
    mask = live()
    if mask.device.type == "meta":
        c = active()
        if c is not None:
            c.snn_rows_assumed = True
        return n
    return int(mask.sum())


def where(name: str, *tensors) -> str:
    """"cpu", "meta" or "cuda": the one device type of `tensors` (every
    CUDA tensor on one card); raises ValueError otherwise."""
    devs = {t.device for t in tensors}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"meta"}:
        return "meta"
    if kinds == {"cuda"} and len(devs) == 1:
        return "cuda"
    raise ValueError(f"{name} runs on one cuda device, the cpu or meta, got "
                     f"{sorted(map(str, devs))}")


def attention_pairs(Sq: int, Sk: int, causal: bool, window, q_start: int
                    ) -> int:
    """(query, key) pairs an attention keeps: every pair without the
    causal mask; with it each query at position q_start + i sees keys up
    to its position, at most `window` of them."""
    if not causal:
        return Sq * Sk
    if not window:
        return Sq * q_start + Sq * (Sq + 1) // 2
    # rows i see min(q_start + i + 1, window) keys
    a = q_start + 1
    ramp = max(0, min(Sq, window - a + 1))      # rows below the window
    return ramp * a + ramp * (ramp - 1) // 2 + (Sq - ramp) * window
