"""Pod-scale SNN execution with hierarchical HiAER spike routing (the twin
of `repro.core.distributed_engine`).

The paper's scaling story over a world of ranks, one rank per device:
160 M neurons / 40 B synapses sharded over the port's `Mesh`
(`distributed.context`) with named axes, spike vectors multicast level
by level (Fig. 1b):

  'model' dim = 32 cores within an FPGA  -> NoC        (fastest, first)
  'data'  dim = 8 FPGA boards per server -> FireFly
  'pod'   dim = servers                  -> Ethernet   (slowest, last)

Each rank owns n_loc consecutive postsynaptic neurons and their synapse
stripe, a (W, n_loc) int16 block over a W-wide presynaptic window
(`fan_window_blocks` x `block`: the locality the partitioner [10]
optimizes for). One step on a rank:

    u       = randint(key, n_loc)             # the same key on every rank
    bits    = all-gather of spikes_prev, model dim first, then data, pod
    win     = bits[base : base + W],  base = min(lin * n_loc, n_glob - W)
    syn     = spike_matmul(win, weights)      # kernel 3, int32 wrapping
    V, spk  = lif_step(V, syn, u, theta, -32, lam, LIF)   # kernel 1

The wire is the shared packed format of `kernels.exchange` (32-bit
presence words) when every shard's bit count is word-aligned (n_loc % 32
== 0), and the dense bool vector otherwise, as in the JAX package. At
the paper's own share (160 M / 256 = 625,000 a device, 625,000 % 32 ==
8) that is the dense wire. The noise copies the JAX package exactly:
every shard draws its n_loc uniforms from the same replicated key (with
nu = -32 they shift to 0).

`make_snn_step(cfg, mesh)` takes a mesh over the world that the caller
started (`launch.mesh.make_mesh`; on one card that is the gloo world,
NCCL refusing two ranks on one card), or a shape-only mesh (`Mesh(shape,
names, rank=r)`), on which rank r's step runs on meta tensors (the
dry-run, `launch.dryrun`: every gather gives its output's shape and
nothing is sent); `mesh=None` is a world of one rank. `snn_shardings`
gives the specs of the state's blocks (`launch.sharding.local_slice`
cuts a rank's block). `small_reference_step` is the plain single-device
oracle, and with `base` the plain version of one rank's step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.core import neuron as nrn
from repro_torch.kernels import exchange as exch_k
from repro_torch.kernels.lif_step import lif_step
from repro_torch.kernels.ref import spike_matmul_ref
from repro_torch.kernels.spike_matmul import spike_matmul

AXES = ("pod", "data", "model")     # slowest to fastest


@dataclass(frozen=True)
class SNNShardConfig:
    n_neurons: int = 160_000_000
    avg_fan_in: int = 250            # 40e9 / 160e6
    block: int = 128
    # synapses stored as (n_blocks_in, block, n_loc) int16 stripes where
    # n_blocks_in = ceil(fan_in_window / block): each neuron's inputs come
    # from a bounded window of presynaptic blocks
    fan_window_blocks: int = 4       # 4*128 = 512-wide presynaptic window

    @property
    def n_synapses(self) -> int:
        return self.n_neurons * self.avg_fan_in

    @property
    def window(self) -> int:
        return self.fan_window_blocks * self.block


class ShapeDtype(NamedTuple):
    """A global array's shape and dtype (no allocation)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _axes(mesh) -> List[Tuple[str, int]]:
    """(name, size) of the mesh's axes among AXES, slowest first."""
    if mesh is None:
        return []
    return [(a, mesh.shape[a]) for a in AXES if a in mesh.axis_names]


def snn_state_shapes(cfg: SNNShardConfig, mesh) -> Dict[str, ShapeDtype]:
    """The global state's shapes and dtypes (no allocation): each of the
    mesh's ranks holds its n_loc = n_neurons / ranks slice of every
    vector and the (W, n_loc) column block of the weights."""
    N, W = cfg.n_neurons, cfg.window
    return {
        "V": ShapeDtype((N,), torch.int32),
        "theta": ShapeDtype((N,), torch.int32),
        "lam": ShapeDtype((N,), torch.int32),
        "weights": ShapeDtype((W, N), torch.int16),
        "spikes": ShapeDtype((N,), torch.bool),
    }


def snn_shardings(cfg: SNNShardConfig, mesh) -> Dict[str, tuple]:
    """The state's specs (`launch.sharding`'s tuples): every vector over
    all the mesh's axes, the weights' columns likewise (JAX's
    `snn_shardings`)."""
    axes = tuple(a for a, _ in _axes(mesh))
    vec = (axes,)
    return {"V": vec, "theta": vec, "lam": vec, "spikes": vec,
            "weights": (None, axes)}


def make_snn_step(cfg: SNNShardConfig, mesh=None):
    """One simulation timestep at pod scale, on this rank's shard.

    state: {"V", "theta", "lam": (n_loc,) int32, "spikes": (n_loc,) bool,
    "weights": (W, n_loc) int16} on the rank's device; key: (2,) int64
    words (`core.prng`), the same on every rank. Returns the state with
    V and spikes advanced. Every rank of the mesh calls it together."""
    axes = [a for a, _ in _axes(mesh)]
    lin = mesh.index(tuple(axes)) if axes else 0
    W = cfg.window

    def step(state, key):
        V, theta, lam = state["V"], state["theta"], state["lam"]
        spikes_prev = state["spikes"]
        n_loc = V.shape[0]
        u = nrn.noise_draw(key, n_loc)
        # HiAER multicast, fast dim first (NoC -> FireFly -> Ethernet):
        # 32-bit presence words when every shard's bits fill whole
        # words, else the dense bool vector
        if n_loc % exch_k.PACK_BITS == 0:
            words = exch_k.pack_events(spikes_prev)
            for a in reversed(axes):
                words = mesh.all_gather(words, a)
            bits = exch_k.unpack_events(
                words, words.shape[0] * exch_k.PACK_BITS)
        else:
            bits = spikes_prev
            for a in reversed(axes):
                bits = mesh.all_gather(bits, a)
        base = min(lin * n_loc, bits.shape[0] - W)
        syn = spike_matmul(bits[base:base + W].contiguous(),
                           state["weights"])
        V_next, spikes = lif_step(
            V, syn, u, theta, torch.full_like(theta, -32), lam,
            torch.ones_like(spikes_prev))
        return {**state, "V": V_next, "spikes": spikes}

    return step


def small_reference_step(V, theta, lam, spikes_prev, weights, key,
                         base: int = 0):
    """Plain single-device oracle, same windowed semantics: the window
    starts at `base` of `spikes_prev` (0 on one device; a rank's
    min(lin * n_loc, n_glob - W) with the gathered global spikes)."""
    V_mid, spikes = nrn.fire_phase(V, theta, torch.full_like(theta, -32),
                                   lam, torch.ones_like(V, dtype=torch.bool),
                                   key)
    win = spikes_prev[base:base + weights.shape[0]]
    syn = spike_matmul_ref(win.to(torch.int32), weights)
    return nrn.integrate_phase(V_mid, syn), spikes
