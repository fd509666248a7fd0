"""Distributed SNN with hierarchical HiAER routing on the PyTorch port —
the twin of `examples/hiaer_scale_snn.py`: a small live run of the
pod-scale step (`repro_torch.core.distributed_engine`), then a network
on the mesh tier (`CRI_network(backend="mesh")`) with its per-level
traffic.

    PYTHONPATH=src python examples/torch_hiaer_scale_snn.py        # card
    PYTHONPATH=src python examples/torch_hiaer_scale_snn.py --device cpu

World size 1 is the default: one rank holds every shard. Under
`torchrun` every rank runs this same script, and the shards spread over
the ranks (NCCL when each rank has a card of its own, gloo when the ranks
share one card or run on the CPU):

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/torch_hiaer_scale_snn.py --device cpu
"""
import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import CRI_network, Hierarchy, LIF_neuron, NetworkSpec
from repro_torch.core import prng
from repro_torch.core.distributed_engine import SNNShardConfig, make_snn_step
from repro_torch.distributed import mesh
from repro_torch.launch.mesh import make_mesh


def pod_step_demo(device) -> None:
    """The JAX example's network: 4,096 neurons, a 256-wide window, on a
    (data 1, model world) mesh; rank r runs its 4,096 / world neurons."""
    rank, world = mesh.world()
    cfg = SNNShardConfig(n_neurons=4096, avg_fan_in=128,
                         fan_window_blocks=2)
    m = make_mesh((1, world), ("data", "model")) if world > 1 else None
    n_loc = cfg.n_neurons // world
    rng = np.random.default_rng(0)
    glob = {"V": rng.integers(0, 200, cfg.n_neurons).astype(np.int32),
            "theta": rng.integers(200, 2500, cfg.n_neurons)
            .astype(np.int32),
            "lam": np.full(cfg.n_neurons, 4, np.int32),
            "weights": rng.integers(-35, 60, (cfg.window, cfg.n_neurons))
            .astype(np.int16),
            "spikes": rng.random(cfg.n_neurons) < 0.05}
    sl = slice(rank * n_loc, (rank + 1) * n_loc)
    state = {k: torch.as_tensor(v[..., sl].copy(), device=device)
             for k, v in glob.items()}
    step = make_snn_step(cfg, m)
    key = prng.PRNGKey(0, device=device)
    for t in range(10):
        state = step(state, prng.fold_in(key, t))
        fired = state["spikes"].sum().to(torch.int64)
        absV = state["V"].abs().sum().to(torch.int64)
        if world > 1:
            both = mesh.all_gather(torch.stack([fired, absV])[None])
            fired, absV = both.sum(0)
        if rank == 0:
            print(f"t={t}: spike rate {int(fired) / cfg.n_neurons:.4f}, "
                  f"mean |V| {int(absV) / cfg.n_neurons:.1f}")


def mesh_tier_demo(device) -> None:
    """A random network over Hierarchy(2, 2, 2, 64) (8 cores, every
    interconnect level) on the mesh tier: each rank holds its cores."""
    rng = np.random.default_rng(1)
    spec = NetworkSpec()
    ax = spec.add_axons(16)
    nid = spec.add_neurons(400, LIF_neuron(threshold=6, nu=-32, lam=40))
    pre = np.concatenate([np.repeat(ax, 20), np.repeat(nid, 8)])
    spec.connect(pre, rng.integers(0, 400, pre.size),
                 rng.integers(-3, 8, pre.size))
    spec.set_outputs(list(range(8)))
    net = CRI_network.from_spec(spec, backend="mesh", device=device,
                                hierarchy=Hierarchy(2, 2, 2, 64))
    counts = rng.integers(0, 2, (20, 16)).astype(np.int32)
    fired = net.run(counts)            # output keys fired, each step
    impl = net._impl
    if mesh.world()[0] == 0:
        print(f"mesh tier: {impl.n_devices} device(s) x "
              f"{impl.cores_per_device} core(s), {len(impl._stages)} "
              f"collective stage(s); {sum(map(len, fired))} output spikes "
              f"in 20 steps; events by level (local, noc, firefly, "
              f"ethernet) {list(net.counter.level_events)}; "
              f"{impl.exchange_bytes_per_step()} wire bytes a step a "
              f"device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the shards run (default: the card; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    started = "RANK" in os.environ and not dist.is_initialized()
    if started:                         # torchrun: env:// rendezvous
        own = args.device == "cuda" and torch.cuda.device_count() >= int(
            os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        dist.init_process_group("nccl" if own else "gloo")
    device = mesh.rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    pod_step_demo(device)
    mesh_tier_demo(device)
    if mesh.world()[0] == 0:
        print("OK — the paper's full platform is 160M neurons / 40B "
              "synapses: 625,000 neurons a device over 256 devices")
    if started:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
