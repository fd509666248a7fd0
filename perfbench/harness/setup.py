"""A run's set-up on the program: the network from the seed, the host
compile, the deployment. Returns what the drivers share."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from perfbench.harness import network, traffic


@dataclass
class Readings:
    """What a run read, for the metric readers (`perfbench/metrics/`).
    A reader returns None where its reading is missing."""
    setup_s: float = None
    window_s: float = None          # the measured window, host clock
    steps: int = 0                  # batched steps in the window
    lane_steps: int = 0             # (lane, step) pairs in the window
    latencies_ms: list = None       # every request's, inf if it failed
    answered: int = 0               # requests answered within the window
    host: dict = field(default_factory=dict)    # compile_s, deploy_s
    spans: dict = field(default_factory=dict)   # the program's spans
    trace: object = None            # trace.TraceReading of the slice
    work: object = None             # counts.snn_step.StepWork of it


@dataclass
class Up:
    net: object
    dep: object
    dep_seed: int
    rng: object
    readings: Readings


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bring_up(ctx) -> Up:
    """Network from the seed, `compile_spec`, `deploy`; the host clock
    around the compile and the deployment."""
    from repro_torch import compile_spec, deploy
    cfg = ctx.config
    net_seed, dep_seed, rng = traffic.seeds(ctx.seed)
    net = network.make(cfg, net_seed)
    spec = network.to_spec(net, int(cfg["threshold"]))
    r = Readings()
    t0 = time.perf_counter()
    compiled = compile_spec(spec, **network.compile_args(cfg))
    r.host["compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dep = deploy(compiled, seed=dep_seed, fused=bool(cfg.get("fused")),
                 packed=bool(cfg.get("packed", True)), device=ctx.device)
    dep.alloc_lanes(int(ctx.traffic.get("lanes", 1)))
    sync(ctx.device)
    r.host["deploy_s"] = time.perf_counter() - t0
    return Up(net, dep, dep_seed, rng, r)
