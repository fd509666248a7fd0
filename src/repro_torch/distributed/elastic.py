"""Elastic scaling and straggler mitigation — the port of
`repro/distributed/elastic.py`.

The node-failure story:
  1. a heartbeat/watchdog detects the failure (`StepWatchdog` below at
     step granularity; the cluster agent at process granularity);
  2. surviving hosts rebuild a smaller mesh (drop the failed pod or data
     row: mesh shapes stay rectangular);
  3. the latest checkpoint is restored onto the new mesh: `reshard_tree`
     re-derives each leaf's block from the same `ShardingRules` against
     the new mesh and puts it on the rank's device — no dependence on the
     old layout (checkpoints store global arrays or shards that
     reassemble);
  4. the data pipeline's cursor (in the checkpoint's aux) resumes
     exactly.

`StepWatchdog` also flags stragglers: a step longer than `factor` times
the rolling median of the last `window` steps (once 8 are known); after
`patience` flags in a row the runner is told to evict. The clock is a
parameter (`time.monotonic` by default), so tests drive it without
sleeping.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import torch

from repro_torch.launch.sharding import ShardingRules, local_slice


def reshard_tree(host_tree, cfg, new_mesh, kind: str = "params",
                 layout: str = "heads", device=None):
    """This rank's blocks of a restored host tree under `new_mesh`, on
    the rank's `device` (`distributed.mesh.rank_device`: the card unless
    "cpu" is asked for). `kind` "params": a state dict {name: tensor};
    "opt": the AdamW state {"mu", "nu", "step"}. The blocks are the ones
    the port holds (`ShardingRules.held_spec` and `held_moment_spec`):
    on a mesh whose model axis has size 1 a TP config's are the rules'
    own."""
    from repro_torch.distributed.mesh import rank_device
    rules = ShardingRules(cfg, new_mesh, layout)
    dev = rank_device(device)
    if kind == "params":
        specs = rules.held_params_specs(host_tree)
    elif kind == "opt":
        specs = rules.held_opt_specs(host_tree["mu"])
    else:
        raise ValueError(kind)

    def put(tree, spec):
        if isinstance(tree, dict):
            return {k: put(v, spec[k]) for k, v in tree.items()}
        t = torch.as_tensor(tree)
        return t[local_slice(spec, t.shape, new_mesh)].to(
            dev, copy=True).contiguous()
    return put(host_tree, specs)


class StepWatchdog:
    def __init__(self, factor: float = 3.0, patience: int = 3,
                 window: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.factor = factor
        self.patience = patience
        self.times = deque(maxlen=window)
        self.strikes = 0
        self.clock = clock
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = self.clock()

    def stop(self) -> dict:
        dt = self.clock() - self._t0
        med = sorted(self.times)[len(self.times) // 2] if self.times else dt
        straggling = len(self.times) >= 8 and dt > self.factor * med
        self.strikes = self.strikes + 1 if straggling else 0
        self.times.append(dt)
        return {"step_s": dt, "median_s": med, "straggler": straggling,
                "evict": self.strikes >= self.patience}
