"""Straggler detection for the training loop — a copy of `StepWatchdog`
from `repro/distributed/elastic.py` (whose module imports jax through
its resharding half; `reshard_tree` waits for the port's distribution
slice).

A step longer than `factor` times the rolling median of the last
`window` steps (once 8 are known) is flagged as a straggler; after
`patience` flags in a row the runner is told to evict. The clock is a
parameter (`time.monotonic` by default), so tests drive it without
sleeping.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional


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
