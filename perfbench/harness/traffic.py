"""Traffic from the seed: spike-window schedules (frozen copy of
`chip_smoke.drive`), a pool of them drawn once in set-up, and open-loop
arrival times."""
from __future__ import annotations

import numpy as np


def drive(rng, B: int, T: int, A: int, share: float) -> np.ndarray:
    """(B, T, A) int32 schedules with `share` of the axons driven a step."""
    return (rng.random((B, T, A)) < share).astype(np.int32)


def seeds(seed: int):
    """Independent generators of one run: (network, deployment, traffic).
    The deployment seed is the program's int32 stream seed."""
    dep = int(np.random.default_rng([seed, 1]).integers(0, 2 ** 31 - 1))
    return seed, dep, np.random.default_rng([seed, 2])


def arrival_offsets(rng, rate: float, seconds: float) -> np.ndarray:
    """Open-loop due times (s from the window's start) of round(rate x
    seconds) requests: the exponential gaps of a Poisson stream at their
    quantiles, in an order drawn from the seed, so that every seed sends
    the same number of requests with the same set of gaps."""
    n = max(int(round(rate * seconds)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.cumsum(rng.permutation(gaps))
