"""Closed loop over resident lanes (`Deployment.run_lanes`), the way a
user steps many sessions at once.

Each window runs the mix's `window` steps on all `lanes` resident lanes
and returns their spikes and membranes to the host. A lane hosts one
session after another: lane l's session ends, and the lane is reset, at
every window w > 0 with (w + l) % `session_windows` == 0, so sessions
start and end in a staggered way. The windows take their schedules from a
pool of `pool` batches drawn in set-up (`drive_share` of the axons driven
a step), in an order drawn from the seed. Sessions are sampled for the
check from the seed: of the k-th sessions of the lanes, `check_lanes`
are, for every k. A sampled session's spikes and final membranes are
kept and, after the window, compared with the reference run over the
same schedules from V = 0 under the lane's stream.

With trace 1 the measured window is followed by `trace_windows` more
windows under the profiler, whose spikes feed the work count.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.counts import snn_step
from perfbench.harness import check, setup, trace, traffic

ORDER = 1 << 16         # windows before the pool order repeats
MAX_SESSIONS = 1 << 12  # sessions a lane can host in a run


class LaneLoop:
    def __init__(self, dep, pool, order, sampled, K):
        self.dep, self.pool, self.order = dep, pool, order
        self.sampled, self.K = sampled, K
        self.B, self.T = pool.shape[1], pool.shape[2]
        self.lanes = list(range(self.B))
        self.session = np.zeros(self.B, np.int64)
        self.open = [None] * self.B
        self.samples, self.windows = [], 0
        for lane in self.lanes:
            self._start(lane)

    def _start(self, lane: int) -> None:
        k = int(self.session[lane])
        s = None
        if k < self.sampled.shape[1] and self.sampled[lane, k]:
            s = check.Sample(lane=lane, seed=0, counts=[])
            self.samples.append(s)
        self.open[lane] = s

    def window(self):
        """One run_lanes window; returns (schedule, spikes)."""
        w = self.windows
        ends = [lane for lane in self.lanes if w and (w + lane) % self.K == 0]
        if ends:
            self.dep.reset(lanes=ends)
            for lane in ends:
                self.session[lane] += 1
                self._start(lane)
        b = int(self.order[w % len(self.order)])
        sched = self.pool[b]
        with record_function("bench.run_lanes"):
            spikes, V = self.dep.run_lanes(self.lanes, sched)
        for lane, s in enumerate(self.open):
            if s is not None:
                s.counts.append(b)
                s.packed.append(check.pack(spikes[lane]))
                s.membrane = V[lane].copy()
        self.windows += 1
        return sched, spikes

    def finish_samples(self):
        """Each sampled session's schedule, from its windows' batches."""
        for s in self.samples:
            s.counts = np.concatenate([self.pool[b][s.lane]
                                       for b in s.counts])
        return self.samples


def sample_sessions(rng, B: int, c: int) -> np.ndarray:
    """(B, MAX_SESSIONS) flags, from the seed: of the k-th sessions of
    the B lanes, c are compared, for every k."""
    pick = np.argsort(rng.random((MAX_SESSIONS, B)), axis=1)[:, :c]
    flags = np.zeros((MAX_SESSIONS, B), bool)
    np.put_along_axis(flags, pick, True, axis=1)
    return flags.T


def run(ctx) -> dict:
    tr = ctx.traffic
    B, T, K = int(tr["lanes"]), int(tr["window"]), int(tr["session_windows"])
    up = setup.bring_up(ctx)
    dep, r, rng = up.dep, up.readings, up.rng
    A = up.net.n_axons
    pool = traffic.drive(rng, int(tr["pool"]) * B, T, A, tr["drive_share"]) \
        .reshape(int(tr["pool"]), B, T, A)
    order = rng.integers(0, pool.shape[0], ORDER)
    sampled = sample_sessions(rng, B, int(tr["check_lanes"]))
    # warm-up: the cell's one shape on scratch entries (no lane state)
    for i in range(2):
        dep.run_lanes([-1] * B, pool[i % pool.shape[0]],
                      seeds=list(range(B)))
    setup.sync(ctx.device)
    r.setup_s = time.perf_counter() - ctx.t_start
    loop = LaneLoop(dep, pool, order, sampled, K)
    from repro_torch.analysis import no_retrace
    with no_retrace(dep.impl):
        t0 = t = time.perf_counter()
        ends = []
        while True:
            loop.window()
            ends.append(time.perf_counter())
            if ctx.max_windows and loop.windows >= ctx.max_windows:
                break
            if not ctx.max_windows and ends[-1] - t0 >= ctx.seconds:
                break
        r.window_s = ends[-1] - t0
        r.steps = loop.windows * T
        r.lane_steps = r.steps * B
        took = np.diff(np.concatenate([[t], ends])) * 1e3
        print(f"window {r.window_s} s: {loop.windows} windows of {B} lanes "
              f"x {T} steps, {r.lane_steps / r.window_s} lane-steps/s; "
              f"ms a window min {took.min()} p50 {np.median(took)} p90 "
              f"{np.quantile(took, 0.9)} max {took.max()}; set-up "
              f"{r.setup_s} s", file=sys.stderr, flush=True)
        if ctx.trace:
            kept = []
            r.trace = trace.TraceReading()
            with trace.traced(r.trace):
                for _ in range(int(tr["trace_windows"])):
                    kept.append(loop.window())
            r.trace.steps = len(kept) * T
            r.work = snn_step.StepWork()
            deg = snn_step.out_degree(up.net)
            for sched, spikes in kept:
                r.work.add(deg, sched, spikes)
            del kept
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(ctx.device).type == "cuda" else 0
    return {"readings": r, "net": up.net, "dep_seed": up.dep_seed,
            "samples": loop.finish_samples(),
            "min_checked": int(tr["min_checked"]), "checks": {},
            "attempted": loop.windows * B, "failed": 0,
            "memory_peak_bytes": peak}
