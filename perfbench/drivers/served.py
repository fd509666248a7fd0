"""Open loop through the program's `SpikeServer`, as independent users of
the portal's `/v1/{model}/run` send: every request is a stateless window
of the mix's `window` steps from V = 0 under its own seed.

Requests are due at the arrival times of a Poisson stream at `rate`
requests a second (`traffic.arrival_offsets`: every seed sends the same
number with the same gaps, in its own order). The main thread sends each
when it is due; a request's latency runs from when it was due to when its
result reached the client (the future's callback), so a stall that delays
later sends counts. A request that fails or is refused counts as over
any limit. Requests are sampled for the check from the seed
(`check_share`) and compared with the reference run alone.

At the close, a mix below the server's capacity waits for every answer
(a minute past the close at most; one that never comes is over any
limit). A mix above it (`cancel_at_close`) sends nothing more and shuts
the server down: the batch in flight finishes, and the backlog that
grew all through the window is cancelled unserved; the check samples
the requests that the server finished.

With trace 1 the stream runs on for `trace_seconds` under the profiler
after the measured window, on its own schedule from the profiler's
start.
"""
from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import CancelledError
from functools import partial

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import check, setup, trace, traffic

MODEL = "snn"
ANSWER_GRACE_S = 60.0       # a result may come this late past the close


class Client:
    """Sends requests i in [lo, hi) when due; records every answer."""

    def __init__(self, srv, pool, idx, seeds, flags):
        n = idx.shape[0]
        self.srv, self.pool, self.idx, self.seeds = srv, pool, idx, seeds
        self.flags = flags
        self.arrive = np.full(n, np.inf)
        self.late = np.zeros(n)
        self.dispatch_ms = np.full(n, np.nan)
        self.queue_ms = np.full(n, np.nan)
        self.batch = np.zeros(n, int)
        self.failed = np.zeros(n, bool)
        self.cancelled = np.zeros(n, bool)
        self.kept = {}
        self._lock = threading.Lock()
        self._done = 0
        self._all = threading.Event()
        self._want = 0

    def _answer(self, fut, i: int) -> None:
        t = time.perf_counter()
        try:
            res = fut.result()
        except CancelledError:      # the backlog, cancelled at the close
            self.cancelled[i] = True
        except Exception:           # noqa: BLE001 — a failed request
            self.failed[i] = True
        else:
            self.arrive[i] = t
            self.dispatch_ms[i] = res.dispatch_ms
            self.queue_ms[i] = res.queue_wait_ms
            self.batch[i] = res.batch_size
            if self.flags[i]:
                self.kept[i] = (check.pack(res.spikes),
                                np.array(res.membrane))
        self._count()

    def _count(self) -> None:
        with self._lock:
            self._done += 1
            if self._done >= self._want:
                self._all.set()

    def send(self, t0: float, due, lo: int, hi: int) -> None:
        with self._lock:
            self._want = hi
            self._all.clear()
            if self._done >= hi:
                self._all.set()
        for i in range(lo, hi):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.late[i] = time.perf_counter() - t0 - due[i]
            try:
                with record_function("bench.submit"):
                    fut = self.srv.submit(MODEL, self.pool[self.idx[i]],
                                          seed=int(self.seeds[i]))
            except Exception:       # noqa: BLE001 — a refused request
                self.failed[i] = True
                self._count()
                continue
            fut.add_done_callback(partial(self._answer, i=i))

    def wait(self, deadline: float) -> None:
        self._all.wait(max(deadline - time.perf_counter(), 0.0))


def open_server(ctx):
    """Set-up of a served run: the deployment, its traffic pool, every
    batch bucket the server can form warmed up on scratch entries, the
    server started and its first request answered. Returns (up, pool,
    srv); the caller shuts the server down."""
    from repro_torch.serve import SpikeServer
    tr = ctx.traffic
    T, max_batch = int(tr["window"]), int(tr["max_batch"])
    up = setup.bring_up(ctx)
    dep = up.dep
    pool = traffic.drive(up.rng, int(tr["pool"]), T, up.net.n_axons,
                         tr["drive_share"])
    b = 1
    while b <= max_batch:
        dep.run_lanes([-1] * b, pool[np.arange(b) % pool.shape[0]],
                      seeds=list(range(b)))
        b *= 2
    srv = SpikeServer(max_batch=max_batch, max_wait_ms=tr["max_wait_ms"])
    srv.add_model(MODEL, deployment=dep, window=T, n_sessions=1)
    srv.start()
    srv.submit(MODEL, pool[0], seed=0).result(timeout=600)
    setup.sync(ctx.device)
    return up, pool, srv


def requests(rng, pool, rate: float, seconds: float, share: float):
    """One stream's (due offsets, pool index, seed, sampled flag) of
    every request, from the seed."""
    due = traffic.arrival_offsets(rng, rate, seconds)
    n = due.shape[0]
    return (due, rng.integers(0, pool.shape[0], n),
            rng.integers(0, 2 ** 31 - 1, n),
            check.sample_flags(rng, n, share))


def run(ctx) -> dict:
    from repro_torch.analysis import no_retrace
    tr = ctx.traffic
    rate = float(tr["rate"])
    cancel = bool(tr.get("cancel_at_close", False))
    up, pool, srv = open_server(ctx)
    dep, r = up.dep, up.readings
    extra = float(tr["trace_seconds"]) if ctx.trace else 0.0
    due, idx, seeds, flags = requests(up.rng, pool, rate,
                                      ctx.seconds + extra,
                                      tr["check_share"])
    n = due.shape[0]
    n_win = int(np.searchsorted(due, ctx.seconds)) if extra else n
    client = Client(srv, pool, idx, seeds, flags)
    try:
        r.setup_s = time.perf_counter() - ctx.t_start
        with no_retrace(dep.impl):
            t0 = time.perf_counter()
            client.send(t0, due, 0, n_win)
            if extra:
                r.trace = trace.TraceReading()
                with trace.traced(r.trace):
                    # the slice keeps its own schedule from when the
                    # profiler is up: its first request is due now
                    t1 = time.perf_counter() - due[n_win]
                    client.send(t1, due, n_win, n)
                    if not cancel:
                        client.wait(t1 + due[-1] + ANSWER_GRACE_S)
            if not cancel:
                client.wait(t0 + ctx.seconds + ANSWER_GRACE_S)
    finally:
        srv.shutdown(drain=False)
    lat = (client.arrive[:n_win] - t0 - due[:n_win]) * 1e3
    lat[client.failed[:n_win]] = np.inf
    r.latencies_ms = lat[~client.cancelled[:n_win]]
    r.window_s = ctx.seconds
    r.answered = int((client.arrive[:n_win] <= t0 + ctx.seconds).sum())
    disp = client.dispatch_ms[:n_win]
    r.spans["dispatch_ms"] = np.unique(disp[np.isfinite(disp)]).tolist()
    q = client.queue_ms[:n_win]
    r.spans["queue_wait_ms"] = q[np.isfinite(q)].tolist()
    late = client.late[:n_win]
    second = np.floor(due[:n_win]).astype(int)
    kept = ~client.cancelled[:n_win]
    by_second = [round(float(np.percentile(lat[(second == k) & kept], 95)),
                       1) for k in np.unique(second[kept])]
    done = client.batch[:n_win] > 0
    print(f"sender lateness ms p50 {np.median(late) * 1e3} p99 "
          f"{np.quantile(late, 0.99) * 1e3} max {late.max() * 1e3}; "
          f"{n_win} requests at {rate} a second over {ctx.seconds} s, "
          f"{r.answered} answered in the window, "
          f"{int(client.cancelled[:n_win].sum())} cancelled at the close; "
          f"dispatch ms median {np.median(r.spans['dispatch_ms'])}, "
          f"batch mean {client.batch[:n_win][done].mean()}; "
          f"p95 ms of each second's requests {by_second}",
          file=sys.stderr, flush=True)
    failed = int((~np.isfinite(lat) & ~client.cancelled[:n_win]).sum())
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(ctx.device).type == "cuda" else 0
    samples = [check.Sample(lane=-1, seed=int(seeds[i]),
                            counts=pool[idx[i]], packed=[p], membrane=V)
               for i, (p, V) in sorted(client.kept.items())]
    # a sampled request that never answered (and was not cancelled at
    # the close) is a mismatch of every bit
    missing = [i for i in np.flatnonzero(flags)
               if i not in client.kept and not client.cancelled[i]]
    return {"readings": r, "net": up.net, "dep_seed": up.dep_seed,
            "samples": samples, "min_checked": int(tr["min_checked"]),
            "checks": {"sampled_unanswered": {
                "value": len(missing), "limit": 0, "op": "<="}},
            "attempted": n_win, "failed": failed,
            "memory_peak_bytes": peak}


def sweep(ctx, rates, seconds: float) -> list:
    """The served cell's load sweep, once on the card when the cell's
    rate is chosen: one set-up, then an open-loop stream of `seconds` at
    each rate in turn. Returns a row a rate: requests, failed, latency
    percentiles (ms, from when each was due), completions a second, the
    median latency of the last quarter of requests over the first
    quarter's (a backlog that grows reads well above 1), and the
    sender's p99 lateness (ms)."""
    up, pool, srv = open_server(ctx)
    rows = []
    try:
        for rate in rates:
            due, idx, seeds, flags = requests(up.rng, pool, float(rate),
                                              seconds, 0.0)
            n = due.shape[0]
            client = Client(srv, pool, idx, seeds, flags)
            t0 = time.perf_counter()
            client.send(t0, due, 0, n)
            client.wait(t0 + seconds + ANSWER_GRACE_S)
            lat = (client.arrive - t0 - due) * 1e3
            ok = np.isfinite(lat)
            q = max(n // 4, 1)
            second = np.floor(due).astype(int)
            rows.append({
                "rate": float(rate), "requests": n,
                "p95_by_second": [
                    round(float(np.percentile(lat[second == k], 95)), 1)
                    for k in np.unique(second)],
                "failed": int((~ok).sum()),
                "p50_ms": float(np.median(lat[ok])),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "max_ms": float(lat.max()),
                "completed_per_s": float(ok.sum() / (
                    client.arrive[ok].max() - t0)),
                "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
                "late_p99_ms": float(np.quantile(client.late, 0.99) * 1e3),
            })
            print(rows[-1], file=sys.stderr, flush=True)
    finally:
        srv.shutdown(drain=False)
    return rows
