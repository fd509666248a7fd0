"""The device trace of a traced slice: `torch.profiler` over the CPU (all
threads) and the card, read from its raw events.

* busy_s: the union of the device operations' intervals (kernels,
  copies, sets; not the host spans the profiler mirrors onto the card's
  timeline) — the arithmetic of `chip_smoke.profile_window`'s busy
  share, taken as a union so that overlapping operations count once;
* window_s: the slice's length on the host clock;
* device_ops: device seconds and count by operation name;
* idle gaps: every stretch of the window with no device operation,
  named by what the host was doing at its middle: the innermost
  benchmark span (`bench.*`) and the innermost other CPU operation that
  cover it, or "no host op" where none does.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

LABELLED_GAPS = 4000        # longest gaps named one by one; the rest pooled
TOP = 10                    # entries of each breakdown list
NAME_CHARS = 160


@dataclass
class TraceReading:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_events: int = 0
    device_ops: dict = field(default_factory=dict)   # name -> [s, count]
    idle_gaps: dict = field(default_factory=dict)    # label -> s
    steps: int = 0              # batched steps run in the slice

    def device_seconds(self, *names) -> float:
        """Device seconds of the operations whose name holds any of
        `names`."""
        return sum(s for op, (s, _) in self.device_ops.items()
                   if any(n in op for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k[:NAME_CHARS], v[0]] for k, v in ops[:TOP]],
                "idle_gaps": [[k[:NAME_CHARS], v] for k, v in gaps[:TOP]]}


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=acts, experimental_config=
                       _ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=acts)


@contextmanager
def traced(reading: TraceReading):
    """Profile the block; fill `reading` when it ends. The block ends
    with the device idle (a host read or a synchronize)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with _profiler() as prof:
        t0 = time.time_ns()
        yield reading
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
    read_events(prof.profiler.kineto_results.events(), t0, t1, reading)


def _union(starts, ends):
    """Merged intervals of sorted-by-start (starts, ends)."""
    out_s, out_e = [], []
    for s, e in zip(starts.tolist(), ends.tolist()):
        if out_e and s <= out_e[-1]:
            out_e[-1] = max(out_e[-1], e)
        else:
            out_s.append(s)
            out_e.append(e)
    return np.asarray(out_s, np.int64), np.asarray(out_e, np.int64)


def _innermost(starts, ends, names, t, limit=400):
    """The name of the covering interval with the latest start (events
    sorted by start), or None."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - limit, -1), -1):
        if ends[j] > t:
            return names[j]
    return None


def _annotation(e) -> bool:
    """Whether a device-side event is a host span mirrored onto the
    card's timeline (a `record_function` range), not device work."""
    if e.name().startswith("bench."):
        return True
    flag = getattr(e, "is_user_annotation", None)     # newer torch only
    return bool(flag and flag())


def read_events(events, t0: int, t1: int, reading: TraceReading) -> None:
    """Fill `reading` from kineto events within [t0, t1] (ns)."""
    dev, cpu, bench = [], [], []
    for e in events:
        s = e.start_ns()
        d = e.duration_ns()
        if s + d < t0 or s > t1:
            continue
        kind = e.device_type()
        if kind == torch.autograd.DeviceType.CUDA:
            if _annotation(e):
                continue
            dev.append((max(s, t0), min(s + d, t1), e.name()))
        elif kind == torch.autograd.DeviceType.CPU:
            (bench if e.name().startswith("bench.") else cpu).append(
                (s, s + d, e.name()))
    reading.window_s = (t1 - t0) / 1e9
    reading.device_events = len(dev)
    ops = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        ops[name][0] += (e - s) / 1e9
        ops[name][1] += 1
    reading.device_ops = dict(ops)
    dev.sort()
    ds = np.asarray([d[0] for d in dev], np.int64)
    de = np.asarray([d[1] for d in dev], np.int64)
    us, ue = _union(ds, de)
    reading.busy_s = float((ue - us).sum()) / 1e9
    # idle gaps: the window's stretches outside the union
    gs = np.concatenate([[t0], ue])
    ge = np.concatenate([us, [t1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    order = np.argsort(gs - ge)          # longest first
    lists = []
    for evs in (bench, cpu):
        evs.sort()
        lists.append((np.asarray([x[0] for x in evs], np.int64),
                      np.asarray([x[1] for x in evs], np.int64),
                      [x[2] for x in evs]))
    gaps = defaultdict(float)
    for rank, g in enumerate(order):
        length = (ge[g] - gs[g]) / 1e9
        if rank >= LABELLED_GAPS:
            gaps["shorter gaps"] += length
            continue
        mid = (gs[g] + ge[g]) // 2
        names = [_innermost(*lst, mid) for lst in lists]
        label = " > ".join(n for n in names if n) or "no host op"
        gaps[label] += length
    reading.idle_gaps = dict(gaps)
