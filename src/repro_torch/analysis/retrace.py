"""Retrace detector — the port's twin of `repro/analysis/retrace.py`.

The port has no jit cache: each run path of a backend is a Python loop
over torch ops and kernel launches, whatever the shape. What the JAX
package counts as compile-cache entries of `_jit_step`, `_jit_run`,
`_jit_run_batch` and `_jit_run_lanes` is counted here as the distinct
shapes of the counts argument each run path has run: `step` (), `run`
(T,), `run_batch` and `run_lanes` (B, T). `EventEngine`, `HiAERNetwork`
(and so `MeshNetwork`) and `DenseSimulator` log them in `run_shapes`,
one set per path, on the device path (the engine's host reference loop
of `vectorized=False` logs nothing); `lane_shapes` is `run_lanes`' set.
A shape stands for the capture a CUDA graph per window would need
(ROADMAP queue 2, item F): one per (topology, batch-shape). The serving
tier buckets batch shapes to powers of two, so a session stays within
log2(max_batch) + 1 of them however client concurrency fluctuates.

    eng = deploy(compiled, device="cpu").impl
    det = RetraceDetector.of(eng)          # finds step/run/run_batch/...
    eng.run_batch(batches)                 # first call: a new shape
    det.snapshot()
    eng.run_batch(batches)                 # same shapes: a replay
    det.assert_no_retrace()                # raises RetraceError if not

    with no_retrace(eng):                  # context-manager form — the
        eng.run_batch(batches)             # timed region of a benchmark

`compile_counts(obj)` returns the raw {(label, fn): shapes} map: it lists
`run_lanes` always and the other paths once they have run (JAX lists
every jitted function, an unrun one with 0); the serving tier's scrape
exports it as `repro_compile_count`.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Tuple

__all__ = ["RetraceError", "RetraceDetector", "no_retrace",
           "compile_counts", "jit_functions", "shape_logs"]

RUN_PATHS = ("step", "run", "run_batch", "run_lanes")


class RetraceError(RuntimeError):
    """A watched run path ran a new shape inside a no-retrace region."""


def shape_log() -> Dict[str, set]:
    """A backend's empty `run_shapes`: a set for each run path."""
    return {fn: set() for fn in RUN_PATHS}


def shape_logs(obj) -> Dict[str, set]:
    """{function name: set of shapes it has run} for a backend object
    that logs its run paths' shapes (`run_shapes`); {} for any other."""
    logs = getattr(obj, "run_shapes", None)
    return dict(logs) if isinstance(logs, dict) else {}


def jit_functions(obj) -> Dict[str, object]:
    """{name: bound method} of every run path `obj` logs: a backend's
    `step`, `run`, `run_batch` and `run_lanes`."""
    return {fn: getattr(obj, fn) for fn in shape_logs(obj)}


def compile_counts(*objects) -> Dict[Tuple[str, str], int]:
    """{(object label, function name): distinct shapes run} right now —
    "one capture per (topology, batch-shape)" is `count == number of
    distinct shapes fed`. `run_lanes` is listed always, the other paths
    once they have run."""
    return {(type(obj).__name__, fn): len(shapes)
            for obj in objects for fn, shapes in shape_logs(obj).items()
            if shapes or fn == "run_lanes"}


class RetraceDetector:
    """Snapshot/compare the shape logs of a set of run paths (every path
    of the objects, run or not)."""

    def __init__(self, logs: Dict[Tuple[str, str], set]):
        self._logs = logs
        self._base: Dict[Tuple[str, str], int] = {}
        self.snapshot()

    @classmethod
    def of(cls, *objects) -> "RetraceDetector":
        logs = {(type(obj).__name__, fn): shapes for obj in objects
                for fn, shapes in shape_logs(obj).items()}
        if not logs:
            raise ValueError(
                f"no lane-path or run-path shape logs found on "
                f"{[type(o).__name__ for o in objects]}")
        return cls(logs)

    def counts(self) -> Dict[Tuple[str, str], int]:
        return {k: len(v) for k, v in self._logs.items()}

    def snapshot(self) -> Dict[Tuple[str, str], int]:
        self._base = self.counts()
        return dict(self._base)

    def deltas(self) -> Dict[Tuple[str, str], int]:
        """Shape-log growth since the last snapshot (nonzero only)."""
        return {k: v - self._base[k] for k, v in self.counts().items()
                if v != self._base[k]}

    def assert_no_retrace(self) -> None:
        d = self.deltas()
        if d:
            grew = ", ".join(f"{label}.{name} (+{n})"
                             for (label, name), n in sorted(d.items()))
            raise RetraceError(
                f"run-path retrace detected: {grew} ran a new shape "
                f"inside a no-retrace region — a batch or window shape is "
                f"varying call-to-call")


@contextmanager
def no_retrace(*objects):
    """Assert that no watched run path runs a new shape inside the block
    (enter it with warm shapes — e.g. after the warmup run of a
    benchmark). Yields the detector for inspection."""
    det = RetraceDetector.of(*objects)
    yield det
    det.assert_no_retrace()
