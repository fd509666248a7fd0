"""Retrace detector — the port's twin of `repro/analysis/retrace.py`,
for the serving half of the lane path.

The port has no jit cache: `run_lanes` is a Python loop over torch ops
and kernel launches, whatever the shape. What the JAX package counts as
compile-cache entries is counted here as the distinct (B, T) shapes a
backend's lane path has run (`lane_shapes` of `EventEngine`,
`HiAERNetwork`, `MeshNetwork` and `DenseSimulator`): the number of
captures a CUDA graph per window would need (ROADMAP queue 2, item F).
The serving tier buckets
batch shapes to powers of two, so a session stays within
log2(max_batch) + 1 of them however client concurrency fluctuates.

    eng = deploy(compiled, device="cpu").impl
    det = RetraceDetector.of(eng)          # finds run_lanes
    ... serve ...
    det.assert_no_retrace()                # raises RetraceError on a
                                           # shape not seen before

`compile_counts(obj)` returns the raw {(label, fn): shapes} map; the
serving tier's scrape exports it as `repro_compile_count`.
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["RetraceError", "RetraceDetector", "compile_counts",
           "shape_logs"]


class RetraceError(RuntimeError):
    """A watched lane path ran a new shape inside a no-retrace region."""


def shape_logs(obj) -> Dict[str, set]:
    """{function name: set of shapes it has run} for a backend object
    that logs its lane-path shapes (`lane_shapes`); {} for any other."""
    shapes = getattr(obj, "lane_shapes", None)
    return {"run_lanes": shapes} if isinstance(shapes, set) else {}


def compile_counts(*objects) -> Dict[Tuple[str, str], int]:
    """{(object label, function name): distinct shapes run} right now —
    "one capture per (topology, batch-shape)" is `count == number of
    distinct shapes fed`."""
    return {(type(obj).__name__, name): len(shapes)
            for obj in objects for name, shapes in shape_logs(obj).items()}


class RetraceDetector:
    """Snapshot/compare the shape logs of a set of lane paths."""

    def __init__(self, logs: Dict[Tuple[str, str], set]):
        self._logs = logs
        self._base: Dict[Tuple[str, str], int] = {}
        self.snapshot()

    @classmethod
    def of(cls, *objects) -> "RetraceDetector":
        logs = {(type(obj).__name__, name): shapes for obj in objects
                for name, shapes in shape_logs(obj).items()}
        if not logs:
            raise ValueError(
                f"no lane-path shape logs found on "
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
                f"lane-path retrace detected: {grew} ran a new shape "
                f"inside a no-retrace region — a batch or window shape is "
                f"varying call-to-call")
