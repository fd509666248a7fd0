"""Unified metrics registry — counters, gauges, log-bucketed latency
histograms, Prometheus text exposition.

One `MetricsRegistry` per process collects every stat the stack used
to scatter across ad-hoc dicts (`SpikeServer.stats()`, `DoubleBuffer`
swap counts, per-token auth counters, `AccessCounter` level tallies,
retrace compile counts) and renders them as ONE Prometheus text
document at `GET /metrics`.

Pieces:

  * `Counter` / `Gauge` / `Histogram` — labeled metric families.
    Histograms are log-bucketed (`log_buckets`): exponentially spaced
    boundaries cover 0.25 ms .. 8 s in 16 buckets, the right shape for
    latencies spanning queue-wait microseconds to compile seconds.
  * callbacks — `registry.register_callback(fn)` runs `fn(registry)`
    at collect time, for values that live elsewhere (queue depth,
    SlotPool occupancy, jit cache entries): scrape-time gauges instead
    of write-through instrumentation on hot paths.
  * snapshots — `collect()` returns a JSON-able snapshot;
    `render_merged(snapshots)` sums counters/histograms across worker
    processes (the bridge forwards worker snapshots to the dispatcher,
    so `/metrics` answers with AGGREGATED totals, satellite-fixing the
    documented per-worker split) while per-worker breakdowns stay
    visible under a `worker` label.
  * `parse_prometheus` — a small exposition parser used by tests to
    assert the rendered text round-trips.

Stdlib-only (bridge workers import it); all mutation under one lock
per registry; disabled registries (`on=False`) short-circuit every
observation to a no-op for A/B overhead runs.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "log_buckets", "render_snapshot", "merge_snapshots",
           "snapshot_by_worker", "snapshot_with_label",
           "parse_prometheus"]


def log_buckets(lo: float = 0.25, hi: float = 8000.0,
                per_decade: Optional[int] = None,
                base: float = 2.0) -> List[float]:
    """Exponentially spaced histogram boundaries from `lo` up to at
    least `hi` (default: powers of two, 0.25 ms .. ~8 s)."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade is not None:
        base = 10.0 ** (1.0 / per_decade)
    out, v = [], float(lo)
    while v < hi * (1 + 1e-12):
        out.append(v)
        v *= base
    if out[-1] < hi:
        out.append(v)
    return out


def _label_key(labelnames: Sequence[str], labels: dict) -> Tuple:
    # hot path: build the key directly and let a KeyError signal the
    # mismatch — no per-call set allocations
    if len(labels) != len(labelnames):
        raise ValueError(f"expected labels {list(labelnames)}, "
                         f"got {sorted(labels)}")
    try:
        return tuple(str(labels[n]) for n in labelnames)
    except KeyError:
        raise ValueError(f"expected labels {list(labelnames)}, "
                         f"got {sorted(labels)}") from None


def _fmt_labels(labelnames, key, extra=()) -> str:
    parts = [f'{n}="{_escape(v)}"'
             for n, v in list(zip(labelnames, key)) + list(extra)]
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt_val(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class _Metric:
    """Common labeled-family machinery. Child values are keyed by the
    tuple of label values; unlabeled families use the empty tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional["MetricsRegistry"] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._reg = registry
        self._lock = registry._lock if registry is not None \
            else threading.Lock()

    def _on(self) -> bool:
        return self._reg is None or self._reg.on


class Counter(_Metric):
    """Monotonically increasing count. `inc(n, **labels)`."""

    kind = "counter"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._values: Dict[Tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if not self._on():
            return
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(
                _label_key(self.labelnames, labels), 0.0)

    def _samples(self):
        with self._lock:
            items = sorted(self._values.items())
        return [(self.name, self.labelnames, k, v) for k, v in items]


class Gauge(_Metric):
    """Point-in-time value. `set(v, **labels)` / `inc` / `dec`."""

    kind = "gauge"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._values: Dict[Tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        if not self._on():
            return
        with self._lock:
            self._values[_label_key(self.labelnames, labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        if not self._on():
            return
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(
                _label_key(self.labelnames, labels), 0.0)

    def _samples(self):
        with self._lock:
            items = sorted(self._values.items())
        return [(self.name, self.labelnames, k, v) for k, v in items]


class Histogram(_Metric):
    """Log-bucketed distribution. `observe(v, **labels)` adds one
    sample; exposition renders cumulative `_bucket{le=...}` series plus
    `_sum`/`_count` (standard Prometheus histogram semantics, so rate()
    + histogram_quantile() work). `quantile(q)` gives a bucket-resolved
    estimate for in-process assertions (upper bound of the bucket the
    q-th sample falls in)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), registry=None,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames, registry)
        bs = list(buckets) if buckets is not None else log_buckets()
        if sorted(bs) != bs or len(set(bs)) != len(bs):
            raise ValueError("histogram buckets must be strictly "
                             "increasing")
        self.buckets = [float(b) for b in bs]
        self._counts: Dict[Tuple, List[int]] = {}
        self._sum: Dict[Tuple, float] = {}
        self._n: Dict[Tuple, int] = {}

    def _bucket_index(self, v: float) -> int:
        """Index of the first boundary >= v (len(buckets) = +Inf)."""
        return bisect_left(self.buckets, v)

    def observe(self, v: float, **labels) -> None:
        if not self._on():
            return
        v = float(v)
        key = _label_key(self.labelnames, labels)
        i = self._bucket_index(v)
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sum[key] = 0.0
                self._n[key] = 0
            self._counts[key][i] += 1
            self._sum[key] += v
            self._n[key] += 1

    def observe_many(self, values: Sequence[float], **labels) -> None:
        """Add a batch of samples under ONE key build + lock acquire —
        the serving hot path records a whole micro-batch per call."""
        if not self._on() or not values:
            return
        key = _label_key(self.labelnames, labels)
        idx = [self._bucket_index(float(v)) for v in values]
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = \
                    [0] * (len(self.buckets) + 1)
                self._sum[key] = 0.0
                self._n[key] = 0
            for i in idx:
                counts[i] += 1
            self._sum[key] += float(sum(values))
            self._n[key] += len(values)

    def count(self, **labels) -> int:
        with self._lock:
            return self._n.get(_label_key(self.labelnames, labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sum.get(_label_key(self.labelnames, labels),
                                 0.0)

    def quantile(self, q: float, **labels) -> float:
        """Upper bound of the bucket holding the q-th sample (0<=q<=1);
        inf if it landed in the overflow bucket, 0.0 with no samples."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            counts = list(self._counts.get(key, ()))
            n = self._n.get(key, 0)
        if not n:
            return 0.0
        rank = max(1, math.ceil(q * n))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                return self.buckets[i] if i < len(self.buckets) \
                    else math.inf
        return math.inf

    def _samples(self):
        out = []
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sum)
            ns = dict(self._n)
        for key, counts in items:
            cum = 0
            for b, c in zip(self.buckets + [math.inf], counts):
                cum += c
                out.append((self.name + "_bucket", self.labelnames,
                            key, cum, (("le", _fmt_val(b)),)))
            out.append((self.name + "_sum", self.labelnames, key,
                        sums[key]))
            out.append((self.name + "_count", self.labelnames, key,
                        ns[key]))
        return out


class MetricsRegistry:
    """Family registry + exposition renderer. `on=False` short-circuits
    every observation (the obs-off arm of the overhead bench); the
    toggle is live (`registry.on = False`) so A/B runs reuse warmed
    servers."""

    def __init__(self, on: bool = True):
        self.on = bool(on)
        self._lock = threading.RLock()
        self._families: Dict[str, _Metric] = {}
        self._callbacks: List[Callable] = []

    # ------------------------------------------------------- factories
    def _family(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls \
                        or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                return fam
            fam = cls(name, help, labelnames, registry=self, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._family(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._family(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(),
                  buckets=None) -> Histogram:
        return self._family(Histogram, name, help, labelnames,
                            buckets=buckets)

    def register_callback(self, fn: Callable) -> None:
        """`fn(registry)` runs at every `collect()` — set scrape-time
        gauges (queue depth, compile-cache entries) there instead of
        instrumenting hot paths."""
        with self._lock:
            self._callbacks.append(fn)

    # ------------------------------------------------------ exposition
    def collect(self) -> dict:
        """JSON-able snapshot: {name: {"kind", "help", "labelnames",
        "samples": [[name, labelvalues, value, extra-label-pairs]]}}.
        The unit the bridge ships worker->dispatcher."""
        if self.on:
            with self._lock:
                callbacks = list(self._callbacks)
            for fn in callbacks:
                fn(self)
        out = {}
        with self._lock:
            fams = list(self._families.items())
        for name, fam in fams:
            samples = []
            for s in fam._samples():
                sname, _, key, value = s[0], s[1], s[2], s[3]
                extra = list(s[4]) if len(s) > 4 else []
                samples.append([sname, list(key), value,
                                [list(p) for p in extra]])
            out[name] = {"kind": fam.kind, "help": fam.help,
                         "labelnames": list(fam.labelnames),
                         "samples": samples}
        return out

    def render(self, extra_snapshots: Sequence[dict] = ()) -> str:
        """Prometheus text exposition of this registry merged with any
        forwarded snapshots (see `merge_snapshots`)."""
        snaps = [self.collect()] + list(extra_snapshots)
        return render_snapshot(merge_snapshots(snaps))


# -------------------------------------------------- snapshot machinery
def merge_snapshots(snapshots: Sequence[dict]) -> dict:
    """Fold several `collect()` snapshots into one: counter and
    histogram samples with identical (name, labels) SUM; gauges keep
    the last value seen. This is how `/metrics` answers with
    bridge-aggregated totals while per-worker series (which carry a
    distinct `worker` label) pass through untouched."""
    out: dict = {}
    for snap in snapshots:
        for name, fam in snap.items():
            dst = out.setdefault(name, {"kind": fam["kind"],
                                        "help": fam["help"],
                                        "labelnames":
                                            list(fam["labelnames"]),
                                        "_acc": {}})
            acc = dst["_acc"]
            for sname, key, value, extra in fam["samples"]:
                k = (sname, tuple(key),
                     tuple(tuple(p) for p in extra))
                if fam["kind"] == "gauge":
                    acc[k] = value
                else:
                    acc[k] = acc.get(k, 0) + value
    for fam in out.values():
        fam["samples"] = [[sname, list(key), v,
                           [list(p) for p in extra]]
                          for (sname, key, extra), v
                          in sorted(fam.pop("_acc").items())]
    return out


def _sample_order(sample):
    """Render order within a family: bucket rows by numeric `le`
    (not lexically — "+Inf" must come last), then _sum, then _count."""
    sname, key, _value, extra = sample
    le = 0.0
    for k, v in extra:
        if k == "le":
            le = math.inf if v == "+Inf" else float(v)
    rank = 2 if sname.endswith("_count") else \
        1 if sname.endswith("_sum") else 0
    return (tuple(key), rank, le, sname)


def render_snapshot(snapshot: dict) -> str:
    """One merged snapshot -> Prometheus text exposition 0.0.4."""
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for sname, key, value, extra in sorted(fam["samples"],
                                               key=_sample_order):
            labelnames = list(fam["labelnames"])
            # snapshots may carry wider keys (a merged-in worker label)
            if len(key) == len(labelnames) + 1:
                labelnames = labelnames + ["worker"]
            labels = _fmt_labels(labelnames, key,
                                 tuple(tuple(p) for p in extra))
            lines.append(f"{sname}{labels} {_fmt_val(value)}")
    return "\n".join(lines) + "\n"


def snapshot_by_worker(snapshot: dict, worker) -> dict:
    """Re-home a worker's snapshot under `<family>_by_worker` families
    with a trailing `worker` label — the per-worker breakdown kept
    ALONGSIDE the aggregated base series (separate family names, so
    downstream `sum()` queries over the base series never
    double-count)."""
    out = {}
    for name, fam in snapshot.items():
        new = name + "_by_worker"
        out[new] = {
            "kind": fam["kind"],
            "help": fam["help"] + " (per-worker breakdown)",
            "labelnames": list(fam["labelnames"]) + ["worker"],
            "samples": [[new + sname[len(name):],
                         list(key) + [str(worker)], v,
                         [list(p) for p in extra]]
                        for sname, key, v, extra in fam["samples"]],
        }
    return out


def snapshot_with_label(snapshot: dict, label: str,
                        value: str) -> dict:
    """Append `label=value` to every sample of a snapshot — the
    per-worker breakdown (`worker="<pid>"`) kept alongside the
    aggregated series."""
    out = {}
    for name, fam in snapshot.items():
        out[name] = {
            "kind": fam["kind"], "help": fam["help"],
            "labelnames": list(fam["labelnames"]),
            "samples": [[sname, key, v,
                         [list(p) for p in extra]
                         + [[label, str(value)]]]
                        for sname, key, v, extra in fam["samples"]],
        }
    return out


# ------------------------------------------------------------- parsing
def parse_prometheus(text: str) -> Dict[str, Dict[frozenset, float]]:
    """Tiny exposition parser (the subset `render` emits): returns
    {series name: {frozenset(label pairs): value}}. Used by tests to
    assert the endpoint's output is parseable and numerically equal to
    the in-process stats it unifies."""
    out: Dict[str, Dict[frozenset, float]] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        if "{" in ln:
            name, rest = ln.split("{", 1)
            labelpart, valpart = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(labelpart):
                k, v = item.split("=", 1)
                v = v.strip()[1:-1]
                v = v.replace(r'\"', '"').replace(r"\n", "\n") \
                    .replace(r"\\", "\\")
                labels.append((k.strip(), v))
            value = valpart.strip()
        else:
            name, value = ln.split(None, 1)
            labels = []
        out.setdefault(name.strip(), {})[frozenset(labels)] = \
            float(value)
    return out


def _split_labels(s: str) -> List[str]:
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    out, buf, in_q, esc = [], "", False, False
    for ch in s:
        if esc:
            buf += ch
            esc = False
            continue
        if ch == "\\":
            buf += ch
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            out.append(buf)
            buf = ""
        else:
            buf += ch
    if buf.strip():
        out.append(buf)
    return out
