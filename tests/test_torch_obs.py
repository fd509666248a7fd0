"""The port's observability copy (`repro_torch.obs`) against `repro.obs`.

The reference's tracer, metrics and log cases run against the port's
copy (span trees under concurrent clients, the ring bound, the Chrome
export, histogram bucket math on seeded samples, the Prometheus render /
parse round trip, snapshot merging), and for one fixed request stream
the port server's scrape has the same metric families, label names and
label values as the JAX server's, with equal request counts.
"""
import json
import math
import threading

import numpy as np
import pytest

from repro.obs import MetricsRegistry as JRegistry
from repro.obs import parse_prometheus as j_parse
from repro.obs import render_snapshot as j_render
from repro.serve import SpikeServer as JServer
from repro_torch.obs import (JsonLogger, MetricsRegistry, Span, Telemetry,
                             Tracer, chrome_trace, log_buckets,
                             merge_snapshots, new_trace_id,
                             parse_prometheus, render_snapshot,
                             snapshot_by_worker, validate_chrome_trace)
from repro_torch.serve import SpikeServer
from test_torch_serve import TIMEOUT, small_pair, windows


# ------------------------------------------------------- tracer units
def test_span_tree_invariants_under_concurrent_clients():
    tr = Tracer(capacity=10000)

    def client(cid):
        for i in range(20):
            root = tr.span("http_request", client=cid, i=i)
            child = tr.span("gateway_call", ctx=root.ctx())
            grand = tr.span("dispatch", ctx=child.ctx())
            grand.finish()
            child.finish()
            root.finish()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()

    spans = tr.spans()
    assert len(spans) == 8 * 20 * 3 and tr.dropped == 0
    ids = [s.span_id for s in spans]
    assert len(set(ids)) == len(ids)
    by_id = {s.span_id: s for s in spans}
    roots = {}
    for s in spans:
        assert s.end is not None and s.end >= s.start
        if s.parent_id is None:
            assert s.trace_id not in roots
            roots[s.trace_id] = s
        else:
            parent = by_id[s.parent_id]
            assert parent.trace_id == s.trace_id
            assert parent.start <= s.start and s.end <= parent.end
    assert len(roots) == 8 * 20


def test_ring_bound_and_dropped_accounting():
    tr = Tracer(capacity=8)
    for i in range(20):
        tr.span("s", i=i).finish()
    assert len(tr.spans()) == 8 and tr.dropped == 12
    tr2 = Tracer(capacity=8)
    tr2.record_batch([tr2.span_record("s", start=0, end=1, i=i)
                      for i in range(20)])
    assert len(tr2.spans()) == 8 and tr2.dropped == 12
    assert all(isinstance(s, Span) for s in tr2.spans())
    tr2.clear()
    assert tr2.spans() == [] and tr2.dropped == 0


def test_disabled_telemetry_is_noop():
    tel = Telemetry(on=False)
    sp = tel.tracer.span("x", model="m")
    assert sp.ctx() is None
    sp.finish()
    assert tel.tracer.spans() == []
    assert tel.tracer.span_record("x", start=0, end=1) is None
    c = tel.metrics.counter("c_total", "h")
    c.inc()
    assert c.value() == 0.0
    h = tel.metrics.histogram("h_ms", "h")
    h.observe_many([1.0, 2.0])
    assert h.count() == 0
    assert not tel.log.enabled


def test_span_wire_round_trip_and_chrome_export():
    tr = Tracer()
    with tr.span("dispatch", trace_id="f" * 16, model="m", bucket=4) as sp:
        pass
    d = sp.to_dict()
    assert Span.from_dict(d).to_dict() == d
    doc = chrome_trace(tr.spans())
    assert validate_chrome_trace(doc) == []
    (ev,) = doc["traceEvents"]
    assert ev["ph"] == "X" and ev["dur"] >= 0
    assert ev["args"]["trace_id"] == "f" * 16 and ev["args"]["bucket"] == 4
    assert validate_chrome_trace({"nope": 1})
    assert validate_chrome_trace({"traceEvents": [{}]})


def test_trace_ids_unique_and_well_formed():
    ids = {new_trace_id() for _ in range(1000)}
    assert len(ids) == 1000
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)


# ------------------------------------------------------- metrics units
def test_log_buckets_strictly_increasing_and_cover_range():
    bs = log_buckets()
    assert bs == sorted(bs) and len(set(bs)) == len(bs)
    assert bs[0] == 0.25 and bs[-1] >= 8000.0
    with pytest.raises(ValueError):
        log_buckets(lo=0)
    with pytest.raises(ValueError):
        log_buckets(lo=10, hi=1)


def test_label_mismatch_raises_and_family_conflicts_rejected():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "x", ("model", "outcome"))
    with pytest.raises(ValueError):
        c.inc(model="m")
    with pytest.raises(ValueError):
        c.inc(model="m", wrong="x")
    c.inc(model="m", outcome="ok")
    assert c.value(model="m", outcome="ok") == 1.0
    assert reg.counter("c_total", "x", ("model", "outcome")) is c
    with pytest.raises(ValueError):
        reg.counter("c_total", "x", ("other",))
    with pytest.raises(ValueError):
        reg.gauge("c_total", "x")


@pytest.mark.parametrize("seed", range(4))
def test_histogram_bucket_math_matches_jax(seed):
    """Cumulative `_bucket{le=}` counts equal #(v <= le) exactly (values
    on the bucket bounds included), `_sum`/`_count` match, and the JAX
    registry renders the same series for the same samples."""
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.uniform(math.log(1e-3), math.log(1e4),
                              int(rng.integers(1, 300)))).tolist()
    vals += log_buckets()[:: 7]                  # samples on the bounds
    regs = (MetricsRegistry(), JRegistry())
    for reg in regs:
        h = reg.histogram("h_ms", "x")
        half = len(vals) // 2
        for v in vals[:half]:
            h.observe(v)
        h.observe_many(vals[half:])
    h = regs[0].histogram("h_ms", "x")
    assert h.count() == len(vals)
    assert h.sum() == pytest.approx(sum(vals), rel=1e-9)
    text = render_snapshot(regs[0].collect())
    assert text == j_render(regs[1].collect())
    series = parse_prometheus(text)
    assert series == j_parse(text)
    for key, got in series["h_ms_bucket"].items():
        (le,) = [v for k, v in key if k == "le"]
        bound = math.inf if le == "+Inf" else float(le)
        assert got == sum(1 for v in vals if v <= bound)
    assert series["h_ms_count"][frozenset()] == len(vals)
    assert h.quantile(1.0) >= max(vals)
    assert h.quantile(0.0) <= h.quantile(0.5) <= h.quantile(1.0)


def test_merge_snapshots_and_by_worker():
    a, b = MetricsRegistry(), MetricsRegistry()
    for reg, n in ((a, 3), (b, 4)):
        reg.counter("c_total", "x", ("model",)).inc(n, model="m")
        reg.gauge("g", "x").set(n)
        reg.histogram("h_ms", "x").observe_many([1.0] * n)
    series = parse_prometheus(render_snapshot(
        merge_snapshots([a.collect(), b.collect()])))
    assert series["c_total"][frozenset({("model", "m")})] == 7
    assert series["g"][frozenset()] == 4
    assert series["h_ms_count"][frozenset()] == 7
    snap = a.collect()
    series = parse_prometheus(render_snapshot(merge_snapshots(
        [snap, snapshot_by_worker(snap, 1234)])))
    assert series["c_total"][frozenset({("model", "m")})] == 3
    assert series["c_total_by_worker"][
        frozenset({("model", "m"), ("worker", "1234")})] == 3


def test_render_parse_roundtrip_with_label_escaping():
    reg = MetricsRegistry()
    weird = 'tok "x"\ny'
    reg.counter("weird_total", "h", ("name",)).inc(name=weird)
    series = parse_prometheus(render_snapshot(reg.collect()))
    assert series["weird_total"][frozenset({("name", weird)})] == 1


def test_json_log_schema(tmp_path):
    log = tmp_path / "requests.ndjson"
    lg = JsonLogger(str(log))
    ts = [threading.Thread(target=lambda i=i: lg.request(
        trace_id=f"{i:016x}", model="m", status=200, bucket=4,
        batch_size=3, latency_ms=1.5)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    lg.close()
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert len(recs) == 8 == lg.written
    for r in recs:
        assert {"ts", "event", "trace_id", "token", "model", "op",
                "status", "code", "bucket", "batch_size",
                "latency_ms"} <= set(r)
        assert r["event"] == "request" and r["code"] is None
    assert not JsonLogger(None).enabled


# ------------------------------------------ the server's scrape vs JAX
def _scrape_after_stream(srv, c):
    """Serve a fixed stream (2 sessions, 4 scratch requests), then parse
    the registry's Prometheus text."""
    rng = np.random.default_rng(6)
    reqs = windows(rng, 8, 4, c.n_axons)
    with srv:
        sids = [srv.open_session("m") for _ in range(2)]
        futs = [srv.submit("m", reqs[i], seed=i) for i in range(4)]
        for r in range(2):
            futs += [srv.submit("m", reqs[4 + 2 * r + k], session=sid)
                     for k, sid in enumerate(sids)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        text = render_snapshot(srv.tel.metrics.collect())
        served = sum(m["requests"] for m in srv.stats()["models"].values())
    return parse_prometheus(text), served


def test_server_scrape_has_the_jax_families_and_labels():
    jc, tc = small_pair("engine")
    jsrv = JServer(max_batch=8, max_wait_ms=3.0)
    jsrv.add_model("m", jc, window=4, n_sessions=2, seed=0)
    tsrv = SpikeServer(max_batch=8, max_wait_ms=3.0)
    tsrv.add_model("m", tc, window=4, n_sessions=2, seed=0, device="cpu")
    jser, jserved = _scrape_after_stream(jsrv, jc)
    tser, tserved = _scrape_after_stream(tsrv, tc)
    assert jserved == tserved == 8
    assert set(tser) == set(jser)

    def labels(series, fam, drop=()):
        return {frozenset((k, v) for k, v in key if k not in drop)
                for key in series[fam]}

    for fam in tser:
        if fam == "repro_compile_count":
            # JAX's jitted functions against the port's lane path: the
            # port keeps the lane function, keyed so "lanes" selects it
            assert {k for key in tser[fam] for k, _ in key} == \
                {k for key in jser[fam] for k, _ in key}
            fns = {v for key in tser[fam] for k, v in key if k == "fn"}
            assert fns and all("lanes" in f for f in fns)
            assert any("lanes" in v for key in jser[fam]
                       for k, v in key if k == "fn")
        else:
            assert labels(tser, fam) == labels(jser, fam), fam
    for fam in ("repro_serve_requests_total", "repro_level_events_total",
                "repro_serve_latency_ms_count"):
        assert tser.get(fam) == jser.get(fam), fam
    ok = sum(v for k, v in tser["repro_serve_requests_total"].items()
             if ("outcome", "ok") in k)
    assert ok == tserved
