"""The obs planes the port's server reads, held against the JAX modules:
``obs/slo.py``, ``obs/tenants.py``, ``obs/timeline.py``, ``obs/ledger.py``
and ``obs/ceilings.py`` fed the same seeded event sequence under an
injected clock give equal documents; ``Histogram.merge`` /
``from_summary`` give equal summaries; ``request_context`` /
``capture_trace`` give the same attrs; the black-box dumps of
``obs/recorder.py`` load across the packages.  Equality is exact (the
port's copies do the same float arithmetic in the same order); event
sequences are drawn with numpy from a seed.
"""

import json

import numpy as np
import pytest

from image_analogies_tpu.obs import ceilings as jceilings
from image_analogies_tpu.obs import ledger as jledger
from image_analogies_tpu.obs import metrics as jmetrics
from image_analogies_tpu.obs import recorder as jrecorder
from image_analogies_tpu.obs import slo as jslo
from image_analogies_tpu.obs import tenants as jtenants
from image_analogies_tpu.obs import timeline as jtimeline
from image_analogies_tpu.obs import trace as jtrace
from image_analogies_tpu_torch.obs import ceilings as tceilings
from image_analogies_tpu_torch.obs import ledger as tledger
from image_analogies_tpu_torch.obs import metrics as tmetrics
from image_analogies_tpu_torch.obs import recorder as trecorder
from image_analogies_tpu_torch.obs import slo as tslo
from image_analogies_tpu_torch.obs import tenants as ttenants
from image_analogies_tpu_torch.obs import timeline as ttimeline
from image_analogies_tpu_torch.obs import trace as ttrace

PAIRS = {"slo": (jslo, tslo), "tenants": (jtenants, ttenants),
         "timeline": (jtimeline, ttimeline), "ledger": (jledger, tledger),
         "ceilings": (jceilings, tceilings), "metrics": (jmetrics, tmetrics)}


def _both(name):
    return PAIRS[name]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _events(seed, n=200):
    """A seeded serve-like event stream: (dt, tenant, met, latency_ms,
    queue_ms, dispatch_ms, lanes, degraded, retries, error)."""
    rng = np.random.default_rng(seed)
    tenants = [f"{i:012x}" for i in rng.integers(0, 2**40, size=7)]
    p = np.array([0.4, 0.2, 0.15, 0.1, 0.07, 0.05, 0.03])
    for _ in range(n):
        yield (float(rng.exponential(0.4)),
               tenants[int(rng.choice(7, p=p))],
               bool(rng.random() < 0.93),
               float(rng.lognormal(4.0, 0.8)),
               float(rng.exponential(5.0)),
               float(rng.lognormal(3.5, 0.5)),
               int(rng.integers(1, 5)),
               bool(rng.random() < 0.1),
               int(rng.random() < 0.05),
               bool(rng.random() < 0.02))


# ----------------------------------------------------------------- SLO


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_tracker_documents_equal(seed):
    docs = []
    for mod in _both("slo"):
        clock = _Clock()
        tr = mod.SloTracker(0.95, fast_window_s=5.0, slow_window_s=30.0,
                            clock=clock)
        snaps = []
        for ev in _events(seed):
            clock.t += ev[0]
            tr.record(ev[2])
            snaps.append(tr.snapshot())
        docs.append(snaps)
    assert docs[0] == docs[1]
    assert any(s["burn_rate_fast"] > 1 for s in docs[1])


# ------------------------------------------------------------- tenants


@pytest.mark.parametrize("k", [3, 16])
def test_tenant_tracker_documents_equal(k):
    docs = []
    for mod in _both("tenants"):
        tr = mod.TenantTracker(k)
        for i, ev in enumerate(_events(2)):
            (_, tenant, _, lat, q, d, lanes, deg, retries, err) = ev
            tr.observe(tenant, latency_ms=lat, queue_ms=q, dispatch_ms=d,
                       lanes=lanes, degraded=deg, retries=retries,
                       wire_bytes=64 * lanes, error=err)
            if i % 17 == 0:
                tr.throttle(tenant)
        docs.append(tr.snapshot())
    assert docs[0] == docs[1]
    assert docs[1]["tracked"] == min(k, 7)
    merged = [mod.merge_docs([d, d], k=k) for mod, d in
              zip(_both("tenants"), docs)]
    assert merged[0] == merged[1]


# ------------------------------------------------------------ timeline


def _feed_timeline(mod, seed):
    clock = _Clock(0.0)
    tl = mod.Timeline(tiers=((1.0, 8), (4.0, 6), (16.0, 4)), clock=clock)
    counters = {"serve.completed": 0, "serve.errors": 0}
    h = PAIRS["metrics"][0 if mod is jtimeline else 1].Histogram()
    docs = []
    for i, ev in enumerate(_events(seed, n=120)):
        clock.t += ev[0]
        counters["serve.completed"] += 1
        counters["serve.errors"] += int(ev[9])
        h.observe(ev[3])
        snap = {"counters": dict(counters),
                "gauges": {"serve.queue_depth": float(ev[6])},
                "histograms": {"serve.latency_ms": h.summary()}}
        tl.sample_snapshot(snap, worker=f"w{i % 2}")
        if i % 20 == 19:
            docs.append(tl.to_json())
            docs.append(tl.range("w0:serve.completed"))
            docs.append(tl.advisory())
    docs.append(mod.cockpit_rows(tl.to_json()))
    return docs


@pytest.mark.parametrize("seed", [3, 4])
def test_timeline_documents_equal(seed):
    jdocs, tdocs = (_feed_timeline(mod, seed) for mod in _both("timeline"))
    assert json.dumps(jdocs, sort_keys=True) == \
        json.dumps(tdocs, sort_keys=True)


# -------------------------------------------------------------- ledger


def test_ledger_documents_equal(monkeypatch):
    clock = _Clock(50.0)

    class _Time:
        monotonic = staticmethod(clock)

    docs = []
    for mod in _both("ledger"):
        monkeypatch.setattr(mod, "time", _Time)
        clock.t = 50.0
        led = mod.arm(capacity=64, tenant_k=4)
        try:
            for i, ev in enumerate(_events(5, n=150)):
                clock.t += ev[0]
                mod.record({"tenant": ev[1], "rid": i, "total_ms": ev[3],
                            "queue_ms": ev[4], "dispatch_ms": ev[5],
                            "lanes": ev[6],
                            "degrade_levels": 2 if ev[7] else None,
                            "retries": ev[8], "wire_bytes": 0,
                            "status": "error" if ev[9] else "ok"})
                if i % 31 == 0:
                    mod.record_throttle(ev[1])
            docs.append((mod.tenants_doc(), led.recent(5),
                         mod.render_tenants(mod.tenants_doc())))
        finally:
            mod.disarm()
        assert not mod.armed()
        assert mod.tenants_doc()["armed"] is False
    assert docs[0] == docs[1]


def test_ledger_decision_funnel_records_equal():
    recs = []
    for mod, trace in ((jledger, jtrace), (tledger, ttrace)):
        got = []
        orig = trace._logging.emit
        trace._logging.emit = lambda rec, path=None, _g=got: _g.append(
            dict(rec))
        try:
            with trace.request_context(request=7, trace="abc"):
                mod.emit_decision("worker", "degrade", "ewma_over_budget",
                                  idem=None, request=7, levels=2)
        finally:
            trace._logging.emit = orig
        recs.append(got)
    assert recs[0] == recs[1]
    assert recs[1][0]["trace"] == "abc" and recs[1][0]["verdict"] == \
        "degrade"


# ------------------------------------------------------------ ceilings


def test_ceiling_monitor_documents_equal():
    """Series fed through ``extra`` with thresholds of their own (the
    process's own RSS is read live and would differ between calls)."""
    docs = []
    for mod in _both("ceilings"):
        clock = _Clock(0.0)
        mon = mod.CeilingMonitor(
            thresholds={"journal.bytes": 1000.0, "custom.bytes": 50.0},
            window=12, min_points=6, cooldown_s=5.0, clock=clock)
        rng = np.random.default_rng(6)
        alarms = []
        for i in range(60):
            clock.t += 0.5
            leak = 3000.0 * i if i > 20 else 0.0
            alarms.append(mon.sample(extra={
                "journal.bytes": 1e6 + leak + rng.normal(0, 200.0),
                "custom.bytes": 500.0 + rng.normal(0, 2.0)}))
        docs.append((alarms, mon.report()))
    assert docs[0] == docs[1]
    assert any(docs[1][0])  # the leak alarmed
    for v in (jceilings.read_proc_vitals(), tceilings.read_proc_vitals()):
        assert set(v) == {"pid", "rss_bytes", "open_fds", "threads"}


# ------------------------------------------------------------- metrics


@pytest.mark.parametrize("seed", [7, 8])
def test_histogram_merge_and_from_summary_equal(seed):
    rng = np.random.default_rng(seed)
    xs, ys = rng.lognormal(2.0, 1.5, 300), rng.lognormal(5.0, 0.5, 200)
    out = []
    for mod in _both("metrics"):
        a, b, empty = mod.Histogram(), mod.Histogram(), mod.Histogram()
        for x in xs:
            a.observe(float(x))
        for y in ys:
            b.observe(float(y))
        c = mod.Histogram.from_summary(a.summary())
        c.merge(b)
        c.merge(empty)  # a no-op
        d = mod.Histogram.from_summary(empty.summary())
        d.merge(a)
        out.append((c.summary(), d.summary(), c.percentile(50),
                    c.percentile(99)))
    assert out[0] == out[1]
    whole = tmetrics.Histogram()
    for v in np.concatenate([xs, ys]):
        whole.observe(float(v))
    assert out[1][0]["count"] == whole.summary()["count"]
    assert out[1][0]["buckets"] == whole.summary()["buckets"]


# --------------------------------------------------------------- trace


def test_request_context_and_capture_trace_equal():
    got = []
    for trace in (jtrace, ttrace):
        with trace.request_context(request=3, key="k/1",
                                   trace="t0000000000000001",
                                   parent_span="admit"):
            with trace.request_context(origin_request=9):
                inner = (dict(trace.context_attrs()), trace.capture_trace())
            outer = trace.capture_trace()
        after = trace.context_attrs()
        with trace.ensure_trace(parent_span="worker"):
            minted = trace.capture_trace()
        got.append((inner, outer, after, sorted(minted),
                    len(minted["trace"])))
    assert got[0] == got[1]
    assert got[1][0][1] == {"trace": "t0000000000000001",
                            "parent_span": "admit", "origin_request": "9"}
    assert ttrace.TRACE_KEYS == jtrace.TRACE_KEYS


def test_span_and_record_inherit_the_ambient_attrs(tmp_path):
    """Inside a run, a span and a record take the thread's request attrs
    (explicit attrs win), in both packages alike."""
    keep = ("event", "name", "request", "trace", "level", "depth")
    out = []
    for trace, tag in ((jtrace, "j"), (ttrace, "t")):
        log = str(tmp_path / f"{tag}.jsonl")
        params = type("P", (), {"metrics": True, "log_path": None})()
        with trace.run_scope(params, log_path=log):
            with trace.request_context(request=5, trace="abc", level=9):
                with trace.span("level", level=0):
                    pass
                trace.emit_record({"event": "serve_admit", "request": 6})
        recs = [json.loads(ln) for ln in open(log)]
        out.append([{k: r[k] for k in keep if k in r} for r in recs
                    if r["event"] in ("span", "serve_admit")])
    assert out[0] == out[1]
    assert out[1][0]["level"] == 0 and out[1][0]["request"] == 5
    assert out[1][1]["request"] == 6 and out[1][1]["trace"] == "abc"


# ------------------------------------------------------------ recorder


def test_blackbox_dumps_load_across_packages(tmp_path):
    for make, load in ((trecorder, jrecorder), (jrecorder, trecorder)):
        rec = make.FlightRecorder(capacity=4)
        for i in range(6):
            rec.record({"event": "span", "i": i, "ts": 100.0 + i})
        path = make.dump(rec, str(tmp_path / make.__name__), "breaker_open",
                         scope_id="w1", extra={"backend": "cpu"})
        doc = load.load_dump(path)
        assert doc["dropped"] == 2 and [r["i"] for r in doc["records"]] == \
            [2, 3, 4, 5]
        assert load.list_dumps(str(tmp_path / make.__name__)) == [path]
        blob = open(path).read().replace('"i": 3', '"i": 8')
        with open(path, "w") as f:
            f.write(blob)
        with pytest.raises(ValueError, match="seal"):
            load.load_dump(path)


def test_dump_current_folds_the_ambient_context(tmp_path):
    scope = tmetrics.ObsScope(scope_id="w2")
    scope.dump_dir = str(tmp_path)
    assert trecorder.dump_current("nothing") is None  # no scope active
    with tmetrics.scope_active(scope):
        with ttrace.request_context(request=4, trace="xyz"):
            path = trecorder.dump_current("worker_crash",
                                          extra={"batch_size": 2})
    doc = trecorder.load_dump(path)
    assert doc["extra"] == {"request": 4, "trace": "xyz", "batch_size": 2}
    assert doc["scope"] == "w2" and doc["reason"] == "worker_crash"
