"""The port's worker fleet (``serve/{router,control,fleet}.py``,
``obs/fleet.py``, the fleet half of ``obs/quantiles.py``,
``serve/loadgen.py`` and ``serve/http.py``, ``ia fleet``), held to the JAX
package's on the CPU.

- ``FleetConfig`` and ``ControlPolicy``: the same fields and defaults,
  the same refusals (message for message), and a policy file written by
  either package loads equal in the other;
- ``Ring.successors`` identical over 200 key strings, and the same keys
  kept when a worker joins and leaves; ``home_for_style`` alike;
- the control plane's gate verdicts and ``reconcile`` verdicts and causes
  equal under the same synthetic health documents on a fake clock;
- ``obs/fleet``: equal dicts and byte-equal text for ``merge_snapshots``,
  ``render_fleet``, ``snapshot_from_exposition`` and
  ``merge_tenant_docs``; the quantile merges and selftest equal;
  ``loadgen.render_fleet`` the same text;
- an in-process fleet over both wire codecs: each response the JAX
  fleet's and the port's singleton's bits, one home worker for one batch
  key; spillover past a gated worker; kill -> handoff -> dedupe by
  idempotency key; the federated ``/metrics``;
- the two ``serve_fleet_http`` fronts: the same codes, bodies and
  ``X-IA-*`` headers;
- ``ia fleet --selftest`` on the CPU exits 0 (static and autoscaled).

Every comparison is exact (tolerance 0: equal bits, equal strings).
Inputs are seeded with numpy at 32^2 and 2 levels; the port's workers
run on ``device="cpu"`` (the kernels' plain versions) or the host oracle
(``backend="cpu"``, the matcher the JAX fleet runs here).
"""

import dataclasses
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from image_analogies_tpu_torch import create_image_analogy
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import fleet as obs_fleet
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import quantiles as qs
from image_analogies_tpu_torch.serve import FleetConfig, ServeConfig
from image_analogies_tpu_torch.serve import loadgen
from image_analogies_tpu_torch.serve.control import ControlPlane
from image_analogies_tpu_torch.serve.fleet import Fleet
from image_analogies_tpu_torch.serve.policy import ControlPolicy
from image_analogies_tpu_torch.serve.router import Ring, Router

SIZE = 32


@pytest.fixture(autouse=True)
def _own_tune_store(tmp_path, monkeypatch):
    """The cost model's prior comes from the tune store: each test reads
    a store of its own; no catalog root leaks into the fleet's warm-up."""
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))
    monkeypatch.delenv("IA_CATALOG_DIR", raising=False)
    monkeypatch.delenv("IA_ARCHIVE_DIR", raising=False)


def _jax():
    """The JAX package's fleet modules (imported where a test needs
    them: the port's modules import none of them)."""
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.obs import fleet as jfleet
    from image_analogies_tpu.obs import quantiles as jqs
    from image_analogies_tpu.serve import control as jcontrol
    from image_analogies_tpu.serve import loadgen as jloadgen
    from image_analogies_tpu.serve import policy as jpolicy
    from image_analogies_tpu.serve import router as jrouter
    from image_analogies_tpu.serve import types as jtypes
    from image_analogies_tpu.serve.fleet import Fleet as JFleet

    return dict(Params=JParams, obs_fleet=jfleet, qs=jqs,
                ControlPlane=jcontrol.ControlPlane, loadgen=jloadgen,
                ControlPolicy=jpolicy.ControlPolicy, Ring=jrouter.Ring,
                Router=jrouter.Router, FleetConfig=jtypes.FleetConfig,
                ServeConfig=jtypes.ServeConfig, Fleet=JFleet)


def _load(n=4, seed=5, shared=True):
    """``n`` requests at SIZE^2: one exemplar pair (one batch key) when
    ``shared``, else a pair each."""
    rng = np.random.RandomState(seed)

    def plane():
        return rng.rand(SIZE, SIZE).astype(np.float32)

    a, ap = plane(), plane()
    out = []
    for _ in range(n):
        if not shared:
            a, ap = plane(), plane()
        out.append((a, ap, plane()))
    return out


def _port_params(backend="cpu"):
    return AnalogyParams(device="cpu", backend=backend, levels=2)


def _fleet_kw():
    return dict(size=2, vnodes=16, health_interval_s=0.05, death_checks=2,
                backoff_s=0.01, backoff_cap_s=0.05)


def _serve_kw():
    return dict(workers=1, max_batch=4, batch_window_ms=20.0,
                cost_persist=False, journal_fsync=False)


def _port_fleet_cfg(tmp_path=None, wire="auto", backend="cpu", **kw):
    return FleetConfig(
        serve=ServeConfig(params=_port_params(backend), **_serve_kw()),
        wire=wire,
        journal_root=str(tmp_path / "journals") if tmp_path else None,
        **dict(_fleet_kw(), **kw))


def _jax_fleet_cfg(j, tmp_path=None, wire="auto"):
    return j["FleetConfig"](
        serve=j["ServeConfig"](params=j["Params"](backend="cpu", levels=2),
                               **_serve_kw()),
        wire=wire,
        journal_root=str(tmp_path / "jjournals") if tmp_path else None,
        **_fleet_kw())


def _routed_counts(metrics=obs_metrics):
    snap = metrics.snapshot() or {}
    return {k.split("router.routed.", 1)[1]: int(v)
            for k, v in (snap.get("counters") or {}).items()
            if k.startswith("router.routed.")}


def _wait_until(pred, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------------------ configurations


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else "<required>") for f in dataclasses.fields(cls)}


def test_fleet_config_and_control_policy_fields_and_defaults_equal():
    j = _jax()
    assert _defaults(FleetConfig) == _defaults(j["FleetConfig"])
    assert _defaults(ControlPolicy) == _defaults(j["ControlPolicy"])
    cfg = FleetConfig(serve=ServeConfig(params=_port_params()))
    # fleet semantics, not speed numbers: the JAX values
    assert (cfg.spawn_timeout_s, cfg.health_interval_s, cfg.death_checks,
            cfg.crash_loop_window_s, cfg.crash_loop_threshold) == \
        (120.0, 0.25, 2, 1.0, 3)
    assert ControlPolicy().to_json() == j["ControlPolicy"]().to_json()


_BAD = [
    ("fleet", dict(size=0)), ("fleet", dict(vnodes=0)),
    ("fleet", dict(wire="msgpack")), ("fleet", dict(transport="pigeon")),
    ("fleet", dict(spawn_timeout_s=0.0)),
    ("fleet", dict(crash_loop_window_s=-1.0)),
    ("fleet", dict(crash_loop_threshold=-1)),
    ("fleet", dict(health_interval_s=0.0)), ("fleet", dict(death_checks=0)),
    ("fleet", dict(spill_queue_frac=0.0)),
    ("fleet", dict(spill_queue_frac=1.5)),
    ("fleet", dict(spill_retries=-1)),
    ("fleet", dict(backoff_s=0.5, backoff_cap_s=0.1)),
    ("fleet", dict(backoff_s=0.0)),
    ("policy", dict(min_workers=0)),
    ("policy", dict(min_workers=3, max_workers=2)),
    ("policy", dict(queue_high=0.0)), ("policy", dict(queue_low=-1.0)),
    ("policy", dict(queue_low=4.0, queue_high=4.0)),
    ("policy", dict(max_burn_rate=0.0)), ("policy", dict(target_p95_ms=-1)),
    ("policy", dict(scale_up_windows=0)),
    ("policy", dict(scale_down_windows=0)),
    ("policy", dict(scale_up_cooldown_s=-1.0)),
    ("policy", dict(scale_down_cooldown_s=-0.5)),
]


@pytest.mark.parametrize("which,bad", _BAD,
                         ids=[f"{w}-{next(iter(b))}-{i}"
                              for i, (w, b) in enumerate(_BAD)])
def test_bad_values_refused_alike(which, bad):
    j = _jax()
    if which == "fleet":
        port = lambda: FleetConfig(  # noqa: E731
            serve=ServeConfig(params=_port_params()), **bad)
        jax = lambda: j["FleetConfig"](  # noqa: E731
            serve=j["ServeConfig"](params=j["Params"](backend="cpu")),
            **bad)
    else:
        port = lambda: ControlPolicy(**bad)  # noqa: E731
        jax = lambda: j["ControlPolicy"](**bad)  # noqa: E731
    with pytest.raises(ValueError) as pe:
        port()
    with pytest.raises(ValueError) as je:
        jax()
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_control_policy_file_loads_equal_across_packages(tmp_path, writer):
    j = _jax()
    kw = dict(min_workers=2, max_workers=5, queue_high=6.0, queue_low=1.0,
              target_p95_ms=250.0, scale_down_windows=3)
    cls = ControlPolicy if writer == "port" else j["ControlPolicy"]
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(cls(**kw).to_json()))
    port, jax = ControlPolicy.load(str(path)), \
        j["ControlPolicy"].load(str(path))
    assert port.to_json() == jax.to_json() == dict(
        ControlPolicy().to_json(), **kw)
    path.write_text(json.dumps(dict(kw, bogus=1)))
    for c in (ControlPolicy, j["ControlPolicy"]):
        with pytest.raises(ValueError, match="unknown control policy"):
            c.load(str(path))


# --------------------------------------------------------------- ring


@pytest.mark.parametrize("vnodes", [16, 32])
def test_ring_successors_identical_and_rebalance_keeps_keys(vnodes):
    j = _jax()
    rings = [Ring(vnodes=vnodes), j["Ring"](vnodes=vnodes)]
    for r in rings:
        for i in range(4):
            r.add(f"w{i}")
    keys = [f"digest{i:03d}|{64 + i % 3}x{64 + i % 5}|{i * 7919:x}"
            for i in range(200)]
    before = [{k: r.successors(k) for k in keys} for r in rings]
    assert before[0] == before[1]
    assert rings[0].members() == rings[1].members() == [
        "w0", "w1", "w2", "w3"]
    for r in rings:
        r.add("w4")
    after = [{k: r.successors(k)[0] for k in keys} for r in rings]
    assert after[0] == after[1]
    moved = [k for k in keys if after[0][k] != before[0][k][0]]
    assert moved and all(after[0][k] == "w4" for k in moved)
    for r in rings:
        r.remove("w4")
        assert {k: r.successors(k) for k in keys} == before[0]
    # style-grain placement walks the same ring in both packages
    routers = [Router(None, vnodes=vnodes), j["Router"](None, vnodes=vnodes)]
    assert [r.home_for_style("beef") for r in routers] == [None, None]
    for r in routers:
        for i in range(3):
            r.ring.add(f"w{i}")
    styles = [f"{i:012x}" for i in range(50)]
    assert [routers[0].home_for_style(s) for s in styles] == \
        [routers[1].home_for_style(s) for s in styles]


# ------------------------------------------------------- control plane


class _StubHandle:
    def __init__(self):
        self.generation = 0
        self.shut = False

    def health(self):
        return {"ok": True, "queue_depth": 0, "inflight": 0}

    def shutdown(self):
        self.shut = True


class _StubFleet:
    """What ControlPlane touches of a fleet: workers, the router's ring
    and pending map, the gates, and ``_spawn``."""

    def __init__(self, cfg, router_cls):
        self.cfg = cfg
        self.workers = {}
        self.router = router_cls(None, vnodes=8)
        self.decisions = None
        self._lock = threading.Lock()
        self._misses, self._scrapes, self._gates = {}, {}, {}

    def _spawn(self, wid, generation):
        self.workers[wid] = _StubHandle()

    def gate_worker(self, wid, reason):
        self._gates[wid] = reason

    def ungate_worker(self, wid):
        self._gates.pop(wid, None)


def _health(depth=0.0, ok=True, recovering=False, burn=0.0, **kw):
    doc = {"ok": ok, "accepting": True, "recovering": recovering,
           "workers": {"alive": 1}, "queue_depth": depth, "inflight": 0,
           "breakers": {}, "slo": {"burn_rate_fast": burn}}
    doc.update(kw)
    return doc


def test_gate_verdicts_equal():
    j = _jax()
    port = ControlPlane(_StubFleet(
        FleetConfig(serve=ServeConfig(params=_port_params(),
                                      queue_depth=10)), Router))
    jax = j["ControlPlane"](_StubFleet(j["FleetConfig"](
        serve=j["ServeConfig"](params=j["Params"](backend="cpu"),
                               queue_depth=10)), j["Router"]))
    docs = [None, _health(), _health(recovering=True, ok=False),
            _health(accepting=False), _health(workers={"alive": 0}),
            _health(breakers={"cpu": "open"}),
            _health(breakers={"cpu": "half_open"}), _health(depth=7),
            _health(depth=8), _health(depth=9, recovering=True)]
    got = [port.gate_verdict(d) for d in docs]
    assert got == [jax.gate_verdict(d) for d in docs]
    assert got == ["dead", None, None, "dead", "dead", "breaker_open",
                   None, None, "saturated", None]


def test_control_plane_reconcile_equal_verdicts_on_a_fake_clock():
    """The same polling passes through both control planes: the same
    verdicts, causes, sizes and record times, scale-up under queue
    pressure and burn, scale-down when calm, the ceiling and floor
    held."""
    j = _jax()
    kw = dict(min_workers=1, max_workers=3, queue_high=4.0, queue_low=0.5,
              scale_up_windows=2, scale_down_windows=3,
              scale_up_cooldown_s=1.0, scale_down_cooldown_s=2.0)
    planes = []
    for fcfg, pol, router, cp in (
            (FleetConfig(serve=ServeConfig(params=_port_params())),
             ControlPolicy(**kw), Router, ControlPlane),
            (j["FleetConfig"](serve=j["ServeConfig"](
                params=j["Params"](backend="cpu"))),
             j["ControlPolicy"](**kw), j["Router"], j["ControlPlane"])):
        fleet = _StubFleet(fcfg, router)
        fleet._spawn("w0", 0)
        fleet.router.ring.add("w0")
        now = [100.0]
        planes.append((fleet, cp(fleet, pol, clock=lambda n=now: n[0]),
                       now))
    # (mean depth, burn) per pass: pressure, then burn alone, then calm
    passes = ([(6.0, 0.0)] * 6 + [(1.0, 3.0)] * 4 + [(2.0, 0.0)] * 2
              + [(0.0, 0.0)] * 14)
    seqs = []
    for fleet, plane, now in planes:
        seq = []
        for depth, burn in passes:
            now[0] += 0.6
            healths = {w: _health(depth=depth, burn=burn)
                       for w in sorted(fleet.workers)}
            seq.append(plane.reconcile(healths))
        seqs.append((seq, list(plane.events), plane.status(),
                     sorted(fleet.workers), fleet.router.ring.members()))
    assert seqs[0] == seqs[1]
    seq, events, status, workers, members = seqs[0]
    verdicts = [(e["verdict"], e["cause"], e["worker"], e["size"])
                for e in events]
    assert verdicts == [
        ("scale_up", "queue_pressure", "w1", 2),
        ("scale_up", "queue_pressure", "w2", 3),
        ("scale_down", "idle", "w2", 2),
        ("scale_down", "idle", "w1", 1)]
    assert workers == members == ["w0"]
    assert status["autoscale"] is True and status["events"] == 4


# ---------------------------------------------------- federated metrics


def _snapshots():
    """Two workers' registry snapshots, of the port's own registries."""
    out = {}
    rng = np.random.RandomState(3)
    for wid in ("w0", "w1"):
        reg = obs_metrics.MetricsRegistry()
        for _ in range(int(rng.randint(3, 9))):
            reg.inc("serve.completed")
            reg.observe("serve.latency_ms", float(rng.rand() * 300.0))
        reg.inc("router.routed." + wid, int(rng.randint(1, 5)))
        reg.set_gauge("hbm.peak_bytes.d0", float(rng.randint(1, 9) << 20))
        reg.set_gauge("serve.queue_depth", float(rng.randint(0, 4)))
        reg.set_gauge("breaker.state.cpu", float(rng.randint(0, 2)))
        out[wid] = reg.snapshot()
    sk = [qs.QuantileSketch() for _ in out]
    for s in sk:
        for v in rng.lognormal(3.0, 0.7, 400):
            s.observe(float(v))
    for (wid, snap), s in zip(sorted(out.items()), sk):
        snap["sketches"] = {"serve.latency_ms": s.summary()}
    return out


def test_obs_fleet_merges_and_renders_equal():
    j = _jax()
    jf = j["obs_fleet"]
    snaps = _snapshots()
    assert obs_fleet.merge_snapshots(snaps) == jf.merge_snapshots(snaps)
    merged = obs_fleet.merge_snapshots(snaps)
    assert merged["gauges"]["hbm.peak_bytes.d0"] == max(
        s["gauges"]["hbm.peak_bytes.d0"] for s in snaps.values())
    assert merged["gauges"]["serve.queue_depth"] == sum(
        s["gauges"]["serve.queue_depth"] for s in snaps.values())
    extra = ("fleet", {"counters": {"router.requests": 7,
                                    "serve.completed": 99},
                       "gauges": {"control.size": 2}, "histograms": {}})
    for ex in (None, extra):
        text = obs_fleet.render_fleet(snaps, extra=ex)
        assert text == jf.render_fleet(snaps, extra=ex)
    assert 'ia_router_requests_total{worker="fleet"} 7' in text
    assert obs_fleet.render_fleet({}) == jf.render_fleet({})
    for name in ("hbm.peak_bytes.d0", "uptime_s", "breaker.state.cpu",
                 "slo.burn", "serve.queue_depth"):
        assert obs_fleet.is_max_gauge(name) == jf.is_max_gauge(name)
    from image_analogies_tpu_torch.obs import live as obs_live
    for snap in snaps.values():
        expo = obs_live.render_prometheus(snap)
        got = obs_fleet.snapshot_from_exposition(expo)
        assert got == jf.snapshot_from_exposition(expo)
        assert got["counters"] == snap["counters"]
    # the federated view is not re-merged
    assert obs_fleet.snapshot_from_exposition(text) == \
        jf.snapshot_from_exposition(text)


def test_tenant_docs_merge_equal():
    j = _jax()
    from image_analogies_tpu_torch.obs.tenants import TenantTracker

    rng = np.random.RandomState(9)
    docs = []
    for _ in range(3):
        t = TenantTracker(k=4)
        for _ in range(40):
            t.observe(f"style{int(rng.zipf(1.6)) % 7}",
                      latency_ms=float(rng.rand() * 200.0),
                      dispatch_ms=float(rng.rand() * 50.0))
        docs.append(t.snapshot())
    for k in (None, 2):
        assert obs_fleet.merge_tenant_docs(docs, k=k) == \
            j["obs_fleet"].merge_tenant_docs(docs, k=k)


def test_quantile_merges_and_selftest_equal():
    j = _jax()
    jq = j["qs"]
    rng = np.random.RandomState(1)
    values = [float(v) for v in rng.lognormal(3.0, 0.7, 3000)]
    parts = [values[i::3] for i in range(3)]
    sums, jsums = [], []
    for part in parts:
        s, t = qs.QuantileSketch(), jq.QuantileSketch()
        for v in part:
            s.observe(v)
            t.observe(v)
        sums.append(s.summary())
        jsums.append(t.summary())
    assert sums == jsums
    merged = qs.merge_summaries(sums)
    assert merged == jq.merge_summaries(sums)
    assert qs.merge_summaries([]) is None is jq.merge_summaries([])
    a = qs.QuantileSketch.from_summary(sums[0]).merge(
        qs.QuantileSketch.from_summary(sums[1]))
    b = jq.QuantileSketch.from_summary(sums[0]).merge(
        jq.QuantileSketch.from_summary(sums[1]))
    assert a.summary() == b.summary()
    assert a.quantiles_doc() == b.quantiles_doc()
    with pytest.raises(ValueError, match="bucket grids differ"):
        qs.QuantileSketch(alpha=0.01).merge(qs.QuantileSketch(alpha=0.02))
    cum = qs.merge_summaries(sums[:2])
    for prev in (None, sums[0], merged):
        assert qs.delta_summary(cum, prev) == jq.delta_summary(cum, prev)
    assert qs.delta_summary(cum, merged) is None
    for q in (0.0, 0.5, 0.99, 0.999, 1.0):
        assert qs.exact_quantile(values, q) == jq.exact_quantile(values, q)
    assert qs.exact_quantile([], 0.5) == 0.0
    got = qs.selftest(n=5000, seed=3)
    assert got == jq.selftest(n=5000, seed=3)
    assert got["ok"] is True


def test_timeline_samples_worker_sketches_as_the_jax_timeline_does():
    """The fleet's health loop feeds each worker's snapshot, sketches
    included, to the timeline: windowed sketch deltas (``delta_summary``)
    and their quantiles (``quantiles_doc``), equal to the JAX timeline's
    on the same snapshots and clock."""
    from image_analogies_tpu.obs import timeline as jtl
    from image_analogies_tpu_torch.obs import timeline as tl

    rng = np.random.RandomState(4)
    snaps, sk = [], qs.QuantileSketch()
    for step in range(3):
        for v in rng.lognormal(3.0, 0.5, 50 * (step + 1)):
            sk.observe(float(v))
        snaps.append({"counters": {"serve.completed": 5 * (step + 1)},
                      "gauges": {"serve.queue_depth": float(step)},
                      "histograms": {},
                      "sketches": {"serve.latency_ms": sk.summary()}})
    docs = []
    for mod in (tl, jtl):
        now = [10.0]
        t = mod.Timeline(clock=lambda n=now: n[0])
        for snap in snaps:
            now[0] += 1.5
            t.sample_snapshot(snap, worker="w0")
        docs.append(t.to_json())
    assert docs[0] == docs[1]
    points = docs[0]["series"]["w0:serve.latency_ms.q"]["points"]
    assert [p[1]["count"] for p in points] == [50, 100, 150]


def test_render_fleet_summary_text_equal():
    j = _jax()
    summary = {
        "n": 6, "fleet_size": 2, "wire": "auto", "transport": "subprocess",
        "sequential_s": 1.5, "served_s": 2.25, "sequential_rps": 4.0,
        "served_rps": 2.667, "speedup": 0.667, "p50_ms": 120.5,
        "p95_ms": 410.25, "completed": 6, "degraded": 0, "timeouts": 0,
        "rejected": 0, "errors": 0, "routed": {"w0": 4, "w1": 2},
        "codecs": {"iaf2": 6}, "wire_bytes": 4096, "spills": 1,
        "hop_faults": 0, "handoffs": 1,
        "ring": {"members": ["w0", "w1"], "vnodes": 32},
        "bit_identical": True}
    variants = [summary,
                dict(summary, zipf=1.1, style_hist={"s0": 4, "s1": 2},
                     flash_crowd={"t0": 0.0, "duration": 0.5, "mult": 4.0},
                     control={"autoscale": True, "size": 2,
                              "last_verdict": {"verdict": "scale_up"}})]
    for s in variants:
        assert loadgen.render_fleet(s) == j["loadgen"].render_fleet(s)


# ------------------------------------------------------ routed serving


def _drive(fleet_cls, fcfg, load, metrics=obs_metrics):
    """Route ``load`` through a fleet of either package; the counters
    come from that package's registry (``metrics``)."""
    with fleet_cls(fcfg) as fl:
        futs = [fl.submit(a, ap, b) for a, ap, b in load]
        resps = [f.result(timeout=120) for f in futs]
        routed = _routed_counts(metrics)
        snap = metrics.snapshot() or {}
    codecs = {k.split("router.wire.", 1)[1]: int(v)
              for k, v in (snap.get("counters") or {}).items()
              if k.startswith("router.wire.")}
    return resps, routed, codecs


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("wire", ["binary", "json"])
def test_inproc_fleet_bits_equal_jax_fleet_and_singletons(wire, backend):
    """Four requests of one batch key through the port's fleet: all on
    one home worker, each its singleton's bits through either codec; on
    the host oracle (the JAX fleet's matcher here) also the JAX fleet's
    bits for the same requests."""
    load = _load(4)
    fcfg = _port_fleet_cfg(wire=wire, backend=backend)
    resps, routed, codecs = _drive(Fleet, fcfg, load)
    assert sorted(routed.values()) == [4], routed
    assert codecs.get("iaf2" if wire == "binary" else "json") == 4
    for (a, ap, b), r in zip(load, resps):
        single = create_image_analogy(a, ap, b, fcfg.serve.params)
        assert r.status == "ok"
        np.testing.assert_array_equal(r.bp, single.bp)
        np.testing.assert_array_equal(r.bp_y, single.bp_y)
    if backend == "cpu":
        from image_analogies_tpu.obs import metrics as jmetrics

        j = _jax()
        jresps, jrouted, _ = _drive(j["Fleet"], _jax_fleet_cfg(j, wire=wire),
                                    load, jmetrics)
        assert sorted(jrouted.values()) == [4]
        for r, jr in zip(resps, jresps):
            np.testing.assert_array_equal(r.bp, np.asarray(jr.bp))
            np.testing.assert_array_equal(r.bp_y, np.asarray(jr.bp_y))


def test_spillover_past_a_gated_worker_gives_the_same_bits(tmp_path):
    """The same idempotency key answered once on each of two workers (the
    home gated between the submissions): the spill is counted, each
    worker journals its own copy, and the bytes are equal."""
    fcfg = _port_fleet_cfg(tmp_path)
    (a, ap, b), = _load(1)
    with Fleet(fcfg) as fl:
        r1 = fl.submit(a, ap, b, idempotency_key="spill-me").result(
            timeout=120)
        (home,) = _routed_counts().keys()
        fl.gate_worker(home, "test_spill")
        try:
            r2 = fl.submit(a, ap, b, idempotency_key="spill-me").result(
                timeout=120)
            routed = _routed_counts()
            counters = (obs_metrics.snapshot() or {}).get("counters") or {}
        finally:
            fl.ungate_worker(home)
    assert len(routed) == 2 and all(v == 1 for v in routed.values())
    assert counters.get("router.spills", 0) >= 1
    assert counters.get("serve.journal.admitted", 0) == 2
    assert counters.get("serve.journal.done", 0) == 2
    assert counters.get("serve.journal.deduped", 0) == 0
    np.testing.assert_array_equal(r1.bp, r2.bp)


def test_kill_triggers_handoff_and_dedupe_by_idempotency_key(tmp_path):
    """An in-process worker killed: the health loop replaces it on the
    same journal directory (same wid, generation 1, a fresh segment, this
    process's lock), and a resubmission under the original key answers
    from the recovered journal with the recorded response."""
    fcfg = _port_fleet_cfg(tmp_path)
    load = _load(2)
    with Fleet(fcfg) as fl:
        futs = [fl.submit(a, ap, b, idempotency_key=f"handoff-{i}")
                for i, (a, ap, b) in enumerate(load)]
        resps = [f.result(timeout=120) for f in futs]
        (home,) = _routed_counts().keys()
        gen0 = fl.workers[home].generation
        fl.workers[home].server.kill()
        assert _wait_until(lambda: fl.handoffs), "no handoff"
        ho = fl.handoffs[0]
        assert ho["worker"] == home and ho["generation"] == gen0 + 1
        assert (ho["recovered"]["entries"], ho["recovered"]["done"],
                ho["recovered"]["replayed"]) == (2, 2, 0)
        health = fl.health()
        wh = health["workers"][home]
        assert wh["ok"] is True and wh["generation"] == gen0 + 1
        assert wh["journal"]["lock_pid"] == os.getpid()
        assert wh["journal"]["segment"] == 2
        assert health["handoffs"] == 1
        a, ap, b = load[0]
        again = fl.submit(a, ap, b, idempotency_key="handoff-0").result(
            timeout=120)
        counters = (obs_metrics.snapshot() or {}).get("counters") or {}
    assert counters.get("serve.journal.deduped", 0) == 1
    assert counters.get("router.deaths", 0) == 1
    assert counters.get("router.handoffs", 0) == 1
    assert again.request_id == resps[0].request_id
    np.testing.assert_array_equal(again.bp, resps[0].bp)


def test_fleet_health_and_federated_metrics(tmp_path):
    """Each worker's /healthz entry names its obs scope and the last
    scrape's age; the fleet's /metrics is the merged view with labeled
    per-worker samples that sum to it, ``metrics_text(wid)`` one worker's
    isolated registry, an unknown wid None."""
    fcfg = _port_fleet_cfg(tmp_path)
    with Fleet(fcfg) as fl:
        for f in [fl.submit(a, ap, b) for a, ap, b in _load(3, seed=7)]:
            f.result(timeout=120)
        time.sleep(4 * fcfg.health_interval_s)
        health = fl.health()
        assert health["transport"] == "inproc" and health["size"] == 2
        for wid, wh in health["workers"].items():
            assert wh["obs"]["scope"] == f"{wid}.g0"
            assert wh["obs"]["last_scrape_age_s"] >= 0.0
            assert wh["ready"] is True and wh["pid"] == os.getpid()
        merged, solo = fl.metrics_text(), fl.metrics_text("w0")
        assert fl.metrics_text("w9") is None
        assert "worker=" not in solo
        sample = re.compile(
            r'^ia_serve_accepted_total(?:\{worker="(w\d)"\})? (\S+)$',
            re.MULTILINE)
        pairs = sample.findall(merged)
        total = sum(float(v) for wid, v in pairs if not wid)
        labeled = sum(float(v) for wid, v in pairs if wid)
        assert total == labeled == 3.0
        assert "ia_router_routed" in merged
        snaps = fl.metrics_snapshots()
        assert sorted(snaps) == ["w0", "w1"]


# ---------------------------------------------------------- HTTP fronts


class _FleetFront:
    def __init__(self, fleet, serve_fleet_http_fn):
        self.fleet = fleet.start()
        self.httpd = serve_fleet_http_fn(self.fleet, 0)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def call(self, path, body=None, headers=None):
        req = urllib.request.Request(self.base + path, data=body,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.fleet.shutdown()


def _ia_headers(h):
    return {k: v for k, v in h.items()
            if k.startswith("X-IA-") and k != "X-IA-Timings"}


def test_both_fleet_fronts_answer_alike(tmp_path):
    from image_analogies_tpu_torch.serve import wire
    from image_analogies_tpu_torch.serve.http import serve_fleet_http
    from image_analogies_tpu.serve.http import \
        serve_fleet_http as jserve_fleet_http

    j = _jax()
    port = _FleetFront(Fleet(_port_fleet_cfg(tmp_path)), serve_fleet_http)
    jax = _FleetFront(j["Fleet"](_jax_fleet_cfg(j, tmp_path)),
                      jserve_fleet_http)
    try:
        (a, ap, b), = _load(1, seed=11)
        frame = wire.encode_planes([a, ap, b])
        f32 = {"Content-Type": wire.CONTENT_TYPE}
        cases = [
            (frame, dict(f32, Accept=wire.CONTENT_TYPE,
                         **{"X-IA-Idempotency-Key": "k-bin",
                            "X-IA-Trace": "feed02/-/-"})),
            (json.dumps({"a": a.tolist(), "ap": ap.tolist(),
                         "b": b.tolist(),
                         "idempotency_key": "k-json"}).encode(),
             {"Content-Type": "application/json",
              "X-IA-Trace": "feed03/-/-"}),
            # the key again: answered from the journal
            (frame, dict(f32, Accept=wire.CONTENT_TYPE,
                         **{"X-IA-Idempotency-Key": "k-bin"})),
        ]
        for body, headers in cases:
            (pc, ph, pb), (jc, jh, jb) = [f.call("/v1/analogy", body, headers)
                                          for f in (port, jax)]
            assert pc == jc == 200
            assert ph["Content-Type"] == jh["Content-Type"]
            if ph["Content-Type"] == wire.CONTENT_TYPE:
                pi, ji = _ia_headers(ph), _ia_headers(jh)
                trace = headers.get("X-IA-Trace")
                if trace:
                    assert pi["X-IA-Trace"] == ji["X-IA-Trace"] == \
                        trace.split("/")[0] + "/http/-"
                pi.pop("X-IA-Trace", None)
                ji.pop("X-IA-Trace", None)
                assert pi == ji
                np.testing.assert_array_equal(wire.decode_planes(pb)[0],
                                              wire.decode_planes(jb)[0])
            else:
                pd, jd = json.loads(pb), json.loads(jb)
                for d in (pd, jd):
                    d.pop("timings")
                assert pd == jd
                assert ph["X-IA-Trace"] == jh["X-IA-Trace"] == \
                    "feed03/http/-"
        errors = [
            (frame, dict(f32, **{"X-IA-Idempotency-Key": "../etc"})),
            (frame[:-3], f32),
            (wire.encode_planes([a, ap]), f32),
            (b"{not json", {"Content-Type": "application/json"}),
        ]
        for body, headers in errors:
            (pc, _, pb), (jc, _, jb) = [f.call("/v1/analogy", body, headers)
                                        for f in (port, jax)]
            assert pc == jc == 400
            assert json.loads(pb) == json.loads(jb)
        for path in ("/nope", "/metrics?worker=w9"):
            (pc, _, pb), (jc, _, jb) = [f.call(path) for f in (port, jax)]
            assert pc == jc == 404
            assert json.loads(pb) == json.loads(jb)
        (pc, _, pb), (jc, _, jb) = [f.call("/healthz") for f in (port, jax)]
        ph, jh = json.loads(pb), json.loads(jb)
        assert pc == jc == 200 and set(ph) == set(jh)
        for key in ("size", "configured_size", "wire", "transport", "ring",
                    "pending", "handoffs", "control"):
            assert ph[key] == jh[key], key
        assert set(ph["workers"]) == set(jh["workers"]) == {"w0", "w1"}
        for wid in ph["workers"]:
            assert set(ph["workers"][wid]) == set(jh["workers"][wid])
        for path in ("/metrics", "/metrics?worker=w0", "/tenants",
                     "/timeline"):
            (pc, ph_, _), (jc, jh_, _) = [f.call(path) for f in (port, jax)]
            assert pc == jc == 200, path
            assert ph_["Content-Type"] == jh_["Content-Type"], path
        metrics = port.call("/metrics")[2].decode()
        assert 'worker="w0"' in metrics or 'worker="w1"' in metrics
    finally:
        port.close()
        jax.close()


# -------------------------------------------------------------- CLI


@pytest.mark.parametrize("extra", [[], ["--autoscale"], ["--wire", "json"]],
                         ids=["static", "autoscale", "json"])
def test_cli_fleet_selftest_on_the_cpu(capsys, extra):
    from image_analogies_tpu_torch.cli import main

    rc = main(["fleet", "--selftest", "3", "--size", "2", "--max-batch", "3",
               "--batch-window-ms", "50", "--levels", "2", "--device", "cpu",
               *extra])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert "fleet selftest: 3 requests over 2 workers" in captured.out
    assert "bit-identical to singleton dispatch: True" in captured.out
    summary = json.loads(captured.err.strip().splitlines()[-1])
    assert summary["errors"] == 0 and summary["bit_identical"] is True
    assert sum(summary["routed"].values()) == 3
    codec = "json" if "json" in extra else "iaf2"
    assert summary["codecs"].get(codec, 0) == 3
    assert summary["control"]["autoscale"] is ("--autoscale" in extra)


def test_cli_fleet_needs_selftest_or_http(capsys):
    from image_analogies_tpu_torch.cli import build_parser, main

    assert main(["fleet", "--device", "cpu"]) == 2
    assert "--selftest N or --http PORT" in capsys.readouterr().err
    args = build_parser().parse_args(["fleet"])
    assert (args.size, args.wire, args.transport, args.queue_depth,
            args.batch_window_ms, args.max_batch, args.workers,
            args.device) == (2, "auto", "inproc", 32, 4.0, 8, 1, "cuda")
