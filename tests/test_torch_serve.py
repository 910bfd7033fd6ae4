"""The port's serving path (``image_analogies_tpu_torch/serve/``): the
invariants of ``tests/test_serve.py`` on the port's ``Server``, and two
checks across the packages.

- queue-full submits get ``Rejected("queue_full")`` at once;
- an expired deadline is cancelled before dispatch, an unmeetable live
  one is served degraded, with the bits of a direct run at the degraded
  params;
- an injected transient fault is retried inside the server;
- batched responses are the singletons' bits (tolerance 0), through the
  host oracle's shared matcher and through the lane engine;
- the breaker opens and recovers; shutdown drains;
- ``serve_request`` records and spans reach the run log;
- ``ia serve --selftest`` exits 0;
- the same seeded load through the JAX ``Server(backend="cpu")`` and the
  port's gives equal B' arrays and equal statuses;
- ``serve/`` never launches a kernel itself.

Timing-driven decisions are driven by gates, events and the cost model's
own state, never by sleeps against thresholds.  Inputs are seeded with
numpy.
"""

import ast
import json
import os
import threading
import time

import numpy as np
import pytest

from image_analogies_tpu_torch import create_image_analogy
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.serve import (
    Client,
    DeadlineExceeded,
    Rejected,
    Server,
    ServeConfig,
)
from image_analogies_tpu_torch.serve import loadgen
from image_analogies_tpu_torch.serve.worker import WorkerPool
from image_analogies_tpu_torch.utils import failure
from tests.conftest import make_pair


@pytest.fixture(autouse=True)
def _disarm_fault_injector_and_own_tune_store(tmp_path, monkeypatch):
    """The injector is process-global; and the cost model's prior comes
    from the tune store, so each test reads (and the CLI writes) a store
    of its own."""
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))
    yield
    failure.inject_failures(0)


def _params(**kw):
    kw.setdefault("levels", 2)
    kw.setdefault("backend", "cpu")
    return AnalogyParams(**kw)


def _cfg(params=None, **kw):
    return ServeConfig(params=params or _params(), **kw)


def _wait_until(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _gate_workers(monkeypatch):
    """Block every worker batch until the returned event is set."""
    gate = threading.Event()
    orig = WorkerPool._run_batch

    def gated(self, batch):
        gate.wait(30)
        orig(self, batch)

    monkeypatch.setattr(WorkerPool, "_run_batch", gated)
    return gate


# ------------------------------------------------ admission control


def test_queue_full_rejected_immediately(monkeypatch):
    gate = _gate_workers(monkeypatch)
    cfg = _cfg(queue_depth=2, workers=1, max_batch=1, batch_window_ms=0.0)
    a, ap, b = make_pair(10, 10, seed=1)
    with Server(cfg) as srv:
        first = srv.submit(a, ap, b)
        assert _wait_until(lambda: srv.queue_depth == 0)  # popped, gated
        queued = [srv.submit(a, ap, b) for _ in range(2)]  # the queue fills
        t0 = time.monotonic()
        with pytest.raises(Rejected) as ei:
            srv.submit(a, ap, b)
        assert ei.value.reason == "queue_full"
        assert time.monotonic() - t0 < 1.0  # at once, not a blocked wait
        gate.set()
        for fut in [first] + queued:
            assert fut.result(timeout=60).bp is not None


def test_submit_after_shutdown_rejected():
    srv = Server(_cfg(workers=1)).start()
    srv.shutdown()
    a, ap, b = make_pair(8, 8, seed=2)
    with pytest.raises(Rejected) as ei:
        srv.submit(a, ap, b)
    assert ei.value.reason == "shutting_down"


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_drains_or_fails_queued(monkeypatch, drain):
    gate = _gate_workers(monkeypatch)
    cfg = _cfg(queue_depth=8, workers=1, max_batch=1, batch_window_ms=0.0)
    a, ap, b = make_pair(10, 10, seed=3)
    srv = Server(cfg).start()
    inflight = srv.submit(a, ap, b)
    assert _wait_until(lambda: srv.queue_depth == 0)
    queued = [srv.submit(a, ap, b) for _ in range(3)]
    threading.Timer(0.05, gate.set).start()
    srv.shutdown(drain=drain)
    assert inflight.result(timeout=60).status == "ok"
    for fut in queued:
        if drain:
            assert fut.result(timeout=60).status == "ok"
        else:
            with pytest.raises(Rejected) as ei:
                fut.result(timeout=60)
            assert ei.value.reason == "shutting_down"


def test_server_on_the_card_without_one_raises():
    """``device="cuda"`` with no card: the server raises at start, before
    any traffic, and never runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    srv = Server(_cfg(params=AnalogyParams(levels=1)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.start()


def test_journal_dir_names_its_roadmap_item(tmp_path):
    """ROADMAP Queue 1 item 10b brought the write-ahead journal: a
    ``journal_dir`` is accepted (it was refused, naming the item, until
    then) and the server appends to a segment of its own there."""
    cfg = _cfg(journal_dir=str(tmp_path / "j"), journal_fsync=False,
               workers=1)
    with Server(cfg) as srv:
        journal = srv.health()["journal"]
    assert journal["segment"] == 1 and journal["lock_pid"] == os.getpid()
    assert sorted(os.listdir(tmp_path / "j")) == [
        "payloads", "segment-000001.jsonl"]


# ------------------------------------------------- batching, bits


def test_batch_coalesces_and_matches_singleton_dispatch():
    params = _params()
    a, ap, _ = make_pair(12, 12, seed=4)
    rng = np.random.default_rng(4)
    targets = [rng.random((12, 12), dtype=np.float32) for _ in range(3)]
    singleton = [create_image_analogy(a, ap, b, params).bp for b in targets]
    # max_batch == burst: the window closes when the batch is complete
    cfg = _cfg(params=params, workers=1, max_batch=3,
               batch_window_ms=2000.0)
    with Server(cfg) as srv:
        futs = [srv.submit(a, ap, b) for b in targets]
        resps = [f.result(timeout=120) for f in futs]
    assert [r.batch_size for r in resps] == [3, 3, 3]
    assert all(r.status == "ok" and r.degraded is None for r in resps)
    for resp, ref in zip(resps, singleton):
        np.testing.assert_array_equal(resp.bp, ref)


def test_incompatible_params_do_not_share_a_batch():
    params = _params()
    a, ap, b = make_pair(10, 10, seed=5)
    cfg = _cfg(params=params, workers=1, max_batch=4, batch_window_ms=500.0)
    with Server(cfg) as srv:
        f1 = srv.submit(a, ap, b)
        f2 = srv.submit(a, ap, b, params=params.replace(kappa=9.0))
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    assert r1.batch_size == 1 and r2.batch_size == 1


def test_device_backend_batch_runs_the_lane_engine_with_singleton_bits():
    """``Server(backend="cuda", device="cpu")``: a batch of three through
    one lane-engine call, each response its singleton's bits."""
    params = AnalogyParams(levels=2, device="cpu", remap_luminance=False)
    a, ap, _ = make_pair(16, 16, seed=12)
    rng = np.random.default_rng(12)
    targets = [rng.random((16, 16), dtype=np.float32) for _ in range(3)]
    singleton = [create_image_analogy(a, ap, b, params) for b in targets]
    cfg = _cfg(params=params, workers=2, max_batch=3,
               batch_window_ms=2000.0)
    with Server(cfg) as srv:
        resps = [f.result(timeout=120)
                 for f in [srv.submit(a, ap, b) for b in targets]]
        from image_analogies_tpu_torch.obs import metrics as obs_metrics

        counters = obs_metrics.snapshot()["counters"]
    assert counters["batch.launches"] == 1 and counters["batch.lanes"] == 3
    assert counters["serve.completed"] == 3
    for resp, ref in zip(resps, singleton):
        assert resp.batch_size == 3
        np.testing.assert_array_equal(resp.bp, ref.bp)
        np.testing.assert_array_equal(resp.bp_y, ref.bp_y)


def test_remap_on_device_batch_falls_back_to_singleton_bits():
    """With the luminance remap on, the lane engine refuses
    (remap_divergence) and the members run one by one, with no logged
    double claim of their futures."""
    params = AnalogyParams(levels=2, device="cpu")
    a, ap, _ = make_pair(12, 12, seed=13)
    rng = np.random.default_rng(13)
    targets = [rng.random((12, 12), dtype=np.float32) for _ in range(2)]
    singleton = [create_image_analogy(a, ap, b, params).bp for b in targets]
    cfg = _cfg(params=params, workers=1, max_batch=2,
               batch_window_ms=2000.0)
    with Server(cfg) as srv:
        resps = [f.result(timeout=120)
                 for f in [srv.submit(a, ap, b) for b in targets]]
        from image_analogies_tpu_torch.obs import metrics as obs_metrics

        counters = obs_metrics.snapshot()["counters"]
    assert counters["batch.fallback_sequential.remap_divergence"] == 1
    for resp, ref in zip(resps, singleton):
        np.testing.assert_array_equal(resp.bp, ref)


# --------------------------------------------- deadlines + degradation


def test_expired_deadline_cancelled_before_dispatch(monkeypatch):
    launched = []
    orig = WorkerPool._dispatch_one

    def spy(self, req, backend, batch_size):
        launched.append(req.request_id)
        return orig(self, req, backend, batch_size)

    monkeypatch.setattr(WorkerPool, "_dispatch_one", spy)
    from image_analogies_tpu_torch.models import analogy

    ran = []
    monkeypatch.setattr(analogy, "_create_image_analogy",
                        lambda *a, **k: ran.append(1))
    a, ap, b = make_pair(10, 10, seed=6)
    with Server(_cfg(workers=1)) as srv:
        fut = srv.submit(a, ap, b, deadline_s=0.0)  # expired at submit
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=60)
    assert ei.value.request_id == 1
    assert launched == [1] and not ran  # planned, never synthesized


def test_unmeetable_deadline_degrades_with_the_degraded_params_bits():
    params = _params(levels=2, patch_size=5)
    a, ap, b = make_pair(14, 14, seed=7)
    cfg = _cfg(params=params, workers=1, max_batch=1, batch_window_ms=0.0)
    with Server(cfg) as srv:
        # the EWMA at 1e-3 s/unit: full fidelity (14*14*2*25 units)
        # estimates 9.8 s against a 5 s deadline; the 3x3 rungs fit
        srv.cost_model.observe(1000.0, 1.0)
        resp = srv.request(a, ap, b, deadline_s=5.0, timeout=120)
    assert resp.status == "degraded"
    deg = resp.degraded
    assert deg["patch_size"] == 3 and deg["levels"] <= params.levels
    ref = create_image_analogy(a, ap, b, params.replace(
        levels=deg["levels"], patch_size=deg["patch_size"]))
    np.testing.assert_array_equal(resp.bp, ref.bp)


def test_no_degrade_config_runs_full_fidelity():
    params = _params(levels=2)
    a, ap, b = make_pair(10, 10, seed=8)
    with Server(_cfg(params=params, workers=1, degrade=False)) as srv:
        srv.cost_model.observe(1000.0, 1.0)
        resp = srv.request(a, ap, b, deadline_s=5.0, timeout=120)
    assert resp.status == "ok" and resp.degraded is None
    np.testing.assert_array_equal(
        resp.bp, create_image_analogy(a, ap, b, params).bp)


# ------------------------------------------------ failure injection


def test_injected_transient_failure_retried_transparently(tmp_path):
    log = str(tmp_path / "serve.jsonl")
    params = _params(log_path=log)
    a, ap, b = make_pair(10, 10, seed=9)
    clean = create_image_analogy(a, ap, b, _params())
    with Server(_cfg(params=params, workers=1, request_retries=2)) as srv:
        failure.inject_failures(1)  # the first wrapped dispatch dies
        resp = srv.request(a, ap, b, timeout=120)
    assert resp.status == "ok"
    np.testing.assert_array_equal(resp.bp_y, clean.bp_y)
    recs = [json.loads(ln) for ln in open(log) if ln.strip()]
    retries = [r for r in recs if r.get("event") == "level_retry"
               and r.get("scope") == "serve"]
    assert len(retries) == 1 and retries[0]["error"] == "InjectedFailure"
    assert not [r for r in recs if r.get("event") == "serve_request"
                and r.get("status") == "error"]


def test_worker_crash_requeue_exhausted_rejects_and_thread_survives(
        monkeypatch):
    """An escape below the per-request handler fails the batch's members
    with Rejected("worker_crash") (crash_requeues=0), and the worker
    thread serves the next request."""
    from image_analogies_tpu_torch.serve import degrade as serve_degrade

    real = serve_degrade.plan
    armed = {"n": 1}

    def crashing(*a, **k):
        if armed["n"]:
            armed["n"] -= 1
            raise KeyError("a crash below the request handler")
        return real(*a, **k)

    monkeypatch.setattr(serve_degrade, "plan", crashing)
    a, ap, b = make_pair(10, 10, seed=21)
    cfg = _cfg(workers=1, max_batch=1, batch_window_ms=0.0,
               crash_requeues=0, breaker_threshold=0)
    with Server(cfg) as srv:
        with pytest.raises(Rejected) as ei:
            srv.request(a, ap, b, timeout=60)
        assert ei.value.reason == "worker_crash"
        assert srv.request(a, ap, b, timeout=120).status == "ok"
        assert srv.health()["workers"]["alive"] == 1


def test_worker_crash_requeued_once_then_served(monkeypatch):
    from image_analogies_tpu_torch.serve import degrade as serve_degrade

    real = serve_degrade.plan
    armed = {"n": 1}

    def crashing(*a, **k):
        if armed["n"]:
            armed["n"] -= 1
            raise KeyError("a crash below the request handler")
        return real(*a, **k)

    monkeypatch.setattr(serve_degrade, "plan", crashing)
    a, ap, b = make_pair(10, 10, seed=22)
    cfg = _cfg(workers=1, max_batch=1, batch_window_ms=0.0,
               crash_requeues=1)
    with Server(cfg) as srv:
        resp = srv.request(a, ap, b, timeout=120)
    assert resp.status == "ok"
    np.testing.assert_array_equal(
        resp.bp, create_image_analogy(a, ap, b, _params()).bp)


# --------------------------------------------------- circuit breaker


def test_breaker_state_machine_with_fake_clock():
    from image_analogies_tpu_torch.serve.breaker import CircuitBreaker

    now = {"t": 0.0}
    br = CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: now["t"])
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"  # the success reset the streak
    br.record_failure()
    assert br.state == "open" and not br.allow()
    now["t"] = 11.0
    assert br.allow() and not br.allow()  # one half-open probe
    br.record_failure()
    assert br.state == "open"
    now["t"] = 22.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_trips_server_and_recovers():
    a, ap, b = make_pair(10, 10, seed=20)
    cfg = _cfg(workers=1, max_batch=1, batch_window_ms=0.0,
               request_retries=0, breaker_threshold=2,
               breaker_cooldown_s=30.0)
    with Server(cfg) as srv:
        failure.inject_failures(2)
        for _ in range(2):
            with pytest.raises(failure.InjectedFailure):
                srv.request(a, ap, b, timeout=60)
        assert srv._pool.breaker.state == "open"
        with pytest.raises(Rejected) as ei:
            srv.request(a, ap, b, timeout=60)
        assert ei.value.reason == "breaker_open"  # shed at admission
        assert srv.queue_depth == 0
        assert srv.health()["breakers"] == {"cpu": "open"}
        srv._pool.breaker._opened_at -= 60.0  # the cooldown, elapsed
        assert srv.request(a, ap, b, timeout=120).status == "ok"
        assert srv._pool.breaker.state == "closed"


def test_breaker_circuit_open_at_dispatch():
    a, ap, b = make_pair(10, 10, seed=23)
    cfg = _cfg(workers=1, max_batch=1, batch_window_ms=0.0,
               request_retries=0, breaker_threshold=1,
               breaker_cooldown_s=300.0)
    srv = Server(cfg)
    gate = threading.Event()
    orig_pop = srv._queue.pop_batch

    def gated_pop(*a_, **kw):
        batch = orig_pop(*a_, **kw)
        gate.wait(timeout=30)
        return batch

    srv._queue.pop_batch = gated_pop
    with srv:
        fut = srv.submit(a, ap, b)  # admitted while closed
        srv._pool.breaker.record_failure()  # threshold 1: open
        gate.set()
        with pytest.raises(Rejected) as ei:
            fut.result(timeout=60)
        assert ei.value.reason == "circuit_open"


def test_breaker_trip_dumps_the_flight_ring(tmp_path):
    """The breaker's trip seals a black box where the scope has a dump
    directory."""
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.obs import recorder

    scope = obs_metrics.ObsScope(scope_id="w0")
    scope.dump_dir = str(tmp_path)
    a, ap, b = make_pair(8, 8, seed=24)
    cfg = _cfg(params=_params(levels=1), workers=1, max_batch=1,
               batch_window_ms=0.0, request_retries=0, breaker_threshold=1)
    with Server(cfg, obs_scope=scope) as srv:
        failure.inject_failures(1)
        with pytest.raises(failure.InjectedFailure):
            srv.request(a, ap, b, timeout=60)
    dumps = recorder.list_dumps(str(tmp_path))
    assert len(dumps) == 1
    doc = recorder.load_dump(dumps[0])
    assert doc["reason"] == "breaker_open" and doc["scope"] == "w0"


# ----------------------------------------------- telemetry, selftest


def test_serve_records_and_spans_reach_the_run_log(tmp_path):
    log = str(tmp_path / "run.jsonl")
    params = _params(log_path=log)
    a, ap, b = make_pair(10, 10, seed=10)
    with Server(_cfg(params=params, workers=1)) as srv:
        srv.request(a, ap, b, timeout=120)
        with pytest.raises(DeadlineExceeded):
            srv.request(a, ap, b, deadline_s=0.0, timeout=60)
    recs = [json.loads(ln) for ln in open(log) if ln.strip()]
    run_ids = {r.get("run_id") for r in recs}
    assert len(run_ids) == 1 and None not in run_ids  # one run, stamped
    assert recs[0]["event"] == "run_manifest" and "serve" in recs[0]
    reqs = [r for r in recs if r.get("event") == "serve_request"]
    assert sorted(r["status"] for r in reqs) == ["ok", "timeout"]
    spans = [r for r in recs if r.get("event") == "span"]
    dispatch = [s for s in spans if s["name"] == "serve_dispatch"]
    assert len(dispatch) == 1 and dispatch[0]["request"] == 1
    # the engine's own level spans carry the request id (request_context)
    levels = [s for s in spans if s["name"] == "level"]
    assert levels and all(s.get("request") == 1 for s in levels)
    assert any(s["name"] == "serve_batch" for s in spans)
    end = recs[-1]
    assert end["event"] == "run_end"
    counters = end["metrics"]["counters"]
    assert counters["serve.accepted"] == 2
    assert counters["serve.completed"] == 1 and counters["serve.timeouts"] == 1
    costs = [r for r in recs if r.get("event") == "serve_cost"]
    assert len(costs) == 1 and costs[0]["status"] == "ok"


def test_health_and_tenants_documents():
    a, ap, b = make_pair(10, 10, seed=11)
    with Server(_cfg(workers=2)) as srv:
        client = Client(srv)
        assert client.request(a, ap, b, timeout=120).status == "ok"
        h = srv.health()
        t = srv.tenants_doc()
    assert h["ok"] and h["accepting"] and h["ready"]
    assert h["workers"]["total"] == 2 and h["workers"]["alive"] == 2
    assert h["slo"]["target"] == 0.99
    assert set(h["vitals"]) >= {"pid", "rss_bytes", "threads"}
    assert t["armed"] and t["recorded"] == 1 and len(t["tenants"]) == 1


def test_selftest_smoke_zero_drops_bit_identical():
    cfg = _cfg(workers=2, max_batch=4, batch_window_ms=25.0)
    summary = loadgen.selftest(cfg, 4, seed=0, shapes=((10, 10), (12, 12)))
    assert summary["rejected"] == 0
    assert summary["errors"] == 0 and summary["timeouts"] == 0
    assert summary["completed"] == 4 and summary["degraded"] == 0
    assert summary["bit_identical"] is True
    assert summary["p99_ms"] >= summary["p50_ms"] > 0
    assert summary["cost_rate"] > 0
    assert sum(int(v) for v in summary["batch_size_hist"].values()) == 4


def test_loadgen_mixed_deadline_load_accounts_for_everything():
    cfg = _cfg(workers=2, max_batch=2, batch_window_ms=5.0)
    summary = loadgen.selftest(cfg, 4, seed=1, deadline_ms=(10_000, None),
                               shapes=((10, 10),))
    assert summary["errors"] == 0
    assert (summary["completed"] + summary["degraded"]
            + summary["timeouts"] + summary["rejected"]) == 4
    assert summary["bit_identical"] is True


def test_cli_serve_selftest_exits_0(tmp_path, capsys, monkeypatch):
    from image_analogies_tpu_torch.cli import main

    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "tune.json"))
    rc = main(["serve", "--selftest", "3", "--workers", "1",
               "--max-batch", "3", "--batch-window-ms", "50",
               "--levels", "2", "--backend", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert "selftest: 3 requests" in captured.out
    assert "bit-identical to singleton dispatch: True" in captured.out
    summary = json.loads(captured.err.strip().splitlines()[-1])
    assert summary["errors"] == 0 and summary["completed"] == 3
    # the CLI persists the learned rate (cost_persist) under the port's key
    store = json.load(open(tmp_path / "tune.json"))
    assert "serve_cost|cpu|any" in json.dumps(store)


# ------------------------------------------------------ EDF ordering


def _mk_req(rid, key, deadline=None, age_s=0.0):
    from concurrent.futures import Future

    from image_analogies_tpu_torch.serve.types import Request

    req = Request(request_id=rid, a=None, ap=None, b=None, params=None,
                  key=(key,), future=Future())
    req.t_submit -= age_s
    if deadline is not None:
        req.deadline = req.t_submit + age_s + deadline
    return req


@pytest.mark.parametrize("ordering,expect", [(True, [3, 2, 1]),
                                             (False, [1, 2, 3])])
def test_edf_pop_order(ordering, expect):
    from image_analogies_tpu_torch.serve.queue import AdmissionQueue

    q = AdmissionQueue(8, deadline_ordering=ordering, age_bound_s=60.0)
    q.submit(_mk_req(1, "a"))
    q.submit(_mk_req(2, "b", deadline=9.0))
    q.submit(_mk_req(3, "c", deadline=0.5))
    assert [q.pop_batch(1, 0.0)[0].request_id for _ in range(3)] == expect


def test_aging_bound_prevents_starvation():
    from image_analogies_tpu_torch.serve.queue import AdmissionQueue

    q = AdmissionQueue(8, deadline_ordering=True, age_bound_s=5.0)
    q.submit(_mk_req(1, "a", age_s=10.0))
    q.submit(_mk_req(2, "b", deadline=0.1))
    assert q.pop_batch(1, 0.0)[0].request_id == 1
    assert q.pop_batch(1, 0.0)[0].request_id == 2


# ----------------------------------------------------- cost-model priors


def test_cost_prior_store_roundtrip(tmp_path, monkeypatch):
    from image_analogies_tpu_torch.tune import store as tune_store

    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "tune.json"))
    params = _params(levels=1)
    a, ap, b = make_pair(8, 8, seed=22)
    srv = Server(_cfg(params=params, workers=1, cost_persist=True)).start()
    assert srv.cost_prior_source == "default"
    srv.request(a, ap, b, timeout=120)
    learned = srv.cost_model.rate
    srv.shutdown()
    entry = tune_store.load_entries().get("serve_cost|cpu|any")
    assert entry is not None and entry["cost_rate"] == pytest.approx(learned)
    srv2 = Server(_cfg(params=params, workers=1)).start()
    try:
        assert srv2.cost_prior_source == "store"
        assert srv2.cost_model.rate == pytest.approx(learned)
        assert srv2.cost_model.real_samples == 0
    finally:
        srv2.shutdown()


def test_cost_persist_off_by_default(tmp_path, monkeypatch):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "tune.json"))
    a, ap, b = make_pair(8, 8, seed=23)
    with Server(_cfg(params=_params(levels=1), workers=1)) as srv:
        srv.request(a, ap, b, timeout=120)
    assert not os.path.exists(str(tmp_path / "tune.json"))


def test_cost_keys_and_no_packaged_rate(tmp_path, monkeypatch):
    """The port's key names its device class; no packaged rate ships (no
    TPU rate carries over), so a fresh server starts from the default."""
    from image_analogies_tpu_torch.serve import degrade as serve_degrade
    from image_analogies_tpu_torch.tune import tables as tune_tables

    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "empty.json"))
    assert tune_tables.COST_RATES == {}
    assert serve_degrade.cost_key(AnalogyParams(device="cpu")) == \
        "serve_cost|cuda|cpu"
    assert serve_degrade.cost_key(_params()) == "serve_cost|cpu|any"
    assert serve_degrade.load_prior(_params())[1] == "default"
    monkeypatch.setitem(tune_tables.COST_RATES, "cpu|any", 5e-9)
    assert serve_degrade.load_prior(_params()) == (5e-9, "packaged")


def test_seeded_cost_model_blends_first_sample():
    from image_analogies_tpu_torch.serve.degrade import CostModel

    seeded = CostModel(1e-3, seeded=True)
    seeded.observe(1.0, 2e-3)
    assert 1e-3 < seeded.rate < 2e-3
    fresh = CostModel()
    fresh.observe(1.0, 2e-3)
    assert fresh.rate == pytest.approx(2e-3)


# ------------------------------------------------------ across packages


def test_same_seeded_load_through_both_servers_gives_equal_bits():
    """The JAX ``Server(backend="cpu")`` and the port's on one seeded
    load, a deadline-expired request among them: equal B' arrays (tolerance
    0) and equal statuses."""
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.serve import Server as JServer
    from image_analogies_tpu.serve import ServeConfig as JServeConfig

    load = loadgen.make_load(5, ((10, 10), (12, 12)), seed=3)

    def drive(server_cls, cfg):
        out = []
        with server_cls(cfg) as srv:
            futs = [srv.submit(it["a"], it["ap"], it["b"],
                               deadline_s=0.0 if it["index"] == 2 else None)
                    for it in load]
            for fut in futs:
                try:
                    r = fut.result(timeout=120)
                    out.append((r.status, np.asarray(r.bp)))
                except Exception as exc:  # noqa: BLE001 - either package's
                    name = type(exc).__name__
                    out.append(("timeout" if name == "DeadlineExceeded"
                                else name, None))
        return out

    kw = dict(workers=2, max_batch=4, batch_window_ms=25.0)
    jout = drive(JServer, JServeConfig(params=JParams(backend="cpu",
                                                      levels=2), **kw))
    tout = drive(Server, ServeConfig(params=_params(), **kw))
    assert [s for s, _ in tout] == [s for s, _ in jout]
    assert [s for s, _ in tout] == ["ok", "ok", "timeout", "ok", "ok"]
    for (_, tb), (_, jb) in zip(tout, jout):
        if tb is not None:
            np.testing.assert_array_equal(tb, jb)


# ------------------------------------------------------------ locks


def test_serve_never_launches_a_kernel_itself():
    """serve/ is a host-side scheduler: no module of it imports torch,
    the kernels' wrappers or their build, or counts a launch; the card's
    work happens inside the engine alone."""
    import image_analogies_tpu_torch.serve as serve_pkg

    root = os.path.dirname(serve_pkg.__file__)
    scanned = set()
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        scanned.add(name)
        with open(os.path.join(root, name)) as f:
            src = f.read()
        for node in ast.walk(ast.parse(src)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            for mod in mods:
                assert mod.split(".")[0] not in ("torch", "triton"), (
                    name, mod)
                assert ".ops" not in mod and "backends.cuda" not in mod, (
                    name, mod)
        assert "LAUNCHES" not in src and "_build" not in src, name
        assert ".cuda." not in src, name
    assert {"server.py", "worker.py", "queue.py", "batcher.py",
            "degrade.py", "breaker.py", "policy.py", "loadgen.py",
            "types.py", "router.py", "transport.py", "fleet.py",
            "control.py", "worker_main.py"} <= scanned


def test_cli_serve_zipf_and_flash_crowd_load(capsys):
    """The selftest's traffic-model flags (soak/trace.py's arrival model):
    a Zipf style mix under a flash crowd resolves every request, bits
    equal."""
    from image_analogies_tpu_torch.cli import main

    rc = main(["serve", "--selftest", "4", "--levels", "1", "--backend",
               "cpu", "--zipf", "1.1", "--styles", "2", "--flash-crowd",
               "0,0.05,4", "--no-cost-persist", "--seed", "3"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    summary = json.loads(captured.err.strip().splitlines()[-1])
    assert summary["flash_crowd"] == {"t0": 0.0, "duration": 0.05,
                                      "mult": 4.0}
    assert sum(summary["style_hist"].values()) == 4
    assert summary["completed"] == 4 and summary["bit_identical"]
    with pytest.raises(ValueError, match="T0,DURATION,MULT"):
        loadgen.parse_flash_crowd("1,2")


# ------------------------------------------- counters under threads


class _SlowReads(dict):
    """A dict whose every read yields the interpreter for a moment: a
    read-modify-write of one entry (``d[k] += 1``) then interleaves with
    the other threads' unless a lock holds it from the read to the
    write."""

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        time.sleep(2e-5)
        return value


def test_launch_counts_and_fault_injector_hold_under_threads(monkeypatch):
    """The serve workers' shared state under threads, with the
    interleavings forced: the launch counts and the armed-fault count are
    dicts whose reads yield (``_SlowReads``) between the read and the
    write of every bump, and ``argmin_l2``'s card branch (its library, its
    stream and its workspace stood in for on the CPU) yields between
    fetching the merge workspace and enqueueing the kernel while another
    thread resets the workspaces.  With the locks no count is lost,
    exactly the armed faults fire and no launch is handed a dropped
    workspace; without any one of them (``match._LAUNCH_LOCK``,
    ``failure._INJECT_LOCK``, ``match._ARGMIN_LOCK``) the test fails."""
    from types import SimpleNamespace

    import torch

    from image_analogies_tpu_torch.ops import _build
    from image_analogies_tpu_torch.ops import match

    monkeypatch.setattr(match, "LAUNCHES", _SlowReads(match.LAUNCHES))
    monkeypatch.setattr(failure, "_INJECT", _SlowReads(failure._INJECT))
    match.reset_launch_counts()
    threads, per = 8, 100
    armed = threads * per // 3
    failure.inject_failures(armed)
    fired = []
    lock = threading.Lock()

    def work():
        n = 0
        for _ in range(per):
            match._count_launch("argmin_l2")
            try:
                failure.run_with_retry(lambda: None)
            except failure.InjectedFailure:
                n += 1
        with lock:
            fired.append(n)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in pool)
    assert match.LAUNCHES["argmin_l2"] == threads * per
    assert sum(fired) == armed and failure._INJECT["n"] == 0

    # argmin_l2's card branch against utils/failure.reset_device_state
    stream = 7

    def workspace(device, stream_, m):  # the real one, in host memory
        key = (device.index, stream_)
        ws = match._ARGMIN_WORKSPACE.get(key)
        if ws is None:
            ws = match._ARGMIN_WORKSPACE[key] = (
                torch.full((256 * match._ARGMIN_KEY_STRIDE,), -1,
                           dtype=torch.int64), torch.zeros(1, dtype=torch.int32))
        return ws

    dropped = []

    def launch(*args):  # ia_argmin_l2's arguments, in order
        keys_ptr, dev, stream_ = args[12], args[16], args[17]
        time.sleep(2e-4)  # the reset runs here unless the lock holds it
        ws = match._ARGMIN_WORKSPACE.get((dev, stream_))
        if ws is None or ws[0].data_ptr() != keys_ptr:
            dropped.append(keys_ptr)
        return 0

    monkeypatch.setattr(match, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(match, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(match, "_device_index", lambda t: 0)
    monkeypatch.setattr(match, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(match, "_argmin_workspace", workspace)
    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        ia_argmin_l2=launch))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(
                            cuda_stream=stream))
    q = torch.zeros((8, 4))
    dbp, dbn = torch.zeros((256, 4)), torch.zeros(256)
    stop = threading.Event()

    def resetter():
        while not stop.is_set():
            failure.reset_device_state()

    def launcher():
        for _ in range(50):
            match.argmin_l2(q, dbp, dbn)

    match._ARGMIN_WORKSPACE.clear()
    match.reset_launch_counts()
    reset = threading.Thread(target=resetter)
    reset.start()
    pool = [threading.Thread(target=launcher) for _ in range(4)]
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        stop.set()
        reset.join(timeout=120)
        match._ARGMIN_WORKSPACE.clear()
    assert not any(t.is_alive() for t in pool + [reset])
    assert match.LAUNCHES["argmin_l2"] == 4 * 50
    assert dropped == []
    match.reset_launch_counts()
