"""The port's worker transports (``serve/transport.py``,
``serve/worker_main.py``), held to the JAX package's on the CPU.

- ``CrashLoopSupervisor``: the same verdicts (``delay_s`` bits included)
  for the same sequence of deaths;
- the codec helpers (``_roundtrip_iaf2``, ``_roundtrip_json``,
  ``_wrap_response``) give the JAX helpers' arrays; the spawn document
  round-trips exactly and carries the params' ``device``;
- the router->worker hop reply (``X-IA-Worker-Hop``): both planes, the
  stats and the degraded detail, equal between the two packages' fronts;
- a subprocess fleet of two port children on ``device="cpu"``: one
  SIGKILLed with its requests admitted and queued, the replacement
  recovers them from the same directory (the stale lock swept, a fresh
  segment), every answer its singleton's bits, and no child left alive
  (``reap_orphans() == 0``); ``fleet_selftest`` over the subprocess
  transport;
- a child asked for the card on a machine without one never becomes
  ready (the parent sees it exit), and none is left behind;
- ``ia fleet --transport`` parses and refuses unknown transports.

Every test runs under a hard SIGALRM budget, and every child a test left
alive is SIGKILLed after it.  Comparisons are exact (tolerance 0).
"""

import dataclasses
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch import create_image_analogy
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.serve import FleetConfig, ServeConfig
from image_analogies_tpu_torch.serve import transport as tr
from image_analogies_tpu_torch.serve.fleet import Fleet
from image_analogies_tpu_torch.serve.types import Response

SIZE = 32


@pytest.fixture(autouse=True)
def _hard_timeout_and_reap(tmp_path, monkeypatch):
    """A per-test wall-clock ceiling (a lost readiness handshake or a
    wedged child fails one test, never the suite), a tune store of the
    test's own, and every child this process spawned SIGKILLed after the
    test."""
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))
    monkeypatch.delenv("IA_ARCHIVE_DIR", raising=False)

    def _boom(signum, frame):  # noqa: ARG001 - signal API
        tr.reap_orphans()
        raise TimeoutError("transport test exceeded its 240 s budget")

    old = signal.signal(signal.SIGALRM, _boom)
    signal.alarm(240)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    tr.reap_orphans()


def _planes(n=3, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(SIZE, SIZE).astype(np.float32)
    ap = rng.rand(SIZE, SIZE).astype(np.float32)
    return a, ap, [rng.rand(SIZE, SIZE).astype(np.float32)
                   for _ in range(n)]


def _params(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("levels", 2)
    return AnalogyParams(**kw)


def _subprocess_cfg(tmp_path, params=None, window_ms=20.0, **kw):
    return FleetConfig(
        serve=ServeConfig(params=params or _params(), workers=1,
                          max_batch=8, batch_window_ms=window_ms,
                          cost_persist=False, journal_fsync=False),
        size=2, vnodes=16, transport="subprocess",
        journal_root=str(tmp_path / "journals"), health_interval_s=0.1,
        death_checks=2, backoff_s=0.01, backoff_cap_s=0.05, **kw)


def test_crash_loop_supervisor_verdicts_equal():
    from image_analogies_tpu.serve import transport as jtr

    deaths = [("w0", 0.1), ("w0", 0.2), ("w0", 0.0), ("w1", 0.3),
              ("w0", 5.0), ("w1", 0.0), ("w1", 0.9), ("w2", 2.0),
              ("w1", 0.0), ("w0", 0.5)]
    for kw in (dict(window_s=1.0, threshold=3, backoff_s=0.05,
                    backoff_cap_s=0.4),
               dict(window_s=1.0, threshold=0, backoff_s=0.2,
                    backoff_cap_s=3.0)):
        sups = [tr.CrashLoopSupervisor(**kw), jtr.CrashLoopSupervisor(**kw)]
        got = [[s.on_death(w, up) for w, up in deaths] for s in sups]
        assert got[0] == got[1]
        for s in sups:
            s.reset("w1")
        assert sups[0].on_death("w1", 0.0) == sups[1].on_death("w1", 0.0)
    v = got[0]
    assert v[2]["gate"] is False  # threshold 0: never gated
    sup = tr.CrashLoopSupervisor(1.0, 3, 0.05, 0.4)
    assert [sup.on_death("w0", 0.0)["gate"] for _ in range(3)] == \
        [False, False, True]


def test_codec_helpers_equal_and_spawn_document_roundtrip():
    from image_analogies_tpu.serve import transport as jtr

    rng = np.random.RandomState(2)
    arrays = [rng.rand(5, 7).astype(np.float32),
              (rng.rand(4, 4) * 1e-30).astype(np.float32),
              np.array([[np.float32(1) / 3]], np.float32)]
    for ours, theirs in ((tr._roundtrip_iaf2, jtr._roundtrip_iaf2),
                         (tr._roundtrip_json, jtr._roundtrip_json)):
        for x, y, z in zip(arrays, ours(arrays), theirs(arrays)):
            assert y.dtype == np.float32
            np.testing.assert_array_equal(y, x)
            np.testing.assert_array_equal(y, z)
    for codec in ("iaf2", "json"):
        src = Future()
        out = tr._wrap_response(src, codec)
        resp = Response(request_id=3, bp=arrays[0], bp_y=arrays[0] * 2,
                        stats={"levels": 2}, batch_size=1, queue_ms=0.0,
                        dispatch_ms=0.0, total_ms=0.0)
        src.set_result(resp)
        got = out.result(timeout=5)
        np.testing.assert_array_equal(got.bp, resp.bp)
        np.testing.assert_array_equal(got.bp_y, resp.bp_y)
        failed = Future()
        wrapped = tr._wrap_response(failed, codec)
        failed.set_exception(RuntimeError("worker died"))
        with pytest.raises(RuntimeError, match="worker died"):
            wrapped.result(timeout=5)

    cfg = ServeConfig(params=_params(device="cuda", levels=3), workers=2,
                      max_batch=3, journal_dir="/tmp/jdir",
                      warmup_sizes=((8, 8), (16, 16)))
    doc = json.loads(json.dumps(tr.config_to_json(cfg)))
    assert doc["params"]["device"] == "cuda"  # a child runs where told
    assert tr.config_from_json(doc) == cfg
    pdoc = json.loads(json.dumps(tr.params_to_json(cfg.params)))
    assert tr.params_from_json(pdoc) == cfg.params
    # every field but the port's device is the JAX document's
    jdoc = jtr.params_to_json(jtr.params_from_json(
        {k: v for k, v in pdoc.items() if k != "device"}
        | {"backend": "tpu"}))
    assert set(pdoc) - set(jdoc) == {"device"}
    with pytest.raises(ValueError, match="unknown transport"):
        tr.make_transport("smoke")
    assert tr.make_transport("inproc").name == "inproc"
    assert tr.make_transport("subprocess").name == "subprocess"


def test_cli_fleet_transport_flag():
    from image_analogies_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["fleet", "--selftest", "2", "--transport", "subprocess"])
    assert args.transport == "subprocess"
    assert cli.build_parser().parse_args(["fleet"]).transport == "inproc"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["fleet", "--transport", "smoke"])


# ---------------------------------------------------------- the hop


def _hop(base, body, headers):
    req = urllib.request.Request(base + "/v1/analogy", data=body,
                                 headers=dict(headers,
                                              **{"X-IA-Worker-Hop": "1"}))
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers, r.read()


def test_worker_hop_reply_carries_both_planes_and_stats():
    """A hop-flagged POST gets the full Response back from either
    package's front: bp and bp_y in the frame (or the JSON), the stats
    and the degraded detail; the two packages' replies are equal."""
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.serve import Server as JServer
    from image_analogies_tpu.serve import ServeConfig as JServeConfig
    from image_analogies_tpu.serve.http import serve_http as jserve_http
    from image_analogies_tpu_torch.serve import Server, wire
    from image_analogies_tpu_torch.serve.http import serve_http

    a, ap, (b,) = _planes(1, seed=4)
    kw = dict(workers=1, max_batch=1, batch_window_ms=0.0,
              cost_persist=False)
    frame = wire.encode_planes([a, ap, b])
    f32 = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
    replies = []
    for srv, front in (
            (Server(ServeConfig(params=AnalogyParams(backend="cpu",
                                                     levels=2), **kw)),
             serve_http),
            (JServer(JServeConfig(params=JParams(backend="cpu", levels=2),
                                  **kw)), jserve_http)):
        with srv:
            httpd = front(srv, 0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                h, body = _hop(base, frame, f32)
                planes = wire.decode_planes(body)
                jh, jbody = _hop(base, json.dumps(
                    {"a": a.tolist(), "ap": ap.tolist(),
                     "b": b.tolist()}).encode(),
                    {"Content-Type": "application/json"})
                doc = json.loads(jbody)
            finally:
                httpd.shutdown()
                httpd.server_close()
        replies.append((planes, json.loads(h["X-IA-Stats"]),
                        h["X-IA-Degraded-Detail"], doc))
    (pp, ps, pd, pdoc), (jp, js, jd, jdoc) = replies
    assert len(pp) == len(jp) == 2
    for x, y in zip(pp, jp):
        np.testing.assert_array_equal(x, y)
    assert pd == jd == "null"
    # the per-level stats records: one a level in both
    assert isinstance(ps, list) and len(ps) == len(js) == 2
    assert [r["level"] for r in ps] == [r["level"] for r in js]
    assert {"bp", "bp_y", "stats", "degraded"} <= set(pdoc)
    assert set(pdoc) == set(jdoc)
    np.testing.assert_array_equal(np.asarray(pdoc["bp_y"], np.float32),
                                  pp[1])
    # the client-facing shape is one plane
    base_resp = create_image_analogy(a, ap, b, AnalogyParams(backend="cpu",
                                                             levels=2))
    np.testing.assert_array_equal(pp[0], base_resp.bp)


# ------------------------------------------------- subprocess workers


def _wait_until(pred, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_subprocess_sigkill_mid_queue_recovers_on_the_same_directory(
        tmp_path):
    """Two port children; three requests of one key sit in their home's
    batch window (admitted, not done) when it is SIGKILLed.  The health
    loop declares it dead and spawns generation 1 on the same journal
    directory: the stale lock is swept, a fresh segment opens, the three
    are replayed and every answer is its singleton's bits.  Afterwards no
    child is alive."""
    params = _params()
    fcfg = _subprocess_cfg(tmp_path, params, window_ms=3000.0)
    a, ap, bs = _planes(3, seed=1)
    refs = [create_image_analogy(a, ap, b, params) for b in bs]
    with Fleet(fcfg) as fl:
        pids = {w: h.pid for w, h in fl.workers.items()}
        assert os.getpid() not in pids.values()
        futs = [fl.submit(a, ap, b, idempotency_key=f"k{i}")
                for i, b in enumerate(bs)]
        homes = {e.wid for e in fl.router.pending_for("w0")
                 + fl.router.pending_for("w1")}
        assert len(homes) == 1
        (home,) = homes
        handle = fl.workers[home]

        def journal():
            return handle.health().get("journal") or {}

        assert _wait_until(lambda: journal().get("admitted", 0) == 3)
        before = journal()
        assert before.get("done", 0) == 0 and before["lock_pid"] == \
            handle.pid
        os.kill(handle.pid, signal.SIGKILL)
        resps = [f.result(timeout=120) for f in futs]
        assert len(fl.handoffs) == 1
        ho = fl.handoffs[0]
        after = fl.health()["workers"][home]
        counters = (obs_metrics.snapshot() or {}).get("counters") or {}
    assert ho["worker"] == home and ho["generation"] == 1
    assert (ho["recovered"]["replayed"], ho["recovered"]["done"],
            ho["recovered"]["unrecoverable"]) == (3, 0, 0)
    assert after["generation"] == 1 and after["pid"] != pids[home]
    assert after["journal"]["stale_lock_swept"] == 1
    assert after["journal"]["segment"] == 2
    assert after["journal"]["lock_pid"] == after["pid"]
    assert counters.get("router.deaths") == 1
    assert counters.get("router.handoffs") == 1
    for r, ref in zip(resps, refs):
        assert r.status == "ok"
        np.testing.assert_array_equal(r.bp, ref.bp)
        np.testing.assert_array_equal(r.bp_y, ref.bp_y)
    assert tr.live_workers() == []
    assert tr.reap_orphans() == 0
    log = (tmp_path / "journals" / home / "worker.log").read_text()
    assert "Traceback" not in log


def test_subprocess_fleet_selftest_bit_identity(tmp_path):
    """``fleet_selftest`` over the subprocess transport: requests routed
    to real children over the IAF2 HTTP hop come back the sequential
    baseline's bits; the children's counters federate by scrape."""
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve import loadgen

    fcfg = _subprocess_cfg(tmp_path)
    with obs_trace.run_scope(fcfg.serve.params):
        summary = loadgen.fleet_selftest(fcfg, 3, seed=3)
    assert summary["transport"] == "subprocess"
    assert summary["errors"] == 0 and summary["rejected"] == 0
    assert summary["bit_identical"] is True
    assert summary["codecs"].get("iaf2", 0) >= 3
    assert tr.reap_orphans() == 0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: a cuda child would start")
def test_cuda_child_on_a_cardless_box_never_becomes_ready(tmp_path):
    """A child asked for the card where there is none refuses in
    Server.start: the parent sees it exit before ready (never a worker
    serving on the CPU instead), and no child is left."""
    cfg = ServeConfig(params=AnalogyParams(levels=2),  # device "cuda"
                      journal_dir=str(tmp_path / "w0"), cost_persist=False)
    t = tr.make_transport("subprocess")
    with pytest.raises(RuntimeError, match="exited rc=.* before ready"):
        t.spawn("w0", 0, cfg, "iaf2", spawn_timeout_s=120.0)
    assert tr.live_workers() == [] and tr.reap_orphans() == 0
    log = (tmp_path / "w0" / "worker.log").read_text()
    assert "CUDA is not available" in log
    fl = Fleet(dataclasses.replace(
        _subprocess_cfg(tmp_path, AnalogyParams(levels=2)), size=1))
    with pytest.raises(RuntimeError, match="before ready"):
        fl.start()
    fl.shutdown()  # what start() armed before the spawn failed
    assert fl.workers == {}
    assert tr.live_workers() == [] and tr.reap_orphans() == 0
