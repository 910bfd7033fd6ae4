"""The port's serving front: the wire format (``serve/wire.py``), the
trace header (``obs/trace.py``), the Prometheus exposition and its
loopback server (``obs/live.py``), and the HTTP front (``serve/http.py``),
held to the JAX package's on the CPU.

- wire frames byte-equal between the packages, the JAX ``WireError``
  cases (``tests/test_pipeline.py``) with the same messages, and the IAT1
  context frames (``tests/test_obs_timeline.py``);
- ``parse_trace_header`` / ``format_trace_header`` equal on good and
  malformed headers;
- ``render_prometheus`` byte-equal on one fixed snapshot;
- the port's and the JAX ``serve_http`` answering the same JSON and
  binary POSTs with equal ``bp`` bits, status codes and error bodies
  (bad key 400, bad frame 400, unknown path 404), the trace header
  adopted and echoed, and equal ``/healthz`` key sets;
- ``obs/live.start_http_server`` serving the live registry, and ``ia
  metrics LOG`` rendering a run log's last snapshot.

Every comparison is exact (tolerance 0).  Both servers run
``backend="cpu"``; inputs are seeded with numpy.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import live as obs_live
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import Server, ServeConfig
from image_analogies_tpu_torch.serve import wire
from image_analogies_tpu_torch.serve.http import serve_http


@pytest.fixture(autouse=True)
def _own_tune_store(tmp_path, monkeypatch):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))


def _planes(seed, size=(12, 12)):
    rng = np.random.RandomState(seed)
    return [rng.rand(*size).astype(np.float32) for _ in range(3)]


# --------------------------------------------------------------- wire


def test_wire_frames_byte_equal_between_the_packages():
    from image_analogies_tpu.serve import wire as jwire

    rng = np.random.default_rng(0)
    arrays = [rng.random((5, 7)).astype(np.float32),
              np.zeros((3,), np.float32),
              np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              rng.random((4, 4))]  # float64 in: both cast to f32
    frame = wire.encode_planes(arrays)
    assert frame == jwire.encode_planes(arrays)
    ours, theirs = wire.decode_planes(frame), jwire.decode_planes(frame)
    for x, y, z in zip(arrays, ours, theirs):
        assert y.dtype == np.float32 and y.flags.writeable
        np.testing.assert_array_equal(y, np.asarray(x, np.float32))
        np.testing.assert_array_equal(y, z)
    assert (wire.MAGIC, wire.CONTENT_TYPE, wire.MAX_ARRAYS,
            wire.MAX_ELEMS) == (jwire.MAGIC, jwire.CONTENT_TYPE,
                                jwire.MAX_ARRAYS, jwire.MAX_ELEMS)


def _wire_error(mod, fn, arg):
    with pytest.raises(mod.WireError) as ei:
        getattr(mod, fn)(arg)
    return str(ei.value)


def test_wire_errors_equal_between_the_packages():
    from image_analogies_tpu.serve import wire as jwire

    good = wire.encode_planes([np.ones((2, 2), np.float32)])
    hostile = wire.MAGIC + np.array([1, 2, 1 << 20, 1 << 20],
                                    "<u4").tobytes()
    cases = [("decode_planes", b"NOPE" + good[4:], "magic"),
             ("decode_planes", good[:-3], "truncated"),
             ("decode_planes", good + b"\x00", "trailing"),
             ("decode_planes", good[:6], "magic"),
             ("decode_planes", good[:10], "truncated"),
             ("decode_planes", hostile, "exceeds"),
             ("encode_planes", [np.zeros(1, np.float32)]
              * (wire.MAX_ARRAYS + 1), "too many arrays")]
    for fn, arg, word in cases:
        msg = _wire_error(wire, fn, arg)
        assert word in msg
        assert msg == _wire_error(jwire, fn, arg)


def test_wire_context_frames_equal_and_strict():
    from image_analogies_tpu.serve import wire as jwire

    ctx = {"trace": "cafe0123", "parent_span": "http",
           "origin_request": "r42"}
    frame = wire.encode_context(ctx)
    assert frame == jwire.encode_context(ctx)
    assert frame.startswith(wire.CONTEXT_MAGIC)
    assert wire.decode_context(frame) == ctx
    assert wire.decode_context(wire.encode_context({})) == {}
    for bad in (b"IAXX" + frame[4:], frame[:-1], frame + b"x"):
        assert _wire_error(wire, "decode_context", bad) == \
            _wire_error(jwire, "decode_context", bad)
    assert _wire_error(wire, "encode_context", {"k": 1}) == \
        _wire_error(jwire, "encode_context", {"k": 1})


# -------------------------------------------------------- trace header


def test_trace_header_parse_and_format_equal_between_the_packages():
    from image_analogies_tpu.obs import trace as jtrace

    assert obs_trace.TRACE_HEADER == jtrace.TRACE_HEADER == "X-IA-Trace"
    headers = [None, "", "abc/-/-", "abc/http/r7", " abc/http/r7 ",
               "-/http/r7", "abc/http", "a/b/c/d", "ab c/-/-",
               "abc/../-", "a" * 64 + "/-/-", "a" * 65 + "/-/-",
               "abc/-/-\n"]
    for h in headers:
        assert obs_trace.parse_trace_header(h) == \
            jtrace.parse_trace_header(h), h
    ctxs = [{}, {"trace": "t1"}, {"trace": "t1", "parent_span": "http"},
            {"trace": "t1", "origin_request": 5},
            {"trace": "t1", "parent_span": "bad/span"},
            {"parent_span": "http"}]
    for ctx in ctxs:
        assert obs_trace.format_trace_header(ctx) == \
            jtrace.format_trace_header(ctx), ctx
    with obs_trace.request_context(trace="amb1", parent_span="x"):
        assert obs_trace.format_trace_header() == "amb1/x/-"
    assert obs_trace.format_trace_header() is None


# --------------------------------------------------------- exposition


_SNAPSHOT = {
    "counters": {"serve.completed": 7, "serve.journal.done": 3,
                 "obs.scrape.metrics.total": 2.5},
    "gauges": {"serve.queue_depth": 0, "serve.breaker.state": 1,
               "weird-name/x": float("nan"), "big": 1.25e17},
    "histograms": {"serve.latency_ms": {
        "count": 5, "sum": 71.5, "buckets": {"0": 1, "3": 2, "6": 2}},
        "empty": {"count": 0, "sum": 0.0, "buckets": {}}},
    "sketches": {"serve.latency_ms": {
        "alpha": 0.01, "count": 3, "zeros": 0, "sum": 33.0, "min": 1.0,
        "max": 20.0, "bins": {"0": 1, "60": 1, "150": 1},
        "collapsed": False}},
}


def test_render_prometheus_byte_equal_on_a_fixed_snapshot():
    from image_analogies_tpu.obs import live as jlive

    text = obs_live.render_prometheus(_SNAPSHOT)
    assert text == jlive.render_prometheus(_SNAPSHOT)
    assert obs_live.render_prometheus(None) == jlive.render_prometheus(None)
    assert "# HELP ia_serve_journal_done_total counter serve.journal.done" \
        in text
    assert 'ia_serve_latency_ms_bucket{le="+Inf"} 5' in text
    assert 'ia_serve_latency_ms_q{quantile="0.999"}' in text
    assert obs_live.CONTENT_TYPE == jlive.CONTENT_TYPE


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_live_exposition_server_serves_the_registry_and_healthz():
    from image_analogies_tpu_torch.obs import metrics as obs_metrics

    with obs_trace.run_scope(AnalogyParams(device="cpu", metrics=True)):
        obs_metrics.inc("serve.journal.done", 2)
        httpd = obs_live.start_http_server(0)
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            code, headers, body = _get(base + "/metrics")
            hz_code, _, hz = _get(base + "/healthz")
            nf_code, _, nf = _get(base + "/nope")
            ar_code, _, ar = _get(base + "/archive/stats")
        finally:
            obs_live.stop_http_server(httpd)
    assert httpd.server_address[0] == "127.0.0.1"  # loopback only
    assert code == 200 and headers["Content-Type"] == obs_live.CONTENT_TYPE
    assert "ia_serve_journal_done_total 2" in body.decode()
    health = json.loads(hz)
    assert hz_code == 200 and health["ok"] and health["active_run"]
    assert set(health) == {"ok", "active_run", "run_id", "uptime_s",
                           "vitals"}
    assert (nf_code, json.loads(nf)) == (404, {"error": "not_found"})
    assert ar_code == 200 and json.loads(ar)["armed"] is False


def test_cli_metrics_renders_a_run_logs_last_snapshot(tmp_path, capsys):
    from image_analogies_tpu.obs import live as jlive
    from image_analogies_tpu_torch.cli import main

    log = tmp_path / "run.jsonl"
    with open(log, "w") as f:
        f.write(json.dumps({"event": "run_manifest", "run_id": "r1"}) + "\n")
        f.write(json.dumps({"event": "run_end", "run_id": "r1",
                            "metrics": _SNAPSHOT}) + "\n")
        f.write('{"event": "span", "torn')  # a preempted run's tail
    assert main(["metrics", str(log)]) == 0
    out = capsys.readouterr().out
    assert out == jlive.render_prometheus(jlive.snapshot_from_log(str(log)))
    assert obs_live.health_from_log(str(log)) == \
        jlive.health_from_log(str(log))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert main(["metrics", str(empty)]) == 1
    assert main(["metrics", str(tmp_path / "missing.jsonl")]) == 2


# ----------------------------------------------------------- HTTP front


class _Front:
    """A server behind its loopback front, of either package."""

    def __init__(self, server, serve_http_fn):
        self.srv = server.start()
        self.httpd = serve_http_fn(self.srv, 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def post(self, body, headers):
        req = urllib.request.Request(self.base + "/v1/analogy", data=body,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.shutdown()


@pytest.fixture
def fronts(tmp_path):
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.serve import Server as JServer
    from image_analogies_tpu.serve import ServeConfig as JServeConfig
    from image_analogies_tpu.serve.http import serve_http as jserve_http

    kw = dict(workers=1, max_batch=1, batch_window_ms=0.0,
              journal_fsync=False)
    port = _Front(Server(ServeConfig(
        params=AnalogyParams(backend="cpu", levels=2),
        journal_dir=str(tmp_path / "pj"), **kw)), serve_http)
    jax = _Front(JServer(JServeConfig(
        params=JParams(backend="cpu", levels=2),
        journal_dir=str(tmp_path / "jj"), **kw)), jserve_http)
    yield port, jax
    port.close()
    jax.close()


def test_both_fronts_answer_the_same_posts_with_equal_bits_and_errors(
        fronts):
    port, jax = fronts
    a, ap, b = _planes(3)
    frame = wire.encode_planes([a, ap, b])
    f32 = {"Content-Type": wire.CONTENT_TYPE}
    cases = [
        # JSON in, JSON out
        (json.dumps({"a": a.tolist(), "ap": ap.tolist(), "b": b.tolist(),
                     "idempotency_key": "k-json"}).encode(),
         {"Content-Type": "application/json"}),
        # binary in, binary out, trace adopted
        (frame, dict(f32, Accept=wire.CONTENT_TYPE,
                     **{"X-IA-Idempotency-Key": "k-bin",
                        "X-IA-Trace": "feed01/-/-"})),
        # binary in, JSON out
        (frame, dict(f32, **{"X-IA-Idempotency-Key": "k-mix"})),
        # the request's own params document (the JAX format)
        (json.dumps({"a": a.tolist(), "ap": ap.tolist(), "b": b.tolist(),
                     "params": {"backend": "cpu", "levels": 1}}).encode(),
         {}),
    ]
    planes = []
    for body, headers in cases:
        got = [front.post(body, headers) for front in (port, jax)]
        (pc, ph, pb), (jc, jh, jb) = got
        assert pc == jc == 200
        if ph["Content-Type"] == wire.CONTENT_TYPE:
            assert jh["Content-Type"] == wire.CONTENT_TYPE
            (pp,), (jp,) = wire.decode_planes(pb), wire.decode_planes(jb)
            assert ph["X-IA-Trace"] == jh["X-IA-Trace"] == "feed01/http/-"
            assert ph["X-IA-Status"] == jh["X-IA-Status"] == "ok"
            assert ph["X-IA-Degraded"] == jh["X-IA-Degraded"] == "0"
        else:
            pd, jd = json.loads(pb), json.loads(jb)
            assert set(pd) == set(jd)
            assert pd["status"] == jd["status"] == "ok"
            assert ph["X-IA-Trace"] == f"{pd['trace']}/http/-"
            pp, jp = (np.asarray(pd["bp"], np.float32),
                      np.asarray(jd["bp"], np.float32))
        np.testing.assert_array_equal(pp, jp)
        planes.append(pp)
    np.testing.assert_array_equal(planes[0], planes[1])
    # a retried key answers from the journal: the same bits again
    code, _, body = port.post(frame, dict(f32, Accept=wire.CONTENT_TYPE,
                                          **{"X-IA-Idempotency-Key":
                                             "k-bin"}))
    assert code == 200
    np.testing.assert_array_equal(wire.decode_planes(body)[0], planes[1])

    errors = [
        (frame, dict(f32, **{"X-IA-Idempotency-Key": "../etc"})),
        (json.dumps({"a": [[0.5]], "ap": [[0.5]], "b": [[0.5]],
                     "idempotency_key": "a/b"}).encode(), {}),
        (frame[:-3], f32),
        (b"NOPE" + frame[4:], f32),
        (wire.encode_planes([a, ap]), f32),
        (b"{not json", {"Content-Type": "application/json"}),
        (json.dumps({"a": [[0.5]]}).encode(), {}),
    ]
    for body, headers in errors:
        (pc, ph, pb), (jc, jh, jb) = [front.post(body, headers)
                                      for front in (port, jax)]
        assert pc == jc == 400
        assert json.loads(pb) == json.loads(jb)
        assert json.loads(pb)["error"] == "bad_request"
    for path in ("/nope", "/v2/analogy"):
        got = [_get(front.base + path) for front in (port, jax)]
        assert got[0][0] == got[1][0] == 404
        assert json.loads(got[0][2]) == json.loads(got[1][2])
        req = [urllib.request.Request(front.base + path, data=b"{}")
               for front in (port, jax)]
        codes = []
        for r in req:
            try:
                urllib.request.urlopen(r, timeout=30)
            except urllib.error.HTTPError as e:
                codes.append((e.code, json.loads(e.read())))
        assert codes[0] == codes[1] == (404, {"error": "not_found"})


def test_both_fronts_health_and_scrape_routes(fronts):
    port, jax = fronts
    a, ap, b = _planes(4)
    frame = wire.encode_planes([a, ap, b])
    for front in (port, jax):
        code, _, _ = front.post(frame, {"Content-Type": wire.CONTENT_TYPE,
                                        "X-IA-Idempotency-Key": "hz"})
        assert code == 200
    (pc, _, pb), (jc, _, jb) = [_get(f.base + "/healthz")
                                for f in (port, jax)]
    ph, jh = json.loads(pb), json.loads(jb)
    assert pc == jc == 200
    assert set(ph) == set(jh)
    assert set(ph["journal"]) == set(jh["journal"])
    assert ph["journal"]["done"] == jh["journal"]["done"] == 1
    for path in ("/metrics", "/timeline", "/tenants", "/archive/stats"):
        (pc, ph, pb), (jc, jh, jb) = [_get(f.base + path)
                                      for f in (port, jax)]
        assert pc == jc == 200, path
        assert ph["Content-Type"] == jh["Content-Type"], path
        if path != "/metrics":
            assert set(json.loads(pb)) == set(json.loads(jb)), path
    metrics = _get(port.base + "/metrics")[2].decode()
    assert "serve.journal.done" in metrics and "serve.queue_depth" in metrics
    assert _get(port.base + "/metrics.json")[0] == 404
    assert _get(port.base + "/timeline?window=x")[0] == 400
    assert port.httpd.server_address[0] == "127.0.0.1"


def test_metrics_port_serves_the_live_registry_during_a_run(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """``--metrics-port`` (every engine command's flag, as in the JAX
    CLI): the run's live registry is scraped mid-run through the bound
    loopback port, which the command prints to stderr; the flag implies
    ``--metrics``."""
    from image_analogies_tpu_torch import cli as tcli
    from image_analogies_tpu_torch.backends import cuda as backends_cuda

    rng = np.random.RandomState(5)
    paths = {}
    for name in ("a", "ap", "b"):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], rng.rand(12, 12).astype(np.float32))
    scraped = {}
    real = backends_cuda.argmin_l2

    def scrape_mid_run(*args, **kw):  # the run's first anchor scan
        if not scraped:
            port = int(capsys.readouterr().err.split("127.0.0.1:")[1]
                       .split("/")[0])
            base = f"http://127.0.0.1:{port}"
            scraped["metrics"] = _get(base + "/metrics")
            scraped["healthz"] = _get(base + "/healthz")
        return real(*args, **kw)

    monkeypatch.setattr(backends_cuda, "argmin_l2", scrape_mid_run)
    rc = tcli.main(["run", "--mode", "filter", "--a", paths["a"], "--ap",
                    paths["ap"], "--b", paths["b"], "--out",
                    str(tmp_path / "out.npy"), "--levels", "1",
                    "--device", "cpu", "--metrics-port", "0"])
    assert rc == 0
    code, headers, body = scraped["metrics"]
    assert code == 200 and headers["Content-Type"] == obs_live.CONTENT_TYPE
    assert body.decode().startswith("# HELP ia_")  # the run's live counters
    assert json.loads(scraped["healthz"][2])["active_run"] is True
    args = tcli.build_parser().parse_args(
        ["serve", "--selftest", "1", "--metrics-port", "0", "--http", "0",
         "--journal", "j", "--archive", "ar"])
    assert (args.metrics_port, args.http, args.journal, args.archive) == (
        0, 0, "j", "ar")
