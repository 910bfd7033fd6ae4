"""The port's run-log readers (``obs/report.py``, ``obs/export.py``,
``obs/recorder.render_dump``) and the CLI that drives them (``ia report``,
``ia trace``, ``ia top``, ``ia blackbox``), held to the JAX package's.

Against the JAX package, exactly (equal strings, equal dicts):

- ``report``, ``report_json`` and ``to_chrome_trace`` on the JAX tests'
  fixture records: the solo and sharded logs of ``tests/test_obs.py``
  (their golden texts too), its compile/HBM log, the synthetic trace of
  ``tests/test_obs_device.py``, a log holding a record of every section
  the report has, and a log the JAX engine wrote in a metrics run (XLA's
  ``xla.*`` cost counters);
- ``render_dump`` on the same sealed flight-recorder dump.

The port's own logs: a CPU run in a metrics run whose kernel wrappers
count as they do on the card (``obs/device.py note_launch``) shows
``kernel.*`` in the compile/cost section, the port's launch geometry in
the tune section and ``torch_version`` in the manifest.

The CLI: ``ia report`` (text, ``--json``, a missing log), ``ia trace``,
``ia blackbox`` (newest, ``--all``, ``--last``, ``--json``, a damaged
dump, no dumps, no directory) and ``ia top --once`` against a live port
server (``/timeline`` and ``--tenants``), an unreachable one and
``--from-archive``, each with the JAX package's exit code.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from image_analogies_tpu_torch.obs import export as obs_export
from image_analogies_tpu_torch.obs import recorder as obs_recorder
from image_analogies_tpu_torch.obs import report as obs_report


@pytest.fixture(autouse=True)
def _own_stores(tmp_path, monkeypatch):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))
    monkeypatch.delenv("IA_CATALOG_DIR", raising=False)
    monkeypatch.delenv("IA_ARCHIVE_DIR", raising=False)


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return path


def _compile_hbm(path):
    """``tests/test_obs.py``'s compile/HBM records."""
    return _write(path, [
        {"event": "run_manifest", "backend": "tpu", "run_id": "d1",
         "seq": 0, "ts": 1.0},
        {"event": "compile", "name": "tpu.run_wavefront", "ms": 120.0,
         "flops": 2e9, "bytes": 1e8, "ok": True, "level": 0,
         "run_id": "d1", "seq": 1, "ts": 1.2},
        {"level": 0, "db_rows": 10, "pixels": 4, "ms": 10.0,
         "run_id": "d1", "seq": 2, "ts": 1.3},
        {"event": "hbm", "peaks": {"d0": 1 << 30}, "level": 0,
         "run_id": "d1", "seq": 3, "ts": 1.4},
        {"event": "run_end", "metrics": {
            "counters": {"compile.count": 1, "compile.cache_hits": 2,
                         "compile.ms": 120.0, "xla.flops": 6e9,
                         "xla.bytes": 3e8},
            "gauges": {"hbm.peak_bytes.d0": float(1 << 30)},
            "histograms": {}}, "run_id": "d1", "seq": 4, "ts": 1.5}])


def _every_section(path):
    """One run whose records reach every section of the report and every
    track of the trace, and a second, unstamped run."""
    rid = "all1"
    recs = [
        {"event": "run_manifest", "backend": "tpu", "strategy": "batched",
         "mesh": [1, 2], "levels": 2, "device_kind": "TPU v5e",
         "device_count": 4, "platform": "tpu", "jax_version": "0.9.0",
         "metrics": True, "tune_store": "/s.json", "tune_entries": 3},
        {"event": "tune_resolved", "key": "tpu|packed|f128|b4096",
         "tile_rows": 512, "packed_tile_cap": 8192,
         "packed_vmem_limit": 1 << 26, "origin": {"tile_rows": "store"}},
        {"event": "tune_store_error", "error": "bad json"},
        {"level": 1, "phase": "p1", "frame": 0, "db_rows": 50,
         "pixels": 64, "enqueue_ms": 3.0, "coherence_ratio": 0.25},
        {"event": "span", "name": "level", "level": 1, "phase": "p1",
         "wall_ms": 9.0},
        {"event": "coherence_ratios", "phase": "p1",
         "ratios": {"l1_f0": 0.5, "bad": 1.0}},
        {"event": "level_retry", "level": 1, "error": "Injected"},
        {"event": "compile", "name": "tpu.level", "ms": 30.0, "flops": 4e6,
         "bytes": 1e6, "level": 1, "ok": True},
        {"event": "serve_request", "request": 1, "status": "ok",
         "total_ms": 12.0, "batch_size": 2, "trace": "t0"},
        {"event": "serve_request", "request": 2, "status": "degraded",
         "total_ms": 30.0, "batch_size": 2, "trace": "t0",
         "worker": "w0"},
        {"event": "serve_request", "request": 3, "status": "timeout",
         "total_ms": 99.0},
        {"event": "serve_admit", "request": 1},
        {"event": "serve_degrade_decision", "request": 2},
        {"event": "serve_batch_lane", "lane": 0, "request": 1,
         "status": "ok"},
        {"event": "serve_replay", "action": "replay", "idem": "k1"},
        {"event": "serve_dedupe", "idem": "k1"},
        {"event": "serve_recovery", "entries": 3, "replayed": 2,
         "done": 1, "poisoned": 0, "unrecoverable": 0},
        {"event": "serve_cost", "tenant": "abcdef0123456789",
         "dispatch_ms": 7.5, "queue_ms": 1.0, "degrade_levels": [0],
         "retries": 1, "wire_bytes": 512},
        {"event": "serve_cost", "tenant": "ffff", "dispatch_ms": 2.5},
        {"event": "serve_decision", "site": "router", "verdict": "spill",
         "cause": "home_gated", "trace": "t1"},
        {"event": "catalog_prefetch", "style": "s1", "worker": "w1",
         "entries": 2, "bytes": 4096},
        {"event": "router_route", "idem": "k1", "worker": "w0"},
        {"event": "router_spill", "idem": "k2", "home": "w0", "to": "w1"},
        {"event": "router_rechain", "idem": "k3"},
        {"event": "router_death", "worker": "w0"},
        {"event": "router_handoff", "worker": "w0", "generation": 1,
         "recovered": {"entries": 2, "replayed": 1, "done": 1}},
        {"event": "ann_gate", "device": "TPU", "strategy": "wavefront",
         "ok": True, "mismatches": 0, "unexplained": 0},
        {"event": "ann_prefilter", "level": 0, "strategy": "wavefront",
         "source": "artifact", "top_m": 64, "proj_dims": 32,
         "db_rows": 400},
        {"event": "chaos_inject", "site": "level.dispatch",
         "kind": "transient"},
        {"event": "blackbox_dump", "reason": "process_death"},
        {"event": "watchdog_timeout", "level": 0},
        {"event": "soak_kill", "worker": "w0", "request": 9},
        {"event": "ceiling_alarm", "series": "proc.rss_bytes",
         "slope_per_s": 3e6, "threshold_per_s": 1e6, "value": 5e8},
        {"event": "hbm", "peaks": {"d1": 2 << 30}},
        {"event": "span", "name": "serve_batch", "wall_ms": 4.0,
         "trace": "t0"},
        {"event": "span", "name": "fetch", "wall_ms": 2.0},
        {"event": "run_end", "metrics": {
            "counters": {
                "devcache.hits": 5, "devcache.misses": 5,
                "devcache.upload_bytes": 1 << 21, "mesh.level_steps": 3,
                "mesh.psum_gather_bytes": 1 << 20, "fetch.bytes": 100,
                "compile.count": 2, "compile.ms": 60.0, "xla.flops": 8e6,
                "xla.bytes": 2e6, "tune.store_hits": 1,
                "tune.fallbacks": 2, "tune.env_overrides": 1,
                "serve.accepted": 3, "serve.rejected": 1,
                "serve.completed": 2, "serve.errors": 1,
                "serve.decision.spill": 1, "serve.poisoned": 1,
                "serve.journal.admitted": 3, "serve.journal.done": 2,
                "serve.journal.replayed": 2, "serve.journal.deduped": 1,
                "serve.journal.autocompact": 1,
                "serve.journal.autocompact_skipped": 1,
                "serve.process_deaths": 1, "obs.blackbox.dumps": 1,
                "serve.worker_crashes": 1, "serve.requeued": 1,
                "catalog.hbm.hits": 2, "catalog.hbm.misses": 1,
                "catalog.disk.hits": 1, "catalog.builds": 1,
                "catalog.quarantined": 1, "catalog.chaos_evictions": 1,
                "catalog.host.evictions": 1,
                "catalog.host.evicted_bytes": 2048,
                "catalog.disk.read_bytes": 4096,
                "catalog.warmed": 2, "catalog.prefetch.styles": 1,
                "router.requests": 4, "router.routed.w0": 3,
                "router.routed.w1": 1, "router.spills": 1,
                "router.deaths": 1, "router.handoffs": 1,
                "router.wire.binary": 4, "router.wire_bytes": 9000,
                "chaos.injected": 1, "chaos.injected.transient": 1,
                "chaos.site.level.dispatch": 1, "level_retry": 1,
                "watchdog.timeouts": 1, "ckpt.quarantined": 1,
                "obs.ceiling.alarms": 1,
                "obs.ceiling.proc.rss_bytes": 1,
                "pipeline.levels_prepped": 1,
                "pipeline.donated_levels": 1,
                "pipeline.prefetch_errors": 1, "slo.deadlined": 4,
                "slo.violations": 1, "batch.launches": 2,
                "batch.lanes": 6, "batch.lane_faults": 1,
                "batch.fallback_sequential.remap_divergence": 1,
                "ann.prefilter_used": 1, "ann.gate_ok": 1,
                "ann.artifact_hits": 1, "ann.quarantined": 1,
                "custom.thing": 7},
            "gauges": {"hbm.peak_bytes.d0": float(3 << 30),
                       "catalog.host.bytes": 8192.0,
                       "proc.rss_bytes": 5e8, "proc.open_fds": 12.0,
                       "proc.threads": 9.0, "pipeline.host_gap_ms": 1.5,
                       "pipeline.prep_ms": 4.0, "pipeline.wait_ms": 0.5,
                       "pipeline.host_hidden_ms": 3.0, "slo.target": 0.99,
                       "slo.burn_rate.fast": 2.0,
                       "batch.pad_waste_frac": 0.125, "ann.top_m": 64.0,
                       "ann.proj_dims": 32.0},
            "histograms": {"catalog.cold_start_ms": {
                "count": 1, "min": 5.0, "max": 5.0, "mean": 5.0}}}},
    ]
    for i, r in enumerate(recs):
        r.update(run_id=rid, seq=i, ts=10.0 + 0.01 * i)
    recs.append({"event": "span", "name": "level", "level": 0,
                 "wall_ms": 3.0, "ts": 11.0})
    return _write(path, recs)


def _fixtures():
    """name -> writer(path) of the JAX tests' records and this file's."""
    from tests.test_obs import _write_mesh_fixture, _write_solo_fixture
    from tests.test_obs_device import _write_synthetic

    return {"solo": _write_solo_fixture, "mesh": _write_mesh_fixture,
            "compile_hbm": _compile_hbm, "synthetic": _write_synthetic,
            "every_section": _every_section}


FIXTURES = ("solo", "mesh", "compile_hbm", "synthetic", "every_section")


def _same_as_jax(log):
    from image_analogies_tpu.obs import export as jexport
    from image_analogies_tpu.obs import report as jreport

    assert obs_report.report(log) == jreport.report(log)
    assert obs_report.report_json(log) == jreport.report_json(log)
    recs = obs_report.load_records(log)
    assert recs == jreport.load_records(log)
    assert obs_export.to_chrome_trace(recs) == jexport.to_chrome_trace(recs)


@pytest.mark.parametrize("name", FIXTURES)
def test_report_and_trace_equal_the_jax_ones_on_fixtures(name, tmp_path):
    log = str(tmp_path / f"{name}.jsonl")
    _fixtures()[name](log)
    _same_as_jax(log)


def test_report_goldens_of_the_jax_tests(tmp_path):
    from tests.test_obs import MESH_GOLDEN, SOLO_GOLDEN

    solo, mesh = str(tmp_path / "solo.jsonl"), str(tmp_path / "mesh.jsonl")
    _fixtures()["solo"](solo)
    _fixtures()["mesh"](mesh)
    assert obs_report.report(solo) == SOLO_GOLDEN
    assert obs_report.report(mesh) == MESH_GOLDEN
    with open(solo, "a") as f:
        f.write('{"event": "span", "name": "lev')  # a torn tail line
    assert obs_report.report(solo) == SOLO_GOLDEN


def test_every_section_renders(tmp_path):
    """The kitchen-sink log fills every section of the port's report."""
    log = _every_section(str(tmp_path / "all.jsonl"))
    text = obs_report.report(log)
    for head in ("manifest:", "per-level timing", "compile:", "xla cost",
                 "tune:", "pipeline:", "serving:", "tenants:",
                 "decisions:", "batched engine:", "catalog:",
                 "ann matcher:", "fleet:", "slo:", "ceilings:", "traces:",
                 "durability:", "chaos:", "soak:", "hbm peak:", "spans:",
                 "custom.thing"):
        assert head in text, head
    trace = obs_export.to_chrome_trace(obs_report.load_records(log))
    tids = {e["tid"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert {obs_export.HOST_TID, obs_export.DEVICE_TID,
            obs_export.COMPILE_TID, obs_export.SERVE_TID,
            obs_export.CHAOS_TID, obs_export.TRACE_TID_BASE} <= tids


@pytest.fixture(scope="module")
def jax_engine_log(tmp_path_factory):
    """A log the JAX engine wrote: two runs of one shape inside one
    metrics scope (XLA's compile and cost counters)."""
    from image_analogies_tpu.config import AnalogyParams
    from image_analogies_tpu.models.analogy import create_image_analogy
    from image_analogies_tpu.obs import trace as jtrace
    from tests.conftest import make_pair

    log = str(tmp_path_factory.mktemp("jaxlog") / "run.jsonl")
    a, ap, b = make_pair(20, 22, seed=3)
    params = AnalogyParams(levels=2, backend="tpu", metrics=True,
                           log_path=log)
    with jtrace.run_scope(params):
        create_image_analogy(a, ap, b, params)
        create_image_analogy(a, ap, b, params)
    return log


def test_jax_written_log_renders_as_the_jax_report(jax_engine_log):
    _same_as_jax(jax_engine_log)
    text = obs_report.report(jax_engine_log)
    assert "xla cost" in text and "kernel cost" not in text
    assert "jax_version" in text


@pytest.fixture()
def port_log(tmp_path, monkeypatch):
    """A port metrics run on the CPU whose kernel wrappers count as the
    card's do: each argmin_l2 / packed_best call notes its launch and
    work (``obs/device.py note_launch``)."""
    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.backends import cuda as bcuda
    from image_analogies_tpu_torch.config import AnalogyParams
    from image_analogies_tpu_torch.obs import device as obs_device
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from tests.conftest import make_pair

    real_argmin, real_packed = bcuda.argmin_l2, bcuda.packed_best

    def argmin_l2(q, dbp, dbn, *args, **kw):
        out = real_argmin(q, dbp, dbn, *args, **kw)
        obs_device.note_launch("argmin_l2", *obs_device.argmin_work(
            q.shape[0], dbp.shape[0], q.shape[1]))
        return out

    def packed_best(qa, w1, k, *args, **kw):
        out = real_packed(qa, w1, k, *args, **kw)
        obs_device.note_launch("packed_best", *obs_device.packed2k_work(
            qa.shape[0], w1.shape[0], k))
        return out

    monkeypatch.setattr(bcuda, "argmin_l2", argmin_l2)
    monkeypatch.setattr(bcuda, "packed_best", packed_best)
    log = str(tmp_path / "port.jsonl")
    a, ap, b = make_pair(24, 24, seed=5)
    params = AnalogyParams(levels=2, device="cpu", metrics=True,
                           log_path=log)
    with obs_trace.run_scope(params):
        create_image_analogy(a, ap, b, params)
    return log


def test_port_log_shows_kernel_counters(port_log):
    text = obs_report.report(port_log)
    doc = json.loads(obs_report.report_json(port_log))
    (run,) = doc["runs"]
    c = run["counters"]
    assert c["kernel.flops"] > 0 and c["launch.argmin_l2"] > 0
    assert run["compile"]["flops"] == c["kernel.flops"]
    assert run["compile"]["bytes"] == c["kernel.bytes"]
    assert "kernel cost" in text and "xla cost" not in text
    assert "kernel.flops" not in text  # shown in its section only
    assert "launch.argmin_l2" in text
    assert f"torch_version {run['manifest']['torch_version']}" in \
        " ".join(text.split())
    assert [r["level"] for r in run["levels"]] == [1, 0]
    assert all(r["device_ms"] > 0 for r in run["levels"])
    if run["tune"] and run["tune"]["configs"]:
        assert "chunks=" in text and "tile_rows=" not in text
    trace = obs_export.to_chrome_trace(obs_report.load_records(port_log))
    dev = [e for e in trace["traceEvents"]
           if e["tid"] == obs_export.DEVICE_TID and e["ph"] == "X"]
    host = [e for e in trace["traceEvents"]
            if e["tid"] == obs_export.HOST_TID and e["ph"] != "M"]
    assert len(dev) == 2 and host


# ------------------------------------------------------------------ CLI


def test_cli_report_and_trace(port_log, tmp_path, capsys):
    from image_analogies_tpu_torch.cli import main

    assert main(["report", port_log]) == 0
    assert "per-level timing" in capsys.readouterr().out
    assert main(["report", port_log, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["path"] == port_log and len(doc["runs"]) == 1
    assert main(["report", str(tmp_path / "missing.jsonl")]) == 2
    assert "no such log" in capsys.readouterr().err

    out = str(tmp_path / "trace.json")
    assert main(["trace", port_log, "-o", out]) == 0
    said = capsys.readouterr().out
    with open(out) as f:
        trace = json.load(f)
    assert f"{len(trace['traceEvents'])} events" in said
    assert main(["trace", str(tmp_path / "missing.jsonl"), "-o", out]) == 2


def _dump(dirpath, reason, n):
    rec = obs_recorder.FlightRecorder(capacity=8)
    for i in range(n):
        rec.record({"event": "serve_admit", "request": i, "ts": 100.0 + i,
                    "nested": {"x": 1}})
    rec.record({"event": "serve_process_death", "ts": 100.0 + n})
    return obs_recorder.dump(rec, str(dirpath), reason, scope_id="run:x")


def test_render_dump_equals_the_jax_renderer(tmp_path):
    from image_analogies_tpu.obs import recorder as jrecorder

    path = _dump(tmp_path, "process_death", 12)
    doc = obs_recorder.load_dump(path)
    assert doc == jrecorder.load_dump(path)
    for last in (0, 1, 3, 50):
        assert obs_recorder.render_dump(doc, last=last) == \
            jrecorder.render_dump(doc, last=last)
    text = obs_recorder.render_dump(doc, last=3)
    assert text.startswith("blackbox: reason=process_death scope=run:x "
                           "records=8 dropped=5")
    assert len(text.splitlines()) == 4


def test_cli_blackbox(tmp_path, capsys):
    from image_analogies_tpu_torch.cli import main

    first = _dump(tmp_path, "breaker_open", 2)
    second = _dump(tmp_path, "process_death", 3)
    assert main(["blackbox", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert os.path.basename(second) in out
    assert os.path.basename(first) not in out
    assert main(["blackbox", str(tmp_path), "--all", "--last", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("blackbox: reason=") == 2
    assert main(["blackbox", str(tmp_path), "--all", "--json"]) == 0
    docs = json.loads(capsys.readouterr().out)
    assert [d["reason"] for d in docs] == ["breaker_open", "process_death"]

    with open(second, "r+") as f:  # damage the newest dump's payload
        doc = json.load(f)
        doc["records"][0]["request"] = 999
        f.seek(0)
        json.dump(doc, f)
        f.truncate()
    assert main(["blackbox", str(tmp_path)]) == 2
    assert "seal mismatch" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["blackbox", str(empty)]) == 1
    assert main(["blackbox", str(tmp_path / "nope")]) == 2


def test_cli_top_once_against_a_live_port_server(capsys):
    from image_analogies_tpu_torch.chaos import drills
    from image_analogies_tpu_torch.cli import main
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.obs import timeline as obs_timeline
    from image_analogies_tpu_torch.serve import Server
    from image_analogies_tpu_torch.serve.http import serve_http

    rng = np.random.RandomState(42)
    a, ap, b = (rng.rand(10, 10).astype(np.float32) for _ in range(3))
    tl = obs_timeline.arm()
    try:
        with Server(drills.serve_config(workers=1, device="cpu")) as srv:
            assert srv.request(a, ap, b, timeout=120).status == "ok"
            srv.refresh_gauges()
            tl.sample_snapshot(obs_metrics.snapshot() or {}, worker="w0")
            httpd = serve_http(srv, 0)
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                base = f"http://127.0.0.1:{httpd.server_address[1]}"
                rc = main(["top", "--once", "--url", base])
                out = capsys.readouterr().out
                with urllib.request.urlopen(base + "/tenants",
                                            timeout=5) as resp:
                    tenants = json.loads(resp.read().decode())
                rc_t = main(["top", "--tenants", "--once", "--url", base])
                out_t = capsys.readouterr().out
            finally:
                httpd.shutdown()
    finally:
        obs_timeline.disarm()
    assert rc == 0
    for col in ("WORKER", "QPS", "P50ms", "P95ms", "QUEUE", "BREAKER",
                "HBM", "ANOM"):
        assert col in out
    assert "w0" in out
    assert rc_t == 0 and tenants["tenants"]
    for col in ("TENANT", "REQS", "QPS", "P95MS", "COST%", "DEGR"):
        assert col in out_t
    assert tenants["tenants"][0]["tenant"][:12] in out_t

    for args in (["top", "--once"], ["top", "--tenants", "--once"]):
        assert main(args + ["--url", "http://127.0.0.1:1"]) == 2
        assert "cannot fetch" in capsys.readouterr().err


def test_cli_top_from_archive(tmp_path, capsys):
    from image_analogies_tpu_torch.cli import main
    from image_analogies_tpu_torch.obs import archive as obs_archive

    root = str(tmp_path / "ar")
    ar = obs_archive.TelemetryArchive(root, sample_interval_s=0.0)
    for i in range(3):  # tests/test_archive.py's /timeline-shaped docs
        ar.append("timeline", {"armed": True, "window_s": 1.0, "series": {
            "w0:serve.completed": {"kind": "counter",
                                   "points": [[float(i), float(i + 1)]]}},
            "anomalies": [], "seq": i})
    assert main(["top", "--from-archive", root, "--once"]) == 0
    out = capsys.readouterr().out
    assert "ia top" in out and "WORKER" in out
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert main(["top", "--from-archive", empty, "--once"]) == 2
    assert "no archived timeline documents" in capsys.readouterr().err
