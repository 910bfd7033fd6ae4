"""The port's telemetry archive (``obs/archive.py``) and the hooks that
feed it, held to the JAX package's on the CPU.

- the JAX ``tests/test_archive.py`` archive cases on the port: a sealed
  archive round-trips verbatim; a flipped byte costs its record only and
  the segment is quarantined ``.corrupt``; compaction bounds the raw tier
  and keeps replay; the disarmed plane allocates nothing; the ceilings
  selftest, a ceiling alarm landing in a ``DecisionLog``, the vitals
  fallbacks; ``/archive/stats`` and ``/healthz`` vitals over HTTP;
- cross-replay: an archive written by the JAX package replays in the
  port to the same document (and the other way round), ``diff_replays``
  and ``render_diff`` equal;
- the hooks: a ledger decision lands as a ``decision`` record, a ceiling
  alarm as an ``anomaly`` record, the archive's bytes as the ceilings'
  ``archive.bytes`` series, an armed archive samples through the
  timeline's feeder;
- ``ia archive inspect|replay|diff`` with the JAX outputs and exit codes.

Every comparison is exact (equal documents, equal strings).
"""

import gc
import json
import os
import threading
import tracemalloc
import urllib.request

import pytest

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import archive as obs_archive
from image_analogies_tpu_torch.obs import ceilings as obs_ceilings
from image_analogies_tpu_torch.obs import ledger as obs_ledger
from image_analogies_tpu_torch.obs import timeline as obs_timeline
from image_analogies_tpu_torch.serve import Server, ServeConfig
from image_analogies_tpu_torch.serve import journal as serve_journal
from tests.conftest import make_pair


@pytest.fixture(autouse=True)
def _clean_planes(tmp_path, monkeypatch):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))
    yield
    for mod in (obs_archive, obs_ceilings, obs_timeline, obs_ledger):
        for _ in range(8):
            if mod.current() is None:
                break
            mod.disarm()


def _tl_doc(n):
    """A synthetic /timeline-shaped doc; the archive treats docs as
    opaque, so the round-trip contract is plain equality."""
    return {"armed": True, "window_s": 1.0, "series": {
        "w0:serve.completed": {"kind": "counter",
                               "points": [[float(n), float(n + 1)]]}},
        "anomalies": [], "seq": n}


# ------------------------------------------------ sealed round trip


def test_archive_round_trip_bit_identity(tmp_path):
    root = str(tmp_path / "ar")
    ar = obs_archive.TelemetryArchive(root, sample_interval_s=0.0)
    docs = [_tl_doc(i) for i in range(5)]
    for d in docs:
        assert ar.append("timeline", d) is True
    ar.append("tenants", {"armed": True, "tenants": [], "recorded": 3})
    ar.append("decision", {"site": "router", "verdict": "spill"})

    rd = obs_archive.TelemetryArchive(root)
    rep = rd.replay()
    assert rep["timeline"] == docs[-1]
    assert rep["tenants"]["recorded"] == 3
    assert rep["kinds"] == {"timeline": 5, "tenants": 1, "decision": 1}
    assert rep["decisions"] == [{"site": "router", "verdict": "spill"}]
    assert rd.history("timeline") == docs
    st = rd.stats()
    assert st["segments"] >= 1 and st["bytes"] > 0
    assert st["quarantined"] == 0


def test_flipped_byte_quarantines_and_keeps_valid_prefix(tmp_path):
    root = str(tmp_path / "ar")
    ar = obs_archive.TelemetryArchive(root, max_segment_bytes=1)
    docs = [_tl_doc(i) for i in range(5)]
    for d in docs:
        ar.append("timeline", d)
    segs = sorted(n for n in os.listdir(root) if n.endswith(".jsonl"))
    assert len(segs) == 5
    victim = os.path.join(root, segs[2])
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(victim, "wb") as f:
        f.write(bytes(raw))

    rd = obs_archive.TelemetryArchive(root)
    assert rd.history("timeline") == [docs[0], docs[1], docs[3], docs[4]]
    names = os.listdir(root)
    assert sum(1 for n in names if n.endswith(".corrupt")) == 1
    assert segs[2] not in names
    assert rd.stats()["quarantined"] == 1
    assert rd.replay()["timeline"] == docs[-1]


def test_compaction_bounds_disk_and_preserves_replay(tmp_path):
    root = str(tmp_path / "ar")
    ar = obs_archive.TelemetryArchive(
        root, max_segment_bytes=400, max_total_bytes=1600,
        sample_interval_s=0.0)
    n = 120
    for i in range(n):
        assert ar.append("timeline", _tl_doc(i)) is True
    st = ar.stats()
    assert st["compactions"] >= 1 and st["summary_segments"] >= 1
    raw = sum(os.path.getsize(os.path.join(root, f))
              for f in os.listdir(root) if f.startswith("archive-"))
    assert raw <= ar.max_total_bytes + ar.max_segment_bytes
    rep = obs_archive.TelemetryArchive(root).replay()
    assert rep["timeline"] == _tl_doc(n - 1)
    assert rep["kinds"]["timeline"] == n


def test_disarmed_archive_plane_allocates_nothing():
    assert obs_archive.current() is None
    doc = {"series": {"serve.qps": 1.0}}
    gc.collect()
    gc.disable()
    tracemalloc.start()
    try:
        for _ in range(2000):
            obs_archive.record("timeline", doc)
            obs_archive.sample()
        taken = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        gc.enable()
    obs_allocs = [t for t in taken.traces
                  if any("image_analogies_tpu_torch/obs/" in fr.filename
                         for fr in t.traceback)]
    assert len(obs_allocs) <= 8
    assert sum(t.size for t in obs_allocs) <= 1024


# ------------------------------------------------ across the packages


def _write(mod, root, n):
    ar = mod.TelemetryArchive(root, max_segment_bytes=500,
                              max_total_bytes=2000, sample_interval_s=0.0)
    for i in range(n):
        ar.append("timeline", _tl_doc(i), now=1000.0 + i)
        if i % 7 == 0:
            ar.append("tenants", {"armed": True, "recorded": i,
                                  "tenants": [{"tenant": f"t{i % 3}"}]},
                      now=1000.5 + i)
        if i % 11 == 0:
            ar.append("decision", {"site": "server", "verdict": "shed"},
                      now=1000.6 + i)
    ar.append("anomaly", {"series": "proc.rss_bytes", "kind": "ceiling"},
              now=2000.0)
    return ar


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archive_written_by_either_package_replays_in_the_other(
        tmp_path, writer):
    from image_analogies_tpu.obs import archive as jarchive

    root = str(tmp_path / "ar")
    _write(jarchive if writer == "jax" else obs_archive, root, 40)
    ours = obs_archive.TelemetryArchive(root).replay()
    theirs = jarchive.TelemetryArchive(root).replay()
    assert ours == theirs
    assert ours["timeline"] == _tl_doc(39)
    assert ours["kinds"]["timeline"] == 40 and ours["anomalies"]
    assert obs_archive.TelemetryArchive(root).history("tenants") == \
        jarchive.TelemetryArchive(root).history("tenants")


def test_same_appends_write_equal_files_in_both_packages(tmp_path):
    from image_analogies_tpu.obs import archive as jarchive

    clock = [5000.0]
    for name, mod in (("jax", jarchive), ("port", obs_archive)):
        ar = mod.TelemetryArchive(str(tmp_path / name),
                                  max_segment_bytes=300,
                                  max_total_bytes=900,
                                  clock=lambda: clock[0])
        for i in range(30):
            ar.append("timeline", _tl_doc(i), now=clock[0] + i)
    for fname in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes(), fname
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port"))


def test_diff_replays_and_render_diff_equal(tmp_path):
    from image_analogies_tpu.obs import archive as jarchive

    a = _write(obs_archive, str(tmp_path / "a"), 12).replay()
    b = _write(obs_archive, str(tmp_path / "b"), 30).replay()
    b["tenants"]["tenants"].append({"tenant": "only_b"})
    b["timeline"]["series"]["w0:serve.latency_ms"] = {
        "points": [[1.0, {"p50": 3.0, "p99": 9.0, "count": 4}]]}
    for x, y in ((a, b), (b, a), (a, a)):
        d = obs_archive.diff_replays(x, y)
        assert d == jarchive.diff_replays(x, y)
        assert obs_archive.render_diff(d) == jarchive.render_diff(d)
    assert obs_archive.diff_replays(a, a)["empty"] is True
    assert "tenant only_b" in obs_archive.render_diff(
        obs_archive.diff_replays(a, b))


# ------------------------------------------------------------ the hooks


def test_ledger_decision_lands_as_an_archive_record(tmp_path):
    obs_archive.arm(root=str(tmp_path / "ar"))
    obs_ledger.emit_decision("server", "shed", "quota", idem="k1",
                             tenant="t")
    obs_ledger.emit_decision("worker", "requeue", "worker_crash")
    rep = obs_archive.current().replay()
    assert rep["decisions"] == [
        {"event": "serve_decision", "site": "server", "verdict": "shed",
         "cause": "quota", "idem": "k1", "tenant": "t"},
        {"event": "serve_decision", "site": "worker",
         "verdict": "requeue", "cause": "worker_crash"}]
    obs_archive.disarm()
    obs_ledger.emit_decision("server", "shed", "quota")  # disarmed: none
    assert obs_archive.TelemetryArchive(
        str(tmp_path / "ar")).replay()["kinds"] == {"decision": 2}


def test_ceiling_alarm_lands_as_anomaly_and_archive_bytes_series(tmp_path):
    ar = obs_archive.arm(root=str(tmp_path / "ar"))
    ar.append("timeline", _tl_doc(0))
    now = [0.0]
    mon = obs_ceilings.CeilingMonitor(clock=lambda: now[0], cooldown_s=0.0)
    alarms = []
    for i in range(24):
        now[0] = float(i)
        alarms += mon.sample(
            extra={"proc.rss_bytes": float((512 << 20) + (4 << 20) * i)},
            now=float(i))
    assert alarms and alarms[0]["series"] == "proc.rss_bytes"
    rep = ar.replay()
    assert {"series": "proc.rss_bytes", "kind": "ceiling",
            "slope_per_s": alarms[0]["slope_per_s"]} in rep["anomalies"]
    pts = mon._dogs["archive.bytes"].points
    assert len(pts) == 24 and pts[0][1] > 0
    assert pts[-1][1] <= ar.stats()["bytes"]


def test_armed_archive_samples_through_the_timeline_feeder(tmp_path):
    """``arm`` registers a timeline feeder: the sampler's ticks seal the
    armed timeline's and the ledger's documents."""
    import time

    tl = obs_timeline.arm()
    obs_ledger.arm(capacity=8, tenant_k=4)
    ar = obs_archive.arm(root=str(tmp_path / "ar"), sample_interval_s=0.0)
    assert obs_archive._feed in obs_timeline._FEEDERS
    tl.start_sampler(interval_s=0.01)
    try:
        end = time.monotonic() + 30
        while time.monotonic() < end and \
                ar.replay()["kinds"].get("timeline", 0) < 2:
            time.sleep(0.01)
    finally:
        tl.stop_sampler()
    kinds = ar.replay()["kinds"]
    assert kinds.get("timeline", 0) >= 2 and kinds.get("tenants", 0) >= 2
    assert obs_archive.stats_doc()["armed"] is True
    obs_archive.disarm()
    assert obs_archive.stats_doc() == {"armed": False, "segments": 0,
                                       "bytes": 0}


# ------------------------------------------------ ceilings watchdogs


def test_ceilings_selftest_catches_seeded_leak():
    st = obs_ceilings.selftest()
    assert st["ok"], st
    assert st["first_alarm_tick"] <= st["budget_ticks"]
    assert st["flat_alarms"] == 0


def test_ceiling_alarm_lands_in_a_decision_log(tmp_path):
    dl = serve_journal.DecisionLog(
        str(tmp_path / serve_journal.DecisionLog.NAME))
    now = [0.0]
    mon = obs_ceilings.CeilingMonitor(
        clock=lambda: now[0], cooldown_s=0.0, decision_log=dl)
    for i in range(24):
        now[0] = float(i)
        mon.sample(
            extra={"proc.rss_bytes": float((512 << 20) + (4 << 20) * i)},
            now=float(i))
    recs = [r for r in dl.read() if r["site"] == "ceilings"]
    assert recs and recs[0]["verdict"] == "alarm"
    assert recs[0]["cause"] == "proc.rss_bytes_trend"
    assert recs[0].get("idem") is None
    # the JAX package's reader reads the port's decision log
    from image_analogies_tpu.serve import journal as jsj

    assert jsj.DecisionLog(dl.path).read() == dl.read()


def test_frozen_fallback_vitals_never_alarm(monkeypatch):
    frozen = {"pid": 4242, "rss_bytes": 512 << 20, "open_fds": None,
              "threads": 8}
    monkeypatch.setattr(obs_ceilings, "read_proc_vitals",
                        lambda: dict(frozen))
    now = [0.0]
    mon = obs_ceilings.CeilingMonitor(clock=lambda: now[0],
                                      cooldown_s=0.0)
    alarms = []
    for i in range(24):
        now[0] = float(i)
        alarms += mon.sample(now=float(i))
    assert alarms == []
    rpt = mon.report()["proc.rss_bytes"]
    assert rpt["alarms"] == 0 and rpt["slope_per_s"] == 0.0


# ------------------------------------------------ CLI offline readers


def _seed_archive(root, n=3):
    ar = obs_archive.TelemetryArchive(root, sample_interval_s=0.0)
    for i in range(n):
        ar.append("timeline", _tl_doc(i))
    ar.append("anomaly", {"series": "w0:serve.latency_ms",
                          "kind": "zscore"})
    return ar


def test_cli_archive_inspect_and_replay(tmp_path, capsys):
    from image_analogies_tpu.cli import main as jmain
    from image_analogies_tpu_torch.cli import main

    root = str(tmp_path / "ar")
    _seed_archive(root)
    assert main(["archive", "inspect", root]) == 0
    out = capsys.readouterr().out
    assert "segment(s)" in out and "timeline=3" in out

    assert main(["archive", "inspect", root, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["kinds"] == {"timeline": 3, "anomaly": 1}
    assert doc["quarantined"] == 0 and doc["segments"] == 1

    assert main(["archive", "replay", root]) == 0
    out = capsys.readouterr().out
    assert jmain(["archive", "replay", root]) == 0
    assert out == capsys.readouterr().out  # the JAX cockpit, verbatim
    assert "ia top" in out

    assert main(["archive", "replay", root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["timeline"] == _tl_doc(2)
    assert main(["archive", "inspect", str(tmp_path / "nope")]) == 2
    os.makedirs(tmp_path / "empty")
    assert main(["archive", "replay", str(tmp_path / "empty")]) == 2


def test_cli_archive_diff(tmp_path, capsys):
    from image_analogies_tpu.cli import main as jmain
    from image_analogies_tpu_torch.cli import main

    ra, rb = str(tmp_path / "a"), str(tmp_path / "b")
    _seed_archive(ra, n=2)
    _seed_archive(rb, n=4)
    for args in (["archive", "diff", ra, rb, "--json"],
                 ["archive", "diff", ra, rb]):
        assert main(args) == 0
        ours = capsys.readouterr().out
        assert jmain(args) == 0
        assert ours == capsys.readouterr().out
    assert main(["archive", "diff", ra, str(tmp_path / "nope")]) == 2


# ------------------------------------------------ live endpoints


def test_http_archive_stats_and_healthz_vitals(tmp_path):
    from image_analogies_tpu_torch.serve.http import serve_http

    a, ap, b = make_pair(10, 10, seed=42)
    cfg = ServeConfig(params=AnalogyParams(backend="cpu", levels=1),
                      workers=1)
    with Server(cfg) as srv:
        assert srv.request(a, ap, b, timeout=120).status == "ok"
        httpd = serve_http(srv, 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            with urllib.request.urlopen(base + "/archive/stats",
                                        timeout=5) as resp:
                disarmed = json.loads(resp.read().decode())
            obs_archive.arm(root=str(tmp_path / "ar"))
            try:
                obs_archive.current().append("timeline", _tl_doc(0))
                with urllib.request.urlopen(base + "/archive/stats",
                                            timeout=5) as resp:
                    armed = json.loads(resp.read().decode())
            finally:
                obs_archive.disarm()
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=5) as resp:
                health = json.loads(resp.read().decode())
        finally:
            httpd.shutdown()
    assert disarmed == {"armed": False, "segments": 0, "bytes": 0}
    assert armed["armed"] is True and armed["bytes"] > 0
    assert armed["appended"] == 1
    vitals = health["vitals"]
    assert vitals["rss_bytes"] and vitals["rss_bytes"] > 0
    assert vitals["threads"] and vitals["threads"] >= 1
