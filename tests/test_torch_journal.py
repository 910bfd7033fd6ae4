"""The port's write-ahead request journal (``serve/journal.py``) and the
server's durability plane (``Server.kill`` / ``recover``), held to the JAX
package's on the CPU.

- the JAX ``tests/test_journal.py`` invariants on the port: replay folds
  states in admit order; a torn tail or a flipped byte costs the damaged
  suffix only (the file quarantined ``.corrupt``); a corrupt response
  spill degrades the key to not-done, a corrupt payload spill makes it
  unrecoverable, never fatal; compaction keeps final states; the key
  charset; concurrent admit spills; compaction refused while active;
  poison sheds before the breaker; crash exhaustion persists across a
  restart (a worker crashed by a patched ``_run_batch``: the port's chaos
  plane is ROADMAP Queue 1 item 10d); duplicates dedupe; the disabled
  path never touches the module; the journaled selftest dedupes;
- across the packages: ``idem_key`` equal; a journal written by either
  package replays in the other to the same keys, states, order and
  dispatch counts; the same calls write equal lines once ``ts`` and
  ``seal`` are dropped; ``reconstruct`` and ``render_why`` equal on one
  JAX-written journal; four admitted requests of a killed server recover
  to the same bits in either package's server, whichever wrote the
  journal.

Every comparison is exact (tolerance 0: equal bits, equal strings).
Inputs are seeded with numpy; both servers run ``backend="cpu"``.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import Rejected, Server, ServeConfig
from image_analogies_tpu_torch.serve import journal as sj
from image_analogies_tpu_torch.serve import loadgen
from image_analogies_tpu_torch.serve.types import Response
from image_analogies_tpu_torch.serve.worker import WorkerPool


@pytest.fixture(autouse=True)
def _own_tune_store(tmp_path, monkeypatch):
    """The cost model's prior comes from the tune store: each test reads
    a store of its own."""
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))


def _planes(seed=0, size=(6, 6)):
    rng = np.random.RandomState(seed)
    h, w = size
    return (rng.rand(h, w).astype(np.float32),
            rng.rand(h, w).astype(np.float32),
            rng.rand(h, w).astype(np.float32))


def _resp(rid, bp, bp_y=None):
    return Response(request_id=rid, bp=bp,
                    bp_y=bp_y if bp_y is not None else bp,
                    stats={"levels": 1}, batch_size=1, queue_ms=0.0,
                    dispatch_ms=0.0, total_ms=0.0)


def _params(**kw):
    """The JAX drills' small CPU engine (``chaos.drills.image_params``)."""
    kw.setdefault("levels", 1)
    return AnalogyParams(backend="cpu", patch_size=3, coarse_patch_size=3,
                         metrics=True, **kw)


def _cfg(workers=1, **kw):
    """The JAX drills' serve config (``chaos.drills.serve_config``)."""
    kw.setdefault("batch_window_ms", 2.0)
    kw.setdefault("crash_requeues", 1)
    return ServeConfig(params=_params(), queue_depth=64, max_batch=4,
                       workers=workers, request_retries=2,
                       breaker_threshold=5, drain_timeout_s=60.0,
                       journal_fsync=False, **kw)


def _journal(tmp_path, name="j"):
    return sj.RequestJournal(str(tmp_path / name), fsync=False)


def _admit(jr, idem, rid=1, seed=0):
    a, ap, b = _planes(seed)
    jr.record_admit(idem, rid, a, ap, b, _params(), None, "key")
    return a, ap, b


# ------------------------------------------------------- core replay


def test_idem_key_is_deterministic_and_content_sensitive_and_jax_equal():
    from image_analogies_tpu.serve import journal as jsj

    _, _, b = _planes(0)
    assert sj.idem_key("k", b) == sj.idem_key("k", b.copy())
    assert sj.idem_key("k", b) != sj.idem_key("other", b)
    b2 = b.copy()
    b2[0, 0] += 1.0
    assert sj.idem_key("k", b) != sj.idem_key("k", b2)
    for key, plane in (("k", b), ("other", b2),
                       ("a|b|c", np.zeros((3, 5), np.float32))):
        assert sj.idem_key(key, plane) == jsj.idem_key(key, plane)
    assert sj.response_digest(b, b2) == jsj.response_digest(b, b2)


def test_roundtrip_replay_folds_states_in_admit_order(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _, _, b = _admit(jr, "aa", rid=1, seed=1)
    jr.record_dispatched("aa")
    jr.record_done("aa", _resp(1, b))
    _admit(jr, "bb", rid=2, seed=2)
    jr.record_dispatched("bb")
    _admit(jr, "cc", rid=3, seed=3)
    jr.record_poisoned("cc")
    jr.close()

    jr2 = _journal(tmp_path)  # a restarted process replays the history
    rep = jr2.replay()
    assert rep.order == ["aa", "bb", "cc"]
    assert rep.quarantined == 0
    assert rep.entries["aa"].done is not None
    assert rep.entries["bb"].dispatched == 1
    assert not rep.entries["bb"].complete
    assert rep.entries["cc"].poisoned
    assert [e.idem for e in rep.incomplete] == ["bb"]
    got = jr2.lookup_done("aa")
    assert got is not None and got.request_id == 1
    assert np.array_equal(got.bp, b)
    assert jr2.is_poisoned("cc")
    payload = jr2.load_payload("bb", device="cpu")
    assert payload is not None
    assert np.array_equal(payload[2], _planes(2)[2])
    assert payload[3] == _params().replace(device="cpu")


def test_duplicate_done_lines_fold_once(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _, _, b = _admit(jr, "dd", rid=1, seed=4)
    jr.record_done("dd", _resp(1, b))
    jr.record_done("dd", _resp(1, b))  # duplicate append
    jr.close()
    jr2 = _journal(tmp_path)
    rep = jr2.replay()
    assert len(rep.entries) == 1 and rep.incomplete == []
    assert jr2.inspect()["states"] == {"done": 1}


def test_payload_spill_names_no_device_and_recovers_on_the_callers(tmp_path):
    """The spill's params are the JAX document: no ``device`` key and the
    device matcher named ``tpu``; a recovered request runs on the device
    the caller names, even when a handcrafted spill names another."""
    jr = _journal(tmp_path)
    a, ap, b = _planes(1)
    jr.record_admit("dev", 1, a, ap, b,
                    AnalogyParams(levels=1, device="cuda:3"), None, "key")
    with np.load(jr.payload_path("dev")) as z:
        doc = json.loads(str(z["params"]))
    assert "device" not in doc and doc["backend"] == "tpu"
    got = jr.load_payload("dev", device="cpu")[3]
    assert (got.device, got.backend) == ("cpu", "cuda")
    doc["device"] = "cuda:3"
    assert sj.params_from_doc(doc, "cpu").device == "cpu"


# ---------------------------------------------- damage + quarantine


def test_torn_tail_keeps_valid_prefix_and_quarantines(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _admit(jr, "p1", rid=1, seed=1)
    _admit(jr, "p2", rid=2, seed=2)
    jr.close()
    (seg,) = jr._segments()
    with open(seg) as f:
        whole = f.read()
    with open(seg, "w") as f:  # a death mid-append
        f.write(whole[:len(whole) - 10])
    rep = _journal(tmp_path).replay()
    assert rep.quarantined == 1
    assert os.path.exists(seg + ".corrupt")
    assert rep.order == ["p1"]
    rep2 = _journal(tmp_path).replay()  # the rewrite replays cleanly
    assert rep2.quarantined == 0 and rep2.order == ["p1"]


def test_flipped_byte_fails_seal_and_quarantines(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _admit(jr, "q1", rid=1, seed=1)
    _admit(jr, "q2", rid=2, seed=2)
    jr.close()
    (seg,) = jr._segments()
    with open(seg) as f:
        lines = f.readlines()
    lines[1] = lines[1].replace('"idem":"q2"', '"idem":"qX"')
    with open(seg, "w") as f:
        f.writelines(lines)
    rep = _journal(tmp_path).replay()
    assert rep.quarantined == 1
    assert os.path.exists(seg + ".corrupt")
    assert rep.order == ["q1"]


def test_corrupt_response_spill_degrades_to_not_done(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _, _, b = _admit(jr, "rr", rid=1, seed=5)
    jr.record_done("rr", _resp(1, b))
    jr.close()
    rpath = jr.response_path("rr")
    with open(rpath, "r+b") as f:
        f.seek(os.path.getsize(rpath) // 2)
        f.write(b"\xff" * 32)
    jr2 = _journal(tmp_path)
    jr2.replay()
    assert jr2.lookup_done("rr") is None
    assert os.path.exists(rpath + ".corrupt")
    assert not os.path.exists(rpath)


def test_corrupt_payload_spill_is_unrecoverable_not_fatal(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _admit(jr, "uu", rid=1, seed=6)
    jr.close()
    ppath = jr.payload_path("uu")
    with open(ppath, "r+b") as f:
        f.seek(os.path.getsize(ppath) // 2)
        f.write(b"\x00" * 32)
    jr2 = _journal(tmp_path)
    jr2.replay()
    assert jr2.load_payload("uu", device="cpu") is None
    assert os.path.exists(ppath + ".corrupt")


def test_compact_rewrites_final_states_only(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    _, _, b = _admit(jr, "c1", rid=1, seed=1)
    jr.record_dispatched("c1")
    jr.record_done("c1", _resp(1, b))
    _admit(jr, "c2", rid=2, seed=2)
    jr.record_dispatched("c2")
    jr.close()
    out = _journal(tmp_path).compact()
    assert out["after"]["segments"] == 1 and out["dropped_lines"] > 0
    jr3 = _journal(tmp_path)
    rep = jr3.replay()
    assert rep.entries["c1"].done is not None
    assert rep.entries["c2"].dispatched == 1
    assert [e.idem for e in rep.incomplete] == ["c2"]
    assert jr3.lookup_done("c1") is not None
    assert not os.path.exists(jr3.payload_path("c1"))
    assert os.path.exists(jr3.payload_path("c2"))


# -------------------------------------------- boundary hardening


def test_valid_idem_charset_equal_to_the_jax_package():
    from image_analogies_tpu.serve import journal as jsj

    good = ("kill-restart-0", "A_b-9", "a" * 64,
            sj.idem_key("k", np.zeros((2, 2), np.float32)))
    bad = ("", "../../../x", "a/b", "a\\b", ".", "..", "a.b", "a b",
           "a\x00b", "a" * 65, "k\n", 7, None)
    for key in good:
        assert sj.valid_idem(key) and jsj.valid_idem(key)
    for key in bad:
        assert not sj.valid_idem(key) and not jsj.valid_idem(key)


def test_unsafe_idem_never_becomes_a_path(tmp_path):
    jr = _journal(tmp_path)
    for bad in ("../../../x", "a/b", "..", "a" * 65):
        with pytest.raises(ValueError):
            jr.payload_path(bad)
        with pytest.raises(ValueError):
            jr.response_path(bad)


def test_replay_skips_handcrafted_unsafe_idem_lines(tmp_path):
    jr = _journal(tmp_path)
    rec = {"op": "admitted", "idem": "../../../etc/target", "rid": 1,
           "key": "k", "deadline_s": None}
    line = json.dumps({"seal": sj._seal(rec), **rec},
                      sort_keys=True, separators=(",", ":"))
    with open(os.path.join(jr.path, "segment-000001.jsonl"), "w") as f:
        f.write(line + "\n")
    rep = jr.replay()
    assert rep.entries == {} and rep.order == [] and rep.incomplete == []


def test_concurrent_admit_spills_stay_valid(tmp_path):
    jr = _journal(tmp_path)
    jr.open()
    a, ap, b = _planes(3)
    for round_ in range(8):
        idem = f"race-{round_}"
        barrier = threading.Barrier(2)

        def spill(rid, idem=idem):
            barrier.wait()
            jr.record_admit(idem, rid, a, ap, b, _params(), None, "key")

        threads = [threading.Thread(target=spill, args=(rid,))
                   for rid in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert jr.load_payload(idem, device="cpu") is not None
    jr.close()
    names = os.listdir(os.path.join(jr.path, "payloads"))
    assert not any(n.endswith(".corrupt") for n in names)


def test_compact_refuses_while_journal_active(tmp_path, monkeypatch):
    jr = _journal(tmp_path)
    jr.open()
    _admit(jr, "live-1", rid=1, seed=1)
    with pytest.raises(RuntimeError, match="active"):
        jr.compact()
    with pytest.raises(RuntimeError, match="active"):
        _journal(tmp_path).compact()
    jr.close()
    assert _journal(tmp_path).compact()["after"]["segments"] == 1

    jr2 = _journal(tmp_path)  # a dead owner's stale lock never blocks
    with open(os.path.join(jr2.path, "journal.lock"), "w") as f:
        f.write("123456789")

    def dead(pid, sig):
        raise ProcessLookupError

    monkeypatch.setattr(sj.os, "kill", dead)
    assert jr2.active_pid() is None
    jr2.compact()
    assert not os.path.exists(os.path.join(jr2.path, "journal.lock"))


def test_segment_bytes_gauge_feeds_the_ceilings_series(tmp_path):
    """The journal keeps its segments' bytes as the ``journal.bytes``
    gauge, which the ceilings watchdog reads as its series."""
    from image_analogies_tpu_torch.obs import ceilings as obs_ceilings

    with obs_trace.run_scope(_params()):
        jr = _journal(tmp_path)
        jr.open()
        _admit(jr, "g1", rid=1, seed=1)
        jr.record_dispatched("g1")
        (seg,) = jr._segments()
        gauge = obs_metrics.snapshot()["gauges"]["journal.bytes"]
        assert gauge == os.path.getsize(seg)
        mon = obs_ceilings.CeilingMonitor(min_points=1)
        mon.sample(now=0.0)
        assert mon._dogs["journal.bytes"].points[-1][1] == gauge
        jr.close()


# ------------------------------------------------- server integration


def test_journal_dir_is_accepted_and_health_reports_it(tmp_path):
    cfg = _cfg(journal_dir=str(tmp_path / "j"))
    a, ap, b = _planes(2, size=(12, 12))
    with Server(cfg) as srv:
        assert srv.request(a, ap, b, timeout=60).status == "ok"
        health = srv.health()
    jn = health["journal"]
    assert jn["admitted"] == jn["dispatched"] == jn["done"] == 1
    assert jn["lock_pid"] == os.getpid() and jn["segment"] == 1
    assert health["recovery"] == {"entries": 0, "replayed": 0,
                                  "poisoned": 0, "done": 0,
                                  "unrecoverable": 0, "quarantined": 0}


def test_poisoned_key_sheds_before_breaker(tmp_path):
    jdir = str(tmp_path / "j")
    pre = sj.RequestJournal(jdir, fsync=False)
    pre.open()
    _admit(pre, "bad-key", rid=1, seed=7)
    pre.record_poisoned("bad-key")
    pre.close()

    cfg = _cfg(journal_dir=jdir)
    a, ap, b = _planes(7)
    with obs_trace.run_scope(cfg.params.replace(metrics=True)):
        with Server(cfg) as srv:
            for _ in range(3):
                with pytest.raises(Rejected) as exc:
                    srv.submit(a, ap, b, idempotency_key="bad-key")
                assert exc.value.reason == "poison"
            assert srv._pool.breaker.state == "closed"
            counters = obs_metrics.snapshot()["counters"]
    assert counters.get("serve.poisoned") == 3


def test_unsafe_idempotency_key_rejected_at_submit(tmp_path):
    cfg = _cfg(journal_dir=str(tmp_path / "j"))
    a, ap, b = _planes(5, size=(12, 12))
    with obs_trace.run_scope(cfg.params):
        with Server(cfg) as srv:
            for bad in ("../../../x", "a/b", "a" * 65, ""):
                with pytest.raises(Rejected) as exc:
                    srv.submit(a, ap, b, idempotency_key=bad)
                assert exc.value.reason == "bad_idempotency_key"
            ok = srv.submit(a, ap, b,
                            idempotency_key="good-key_1").result(timeout=60)
    assert ok.status == "ok"
    assert not os.path.exists(tmp_path / "x")


def test_crash_exhaustion_persists_poison_across_restart(tmp_path,
                                                         monkeypatch):
    """A worker crash below the per-request handler (a ``_run_batch``
    that raises: the port's stand-in for the chaos plane's crash fault)
    with no requeue budget left poisons the key, and the NEXT server on
    the journal sheds it."""
    jdir = str(tmp_path / "j")
    cfg = _cfg(crash_requeues=0, journal_dir=jdir)
    a, ap, b = _planes(8)
    orig = WorkerPool._run_batch

    def crash(self, batch):
        raise RuntimeError("injected worker crash")

    with obs_trace.run_scope(cfg.params):
        monkeypatch.setattr(WorkerPool, "_run_batch", crash)
        with Server(cfg) as srv:
            fut = srv.submit(a, ap, b, idempotency_key="crasher")
            with pytest.raises(Rejected) as exc:
                fut.result(timeout=30)
            assert exc.value.reason == "worker_crash"
        monkeypatch.setattr(WorkerPool, "_run_batch", orig)
        with Server(cfg) as srv2:
            assert srv2.recovery_stats["replayed"] == 0
            with pytest.raises(Rejected) as exc:
                srv2.submit(a, ap, b, idempotency_key="crasher")
            assert exc.value.reason == "poison"
    hist = sj.RequestJournal(jdir).history("crasher")
    assert [r["op"] for r in hist if r["op"] != "decision"] == [
        "admitted", "poisoned"]


def test_duplicate_submission_dedupes_with_recorded_response(tmp_path):
    cfg = _cfg(journal_dir=str(tmp_path / "j"))
    a, ap, b = _planes(9, size=(12, 12))
    with obs_trace.run_scope(cfg.params):
        with Server(cfg) as srv:
            first = srv.submit(a, ap, b).result(timeout=60)
            again = srv.submit(a, ap, b).result(timeout=60)
    assert again.request_id == first.request_id
    assert np.array_equal(again.bp, first.bp)


def test_disabled_journal_path_never_touches_module(tmp_path, monkeypatch):
    def poisoned(*a, **k):
        raise AssertionError("journal touched on the disabled path")

    monkeypatch.setattr(sj.RequestJournal, "__init__", poisoned)
    monkeypatch.setattr(sj, "idem_key", poisoned)
    cfg = _cfg()  # no journal_dir
    a, ap, b = _planes(10, size=(12, 12))
    with obs_trace.run_scope(cfg.params):
        with Server(cfg) as srv:
            resp = srv.submit(a, ap, b).result(timeout=60)
            assert srv.health()["journal"] is None
    assert resp.status == "ok"


def test_loadgen_selftest_journal_smoke(tmp_path):
    cfg = _cfg(journal_dir=str(tmp_path / "j"))
    summary = loadgen.selftest(cfg, 3, seed=0, shapes=((12, 12),))
    assert summary["errors"] == 0 and summary["bit_identical"] is True
    jn = summary["journal"]
    assert jn["resubmit_deduped"] == summary["completed"] == 3
    assert jn["admitted"] == 3 and jn["done"] == 3
    assert "resubmissions answered from the journal" in \
        loadgen.render(summary)


def test_cli_journal_inspect_compact_and_why(tmp_path, capsys):
    from image_analogies_tpu_torch.cli import main

    jdir = str(tmp_path / "j")
    jr = sj.RequestJournal(jdir, fsync=False)
    jr.open()
    _, _, b = _admit(jr, "k1", rid=1, seed=1)
    jr.record_dispatched("k1")
    jr.record_decision("k1", "server", "replay", "incomplete_after_restart")
    jr.record_done("k1", _resp(1, b))
    _admit(jr, "k2", rid=2, seed=2)
    assert main(["journal", "compact", jdir]) == 2  # refused: active
    assert "active" in capsys.readouterr().err
    jr.close()

    assert main(["why", "k1", "--root", jdir, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["chain"] == ["admitted[j]", "dispatched",
                            "replay(incomplete_after_restart)", "done"]
    assert main(["why", "nope", "--root", jdir]) == 2
    assert "no journal" in capsys.readouterr().out

    assert main(["journal", "inspect", jdir]) == 0
    out = capsys.readouterr().out
    assert "2 requests" in out and "done" in out and "k2" in out
    assert main(["journal", "compact", jdir, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["after"]["lines"] == 2
    assert main(["journal", "inspect", str(tmp_path / "missing")]) == 2


# ------------------------------------------------ across the packages


def _jax_writer():
    from image_analogies_tpu.chaos import drills
    from image_analogies_tpu.serve import journal as jsj
    from image_analogies_tpu.serve.types import Response as JResponse

    return jsj, drills.image_params(levels=1), JResponse


def _write_sequence(root, mod, params, resp_t):
    """One fixed sequence of journal calls through ``mod``'s journal (the
    JAX package's or the port's), with that package's Response type."""
    jr = mod.RequestJournal(root, fsync=False)
    jr.open()
    for i, idem in enumerate(("s1", "s2", "s3", "s4", "s5")):
        a, ap, b = _planes(20 + i)
        jr.record_admit(idem, i + 1, a, ap, b, params, 5.0 if i else None,
                        f"key{i % 2}")
    jr.record_dispatched("s1")
    jr.record_cost("s1", {"queue_ms": 3.0, "dispatch_ms": 7.0, "lanes": 2})
    _, _, b1 = _planes(20)
    jr.record_done("s1", resp_t(request_id=1, bp=b1, bp_y=b1 * 0.5,
                                stats={"levels": 1}, batch_size=2,
                                queue_ms=3.0, dispatch_ms=7.0,
                                total_ms=10.0))
    jr.record_dispatched("s2")
    jr.record_dispatched("s2")
    jr.record_decision("s2", "worker", "requeue", "worker_crash",
                       requeues=1)
    jr.record_rejected("s3", "deadline")
    jr.record_poisoned("s4")
    jr.close()
    return jr


def _replay_view(rep):
    return ({k: (e.dispatched, e.done is not None, e.rejected, e.poisoned,
                 e.complete) for k, e in rep.entries.items()},
            rep.order, [e.idem for e in rep.incomplete], rep.lines,
            rep.quarantined, {k: len(v) for k, v in rep.aux.items()})


def _lines(root):
    out = []
    for name in sorted(os.listdir(root)):
        if name.startswith("segment-"):
            with open(os.path.join(root, name)) as f:
                for line in f:
                    rec = json.loads(line)
                    rec.pop("ts")
                    rec.pop("seal")
                    out.append(rec)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_written_by_either_package_replays_in_the_other(
        tmp_path, writer):
    """Cross-replay: the same keys, states, order, dispatch counts and
    attribution lines; the recorded response and the spilled payload
    load to the same bits in both."""
    from image_analogies_tpu.serve import journal as jsj

    root = str(tmp_path / "j")
    if writer == "jax":
        _write_sequence(root, *_jax_writer())
    else:
        _write_sequence(root, sj, _params(), Response)
    theirs = jsj.RequestJournal(root)
    ours = sj.RequestJournal(root)
    assert _replay_view(ours.replay()) == _replay_view(theirs.replay())
    view = _replay_view(ours.replay())
    assert view[1] == ["s1", "s2", "s3", "s4", "s5"]
    assert view[2] == ["s2", "s5"] and view[0]["s2"][0] == 2
    assert ours.inspect() == theirs.inspect()
    got, want = ours.lookup_done("s1"), theirs.lookup_done("s1")
    assert got.request_id == want.request_id == 1
    assert np.array_equal(got.bp, want.bp)
    assert np.array_equal(got.bp_y, want.bp_y)
    pa, pb = ours.load_payload("s5", device="cpu"), theirs.load_payload("s5")
    for x, y in zip(pa[:3], pb[:3]):
        assert np.array_equal(x, y)
    assert sj.params_doc(pa[3]) == dataclasses.asdict(pb[3])


def test_same_calls_write_equal_lines_in_both_packages(tmp_path):
    _write_sequence(str(tmp_path / "jax"), *_jax_writer())
    _write_sequence(str(tmp_path / "port"), sj, _params(), Response)
    assert _lines(str(tmp_path / "port")) == _lines(str(tmp_path / "jax"))
    with np.load(os.path.join(str(tmp_path / "port"), "payloads",
                              "s1.resp.npz")) as zp, \
            np.load(os.path.join(str(tmp_path / "jax"), "payloads",
                                 "s1.resp.npz")) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert np.array_equal(zp[k], zj[k]), k


def test_reconstruct_and_render_why_equal_on_a_jax_journal(tmp_path):
    from image_analogies_tpu.serve import journal as jsj

    root = str(tmp_path / "j")
    _write_sequence(root, *_jax_writer())
    for idem in ("s1", "s2", "s3", "s4", "missing"):
        ours = sj.reconstruct(idem, root)
        theirs = jsj.reconstruct(idem, root)
        assert ours == theirs
        assert sj.render_why(ours) == jsj.render_why(theirs)
    assert sj.reconstruct("s2", root)["chain"] == [
        "admitted[j]", "dispatched", "dispatched",
        "requeue(worker_crash)"]


def _kill_with_four_admitted(server_cls, pool_cls, cfg, load, monkeypatch):
    """Admit four keyed requests to a server whose workers drop every
    batch they pop (nothing dispatched, futures left hanging, as a dead
    process leaves them), then ``kill()`` it."""
    monkeypatch.setattr(pool_cls, "_run_batch", lambda self, batch: None)
    srv = server_cls(cfg).start()
    for i, (a, ap, b) in enumerate(load):
        srv.submit(a, ap, b, idempotency_key=f"kr-{i}")
    srv.kill()
    monkeypatch.undo()


def _recover(server_cls, cfg):
    with server_cls(cfg) as srv:
        stats = dict(srv.recovery_stats)
        outcomes = srv.wait_recovered(timeout=120)
        bits = {k: np.asarray(f.result().bp) for k, f in
                srv.recovery.items()}
    return stats, outcomes, bits


@pytest.mark.parametrize("killed_by", ["jax", "port"])
def test_kill_then_recover_gives_the_jax_servers_bits(tmp_path, monkeypatch,
                                                      killed_by):
    """A server killed with four admitted requests; a new server on the
    same journal recovers all four.  The port's recovery equals the JAX
    server's on the same inputs and keys, whichever package wrote the
    journal (tolerance 0)."""
    import shutil

    from image_analogies_tpu.chaos import drills
    from image_analogies_tpu.serve import Server as JServer
    from image_analogies_tpu.serve.worker import WorkerPool as JPool

    load = [_planes(30 + i, size=(12, 12)) for i in range(4)]
    src = str(tmp_path / "killed")
    if killed_by == "jax":
        _kill_with_four_admitted(JServer, JPool,
                                 drills.serve_config(workers=1,
                                                     journal_dir=src),
                                 load, monkeypatch)
    else:
        _kill_with_four_admitted(Server, WorkerPool,
                                 _cfg(journal_dir=src), load, monkeypatch)
    for name in ("jax", "port"):
        shutil.copytree(src, str(tmp_path / name))
    jstats, jout, jbits = _recover(
        JServer, drills.serve_config(workers=1,
                                     journal_dir=str(tmp_path / "jax")))
    tstats, tout, tbits = _recover(Server,
                                   _cfg(journal_dir=str(tmp_path / "port")))
    want = {"entries": 4, "replayed": 4, "poisoned": 0, "done": 0,
            "unrecoverable": 0, "quarantined": 0}
    assert tstats == jstats == want
    assert tout == jout == {f"kr-{i}": "ok" for i in range(4)}
    assert list(tbits) == list(jbits)  # original admit order
    for k in tbits:
        np.testing.assert_array_equal(tbits[k], jbits[k])
    # the recovered answers are the journal's: a retry dedupes to them
    with Server(_cfg(journal_dir=str(tmp_path / "port"))) as srv:
        assert srv.recovery_stats["replayed"] == 0
        a, ap, b = load[1]
        again = srv.submit(a, ap, b, idempotency_key="kr-1").result(60)
    np.testing.assert_array_equal(again.bp, tbits["kr-1"])
