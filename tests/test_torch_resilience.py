"""The port's recovery counters and its serve worker's process-death
branch, held to the JAX package's on the CPU.

- ``utils/failure.py``: ``level_retry``, ``retry.exhausted``,
  ``watchdog.timeouts`` and ``watchdog.abandoned`` equal the JAX
  package's over the same injected sequence, and a watchdog timeout
  dumps the flight-recorder ring in both;
- ``utils/devcache.py``: ``devcache.hits``, ``misses``, ``upload_bytes``,
  ``evictions``, ``evicted_bytes`` and the ``devcache.bytes`` gauge equal
  the JAX package's over the same sequence of uploads and evictions;
- ``utils/checkpoint.py``: a damaged checkpoint is quarantined and
  counted as ``ckpt.quarantined`` (as in the JAX package), and a caller's
  own counter replaces it;
- ``serve/worker.py``: a ``chaos.ProcessDeath`` escapes the worker loop
  (the thread exits, its future unresolved, ``serve.process_deaths`` and
  a black-box dump), while a ``WorkerCrash`` is still contained.

Every comparison is exact.
"""

import os
import threading
import time

import numpy as np
import pytest

from image_analogies_tpu_torch.config import AnalogyParams as TParams
from image_analogies_tpu_torch.obs import recorder as trecorder
from image_analogies_tpu_torch.obs import trace as ttrace
from image_analogies_tpu_torch.utils import checkpoint as tckpt
from image_analogies_tpu_torch.utils import devcache as tdevcache
from image_analogies_tpu_torch.utils import failure as tfailure


def _jax():
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.obs import recorder as jrecorder
    from image_analogies_tpu.obs import trace as jtrace
    from image_analogies_tpu.utils import checkpoint as jckpt
    from image_analogies_tpu.utils import devcache as jdevcache
    from image_analogies_tpu.utils import failure as jfailure

    return dict(params=JParams(metrics=True), trace=jtrace,
                recorder=jrecorder, ckpt=jckpt, devcache=jdevcache,
                failure=jfailure)


def _port():
    return dict(params=TParams(metrics=True, device="cpu"), trace=ttrace,
                recorder=trecorder, ckpt=tckpt, devcache=tdevcache,
                failure=tfailure)


@pytest.fixture(autouse=True)
def _reset():
    yield
    tfailure.inject_failures(0)
    tdevcache.set_max_bytes(None)
    tdevcache.clear()


def _retry_sequence(pkg, dump_dir):
    """The same injected sequence through one package's retry and
    watchdog wrappers, inside a metrics run; returns its counters and
    the dumps' reasons."""
    failure = pkg["failure"]
    with pkg["trace"].run_scope(pkg["params"]) as ctx:
        ctx.scope.dump_dir = dump_dir
        # two faults inside a budget of three: two retries
        failure.inject_failures(2)
        assert failure.run_with_retry(lambda: 5, retries=3,
                                      backoff_s=0.0) == 5
        # three faults past a budget of two: two retries, then exhausted
        failure.inject_failures(3)
        with pytest.raises(failure.InjectedFailure):
            failure.run_with_retry(lambda: 5, retries=2, backoff_s=0.0)
        # no budget given: the fault surfaces uncounted
        failure.inject_failures(1)
        with pytest.raises(failure.InjectedFailure):
            failure.run_with_retry(lambda: 5, retries=0, backoff_s=0.0)
        failure.inject_failures(0)
        # a wedged body: timed out, retried, and abandoned when it ends
        release = threading.Event()
        calls = []

        def body():
            calls.append(1)
            if len(calls) == 1:
                release.wait(10.0)
            return 7

        assert failure.run_with_retry(
            lambda: failure.run_with_watchdog(body, 0.05,
                                              context={"level": 3}),
            retries=1, backoff_s=0.0) == 7
        release.set()
        end = time.monotonic() + 10.0
        while (ctx.registry.snapshot()["counters"].get(
                "watchdog.abandoned", 0) < 1
               and time.monotonic() < end):
            time.sleep(0.01)
        counters = dict(ctx.registry.snapshot()["counters"])
    reasons = [pkg["recorder"].load_dump(p)["reason"]
               for p in pkg["recorder"].list_dumps(dump_dir)]
    return counters, reasons


def test_retry_and_watchdog_counters_equal_the_jax_package(tmp_path):
    keys = ("level_retry", "retry.exhausted", "watchdog.timeouts",
            "watchdog.abandoned")
    ours, our_dumps = _retry_sequence(_port(), str(tmp_path / "port"))
    theirs, their_dumps = _retry_sequence(_jax(), str(tmp_path / "jax"))
    assert {k: ours.get(k) for k in keys} == {
        "level_retry": 5, "retry.exhausted": 1, "watchdog.timeouts": 1,
        "watchdog.abandoned": 1}
    assert {k: ours.get(k) for k in keys} == {k: theirs.get(k)
                                              for k in keys}
    assert our_dumps == their_dumps == ["watchdog_timeout"]


def _upload_sequence(pkg, put):
    """The same uploads through one package's device cache under a budget
    of two planes, inside a metrics run; returns (counters, gauges)."""
    devcache = pkg["devcache"]
    rng = np.random.RandomState(5)
    a, b, c = (rng.rand(128, 160).astype(np.float32) for _ in range(3))
    tiny = rng.rand(8, 8).astype(np.float32)  # below 64 KiB: uncached
    devcache.clear()
    devcache.set_max_bytes(2 * a.nbytes)
    try:
        with pkg["trace"].run_scope(pkg["params"]) as ctx:
            for x in (a, a, b, tiny, c, a, a, b, c.copy()):
                put(x)
            snap = ctx.registry.snapshot()
    finally:
        devcache.set_max_bytes(None)
        devcache.clear()
    return (
        {k: v for k, v in snap["counters"].items()
         if k.startswith("devcache.")},
        {k: v for k, v in snap["gauges"].items()
         if k.startswith("devcache.")})


def test_devcache_counters_equal_the_jax_package():
    ours = _upload_sequence(
        _port(), lambda x: tdevcache.device_put_cached(x, "cpu"))
    j = _jax()
    theirs = _upload_sequence(j, j["devcache"].device_put_cached)
    plane = 128 * 160 * 4
    assert ours[0] == {
        "devcache.hits": 2, "devcache.misses": 6,
        "devcache.upload_bytes": 6 * plane, "devcache.evictions": 4,
        "devcache.evicted_bytes": 4 * plane}
    assert ours[1] == {"devcache.bytes": 2 * plane}
    assert ours == theirs


def _damaged_load(pkg, root):
    ckpt = pkg["ckpt"]
    bp = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    s = np.arange(64, dtype=np.int32).reshape(8, 8)
    with pkg["trace"].run_scope(pkg["params"]) as ctx:
        path = ckpt.save_level(root, 1, bp, s, digest="d")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        got = ckpt.load_level(root, 1, digest="d")
        counters = dict(ctx.registry.snapshot()["counters"])
    return got, os.path.exists(path + ".corrupt"), counters


def test_damaged_checkpoint_counts_quarantine(tmp_path):
    got, moved, ours = _damaged_load(_port(), str(tmp_path / "port"))
    assert got is None and moved
    assert ours.get("ckpt.quarantined") == 1
    _, _, theirs = _damaged_load(_jax(), str(tmp_path / "jax"))
    assert ours.get("ckpt.quarantined") == theirs.get("ckpt.quarantined")
    # a store that passes its own counter keeps it
    path = str(tmp_path / "basis.npz")
    with open(path, "wb") as f:
        f.write(b"not an npz")
    with ttrace.run_scope(TParams(metrics=True, device="cpu")) as ctx:
        tckpt.quarantine(path, counter="ann.quarantined",
                         event="ann_quarantined")
        counters = ctx.registry.snapshot()["counters"]
    assert counters.get("ann.quarantined") == 1
    assert "ckpt.quarantined" not in counters


def _one_worker_server(jdir):
    from image_analogies_tpu_torch.chaos import drills
    from image_analogies_tpu_torch.serve.server import Server

    cfg = drills.serve_config(workers=1, max_batch=1, journal_dir=jdir,
                              device="cpu")
    return Server(cfg), drills.make_serve_load(1, seed=3)[0]


def test_process_death_escapes_the_worker_loop(tmp_path, monkeypatch):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "tune.json"))
    from image_analogies_tpu_torch import chaos
    from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule

    jdir = str(tmp_path / "journal")
    srv, item = _one_worker_server(jdir)
    plan = ChaosPlan(seed=0, sites=(("serve.dispatch", SiteRule(
        kind="process_death", schedule=(0,))),))
    with ttrace.run_scope(srv.cfg.params) as ctx:
        srv.start()
        with chaos.plan_scope(plan):
            fut = srv.submit(item["a"], item["ap"], item["b"],
                             idempotency_key="death-0")
            end = time.monotonic() + 30.0
            while (any(srv._pool.liveness().values())
                   and time.monotonic() < end):
                time.sleep(0.01)
        counters = dict(ctx.registry.snapshot()["counters"])
        live = srv._pool.liveness()
        done = fut.done()
        srv.kill()
    assert live and not any(live.values())  # the death took the thread
    assert not done  # a dead process resolves nothing
    assert counters.get("serve.process_deaths") == 1
    assert "serve.worker_crashes" not in counters
    dumps = [trecorder.load_dump(p) for p in trecorder.list_dumps(jdir)]
    assert [d["reason"] for d in dumps] == ["process_death"]
    assert "serve_process_death" in [r.get("event")
                                     for r in dumps[0]["records"]]


def test_worker_crash_is_still_contained(tmp_path, monkeypatch):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "tune.json"))
    from image_analogies_tpu_torch import chaos
    from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule

    srv, item = _one_worker_server(None)
    plan = ChaosPlan(seed=0, sites=(("serve.dispatch", SiteRule(
        kind="crash", schedule=(0,))),))
    with ttrace.run_scope(srv.cfg.params) as ctx:
        with srv:
            with chaos.plan_scope(plan):
                resp = srv.submit(item["a"], item["ap"],
                                  item["b"]).result(timeout=60)
                live = srv._pool.liveness()
        counters = dict(ctx.registry.snapshot()["counters"])
    assert resp.status == "ok"  # requeued once and served
    assert live and all(live.values())
    assert counters.get("serve.worker_crashes") == 1
    assert "serve.process_deaths" not in counters
