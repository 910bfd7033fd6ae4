"""The port's run-scoped observability (``image_analogies_tpu_torch/obs/``)
against the JAX package's ``obs/``:

- the same sequence of ``inc`` / ``set_gauge`` / ``max_gauge`` /
  ``observe`` calls gives the same ``snapshot()``;
- ``run_scope`` writes a manifest with the JAX record's keys and a
  ``run_end`` with the snapshot;
- a small CPU run with ``metrics=True`` counts the JAX driver's
  ``pipeline.*``, ``kappa.*`` and ``fetch.bytes`` with the JAX values, and
  the lane engine its ``batch.*`` names;
- the kernel wrappers' launch hook costs no allocation in ``obs/`` with
  metrics off (the JAX shim's zero-alloc test, which fails on this
  Python at the shim's passthrough line, is the reason the port's hook
  is not a wrapper);
- resolution and memory records never initialize CUDA.
"""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import create_image_analogy as j_create
from image_analogies_tpu.obs import metrics as jmetrics
from image_analogies_tpu.obs import trace as jtrace
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import BatchIncompatible
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch import create_image_analogy_batch
from image_analogies_tpu_torch.obs import device as tdevice
from image_analogies_tpu_torch.obs import metrics as tmetrics
from image_analogies_tpu_torch.obs import trace as ttrace
from image_analogies_tpu_torch.ops import match
from image_analogies_tpu_torch.tune import resolve as tune
from image_analogies_tpu_torch.tune import store as tstore
from tests.conftest import make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_DIR = os.path.join(REPO, "image_analogies_tpu_torch", "obs")


@pytest.fixture(autouse=True)
def _empty_store(monkeypatch, tmp_path):
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "none.json"))
    tstore.invalidate_cache()
    tune.reset_provenance()
    yield
    tstore.invalidate_cache()
    tune.reset_provenance()


def _ops(reg):
    """One fixed sequence of registry writes (a latency series included,
    so the quantile sketch rides along)."""
    for i in range(40):
        reg.inc("launch.argmin_l2")
        reg.inc("kernel.bytes", 1024 * i)
        reg.observe("level_ms", 0.5 + i * 3.25)
        reg.observe("serve.latency_ms", 1.0 + (i * 7) % 13)
    reg.set_gauge("pipeline.host_gap_ms", 2.5)
    reg.add_gauge("devcache.bytes", 100)
    reg.add_gauge("devcache.bytes", 23)
    for v in (3.0, 9.0, 4.0):
        reg.max_gauge("hbm.peak_bytes.d0", v)
    reg.observe("zero", 0.0)
    reg.inc("kappa.coherence_px", 12.5)


def test_registry_snapshot_equals_jax():
    port, ref = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _ops(port)
    _ops(ref)
    assert port.snapshot() == ref.snapshot()
    assert port.counter("launch.argmin_l2") == 40


def test_scoped_helpers_equal_jax():
    """The module helpers resolve the run's process scope, and chain to a
    parent scope, as in the JAX package."""
    snaps = []
    for trace, metrics, params in ((ttrace, tmetrics, TParams(metrics=True)),
                                   (jtrace, jmetrics, JParams(metrics=True))):
        assert metrics.snapshot() == {"counters": {}, "gauges": {},
                                      "histograms": {}}
        with trace.run_scope(params) as ctx:
            assert ctx is not None
            child = metrics.ObsScope("worker", parent=ctx.scope)
            with metrics.scope_active(child):
                metrics.inc("a")
                metrics.observe("x_latency_ms", 4.0)
            _ops(metrics)
            snaps.append((metrics.snapshot(), child.registry.snapshot()))
        assert not metrics._ACTIVE
    assert snaps[0] == snaps[1]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_run_scope_manifest_has_the_jax_record_keys(tmp_path):
    recs = {}
    for side, trace, params in (
            ("port", ttrace, TParams(metrics=True, device="cpu")),
            ("jax", jtrace, JParams(metrics=True))):
        log = str(tmp_path / f"{side}.jsonl")
        with trace.run_scope(params, manifest_extra={"tune_store": "s",
                                                     "tune_entries": 0}):
            pass
        with trace.run_scope(params, log_path=log):
            with trace.span("level", level=3):
                pass
        recs[side] = _records(log)
    port, ref = recs["port"], recs["jax"]
    assert [r["event"] for r in port] == [r["event"] for r in ref] == [
        "run_manifest", "span", "run_end"]
    want = set(ref[0]) - {"jax_version", "git_rev"}
    assert want <= set(port[0]), want - set(port[0])
    assert port[0]["platform"] == "cpu" and port[0]["metrics"] is True
    for p, j in zip(port[1:], ref[1:]):
        assert set(p) == set(j)
    assert port[1]["level"] == 3 and port[1]["name"] == "level"
    assert len({r["run_id"] for r in port}) == 1
    assert [r["seq"] for r in port] == [0, 1, 2]


def test_run_scope_inert_without_metrics_and_reentrant(tmp_path):
    with ttrace.run_scope(TParams(log_path=str(tmp_path / "x"))) as ctx:
        assert ctx is None and ttrace.span("s") is ttrace._NOOP
    assert not os.path.exists(tmp_path / "x")
    with ttrace.run_scope(TParams(metrics=True)) as outer:
        with ttrace.run_scope(TParams(metrics=True)) as inner:
            assert inner is outer and outer.depth == 1
        tmetrics.inc("n")
        assert tmetrics.snapshot()["counters"] == {"n": 1}


def _jax_and_port_runs(level_sync):
    a, ap, b = make_pair(20, 22, seed=0)
    out = []
    for trace, metrics, create, params, kw in (
            (jtrace, jmetrics, j_create,
             JParams(levels=2, backend="tpu", metrics=True,
                     level_sync=level_sync), {}),
            (ttrace, tmetrics, t_create,
             TParams(levels=2, device="cpu", metrics=True,
                     level_sync=level_sync), {})):
        with trace.run_scope(params):
            res = create(a, ap, b, params, **kw)
            out.append((res, metrics.snapshot()))
    return out


@pytest.mark.parametrize("level_sync", [True, False])
def test_cpu_run_counters_equal_jax(level_sync):
    """A CPU run with metrics=True: the JAX driver's pipeline, fetch and
    kappa names, with its values where they are not times."""
    (jres, jsnap), (tres, tsnap) = _jax_and_port_runs(level_sync)
    assert [s["coherence_ratio"] for s in tres.stats] == [
        s["coherence_ratio"] for s in jres.stats]
    shared = ("fetch.bytes", "kappa.coherence_px", "kappa.total_px",
              "pipeline.levels_prepped", "tune.fallbacks")
    for k in shared:
        assert tsnap["counters"].get(k) == jsnap["counters"].get(k), k
    assert tsnap["counters"]["kappa.total_px"] == 550
    assert sorted(g for g in jsnap["gauges"] if g.startswith("pipeline.")) \
        == sorted(g for g in tsnap["gauges"] if g.startswith("pipeline."))
    # the CPU launches no kernel, and loads no library
    assert not any(k.startswith(("launch.", "compile.", "kernel."))
                   for k in tsnap["counters"])
    assert not any(k.startswith("hbm.") for k in tsnap["gauges"])


def test_metrics_run_keeps_the_bits_and_logs_resolutions(tmp_path):
    a, ap, b = make_pair(20, 22, seed=4)
    params = TParams(levels=2, device="cpu")
    ref = t_create(a, ap, b, params)
    tune.reset_provenance()
    log = str(tmp_path / "run.jsonl")
    res = t_create(a, ap, b, params.replace(metrics=True, log_path=log))
    assert np.array_equal(ref.bp_y.view(np.int32), res.bp_y.view(np.int32))
    assert np.array_equal(ref.source_map, res.source_map)
    recs = _records(log)
    man = [r for r in recs if r.get("event") == "run_manifest"]
    assert len(man) == 1 and man[0]["tune_store"] == os.environ[
        "IA_TUNE_STORE"] and man[0]["tune_entries"] == 0
    resolved = [r for r in recs if r.get("event") == "tune_resolved"]
    assert {r["key"] for r in resolved} == set(tune.provenance_snapshot())
    assert all(r["origin"]["chunks_per_sm"] == "default" for r in resolved)
    levels = [r["level"] for r in recs if r.get("event") is None]
    assert levels == [1, 0]
    end = [r for r in recs if r.get("event") == "run_end"]
    assert end[-1]["metrics"]["counters"]["tune.fallbacks"] == 2


def _wrapper_shaped():
    """The tail of a kernel wrapper: the launch count, then the guarded
    hook, with metrics off."""
    match.LAUNCHES["argmin_l2"] += 1
    if tmetrics._ACTIVE:
        tdevice.note_launch("argmin_l2", *tdevice.argmin_work(88, 65536, 68))
    return match.LAUNCHES["argmin_l2"]


def test_launch_hook_disabled_path_allocates_nothing_in_obs():
    assert not tmetrics._ACTIVE
    before = match.LAUNCHES["argmin_l2"]
    _wrapper_shaped()  # warm
    tracemalloc.start(25)
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(50):
            _wrapper_shaped()
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    match.LAUNCHES["argmin_l2"] = before
    stats = snap1.compare_to(snap0, "traceback")
    in_obs = [st for st in stats if st.size_diff > 0 and any(
        fr.filename.startswith(OBS_DIR) for fr in st.traceback)]
    assert in_obs == []


def test_launch_hook_counts_launches_and_work():
    with ttrace.run_scope(TParams(metrics=True)):
        for _ in range(3):
            tdevice.note_launch("argmin_l2",
                                *tdevice.argmin_work(88, 65536, 68))
        tdevice.note_launch("packed_best",
                            *tdevice.packed2k_work(352, 1 << 20, 224))
        tdevice.note_launch("argmin2_l2")
        counters = tmetrics.snapshot()["counters"]
    ab, af = tdevice.argmin_work(88, 65536, 68)
    pb, pf = tdevice.packed2k_work(352, 1 << 20, 224)
    assert counters == {"launch.argmin_l2": 3, "launch.packed_best": 1,
                        "launch.argmin2_l2": 1, "kernel.bytes": 3 * ab + pb,
                        "kernel.flops": 3 * af + pf}
    # the counts chip_smoke.py's bounds use
    assert (ab, af) == (4 * (88 * 68 + 65536 * 68 + 65536) + 8 * 88,
                        2 * 88 * 65536 * 68)
    assert (pb, pf) == (2 * (352 * 224 + (1 << 20) * 224) + 8 * 352,
                        2 * 352 * (1 << 20) * 224)


def test_compile_hooks_count_only_inside_a_run(tmp_path):
    tdevice.note_compile("argmin_l2", 5.0)
    tdevice.note_cache_hit("argmin_l2")
    log = str(tmp_path / "c.jsonl")
    with ttrace.run_scope(TParams(metrics=True), log_path=log):
        with ttrace.span("level", level=2):
            tdevice.note_compile("argmin_l2", 12.5)
        tdevice.note_cache_hit("packed2k_best")
        tdevice.note_cache_hit("argmin2")
        counters = tmetrics.snapshot()["counters"]
    assert counters == {"compile.count": 1, "compile.ms": 12.5,
                        "compile.cache_hits": 2}
    comp = [r for r in _records(log) if r.get("event") == "compile"]
    assert len(comp) == 1 and comp[0]["level"] == 2


def test_record_memory_and_resolve_leave_cuda_uninitialized():
    """Resolution, the memory watermark and a whole CPU run with metrics on
    never initialize CUDA (a key made before and after would differ)."""
    assert not torch.cuda.is_initialized()
    cfg = tune.resolve(strategy="wavefront", dtype="packed2", fp=224,
                       n_rows=1 << 20)
    assert cfg.key.startswith("any|wavefront|packed2|f256|b1048576")
    with ttrace.run_scope(TParams(metrics=True)):
        tdevice.record_memory(0, None)
        assert tmetrics.snapshot()["gauges"] == {}
    a, ap, b = make_pair(16, 16, seed=1)
    t_create(a, ap, b, TParams(levels=1, device="cpu", metrics=True))
    assert tune.device_kind() == "any"
    assert not torch.cuda.is_initialized()


def test_engine_counts_lanes_and_refusals():
    a, ap, b = make_pair(16, 18, seed=2)
    b2 = make_pair(16, 18, seed=3)[2]
    params = TParams(levels=1, device="cpu", remap_luminance=False,
                     metrics=True)
    with ttrace.run_scope(params):
        out = create_image_analogy_batch(a, ap, [b, b2], params)
        with pytest.raises(BatchIncompatible) as e:
            create_image_analogy_batch(a, ap, [b, b2],
                                       params.replace(strategy="exact"))
        snap = tmetrics.snapshot()
    assert e.value.reason == "unsupported"
    assert not any(isinstance(r, Exception) for r in out)
    c = snap["counters"]
    assert (c["batch.launches"], c["batch.lanes"]) == (1, 2)
    assert c["batch.fallback_sequential.unsupported"] == 1
    assert snap["gauges"]["batch.pad_waste_frac"] == 0.0
    assert c["kappa.total_px"] == 2 * 16 * 18  # each lane's fetch
