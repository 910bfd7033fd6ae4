"""The port's driver surroundings against the JAX package's, on the CPU:
checkpoints and resume, the JSONL log, level retries and the watchdog, the
pipeline and donation, the upload cache, the profile, saved levels and the
CLI flags that reach them.

Inputs are NumPy arrays made from a seed (``tests.conftest.make_pair``,
12-22 pixels a side, 1-3 levels) and handed to both packages; the port runs
with ``device="cpu"`` (every kernel's plain version) and the JAX package
with ``backend="tpu"`` (its exact fp32 scan on the JAX CPU platform).  At
these sizes the two give the same bits, so every run below that claims
equality with the JAX package is held to it bit for bit.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import (
    create_image_analogy as j_create,
)
from image_analogies_tpu.utils import checkpoint as jckpt
from image_analogies_tpu.utils import failure as jfailure
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import PRESETS
from image_analogies_tpu_torch import cli as tcli
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch.backends import gate
from image_analogies_tpu_torch.backends.base import LevelJob
from image_analogies_tpu_torch.backends.cuda import CudaMatcher
from image_analogies_tpu_torch.ops.features import spec_for_level
from image_analogies_tpu_torch.utils import checkpoint as ckpt
from image_analogies_tpu_torch.utils import devcache, failure
from image_analogies_tpu_torch.utils.imageio import load_image, save_image
from tests.conftest import make_pair
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_driver_state():
    """The injector and the upload cache are process-wide: every test
    starts and ends with both disarmed and empty."""
    failure.inject_failures(0)
    devcache.clear()
    devcache.set_max_bytes(None)
    yield
    failure.inject_failures(0)
    jfailure.inject_failures(0)
    devcache.clear()
    devcache.set_max_bytes(None)


def _port(a, ap, b, **kw):
    kw.setdefault("levels", 2)
    return t_create(a, ap, b, TParams(device="cpu", **kw))


_JAX_RUNS = {}


def _jax(a, ap, b, **kw):
    """The JAX package's lock-step run of the same params (memoized)."""
    key = (a.tobytes(), ap.tobytes(), b.tobytes(), tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        kw.setdefault("levels", 2)
        res = j_create(a, ap, b, JParams(backend="tpu", **kw))
        _JAX_RUNS[key] = (np.asarray(res.bp_y), np.asarray(res.source_map),
                          np.asarray(res.bp))
    return _JAX_RUNS[key]


def _same_bits(port, ref):
    bp_y, sm, bp = ref if isinstance(ref, tuple) else (
        ref.bp_y, ref.source_map, ref.bp)
    np.testing.assert_array_equal(port.bp_y, bp_y)
    np.testing.assert_array_equal(port.source_map, sm)
    np.testing.assert_array_equal(port.bp, bp)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _events(path, name):
    return [r for r in _records(path) if r.get("event") == name]


def _planes(rng, shape=(8, 9)):
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.integers(0, 72, shape).astype(np.int32))


# ------------------------------------------------------------ checkpoints


def test_checkpoint_round_trip(tmp_path):
    bp, s = _planes(np.random.default_rng(0))
    ckpt.save_level(str(tmp_path), 2, bp, s, digest="d")
    out = ckpt.load_level(str(tmp_path), 2, digest="d")
    np.testing.assert_array_equal(out[0], bp)
    np.testing.assert_array_equal(out[1], s)
    assert out[0].dtype == np.float32 and out[1].dtype == np.int32
    assert ckpt.load_level(str(tmp_path), 3) is None


def test_resume_reuses_coarse_levels_and_matches_jax(tmp_path):
    """A checkpointed run, then a resume from level 0: the coarse levels
    load from disk (one ``resume_level`` record each) and the result is the
    JAX package's clean run, bit for bit."""
    a, ap, b = make_pair(20, 22, seed=5)
    kw = dict(levels=3, kappa=5.0)
    ck = str(tmp_path / "ck")
    first = _port(a, ap, b, checkpoint_dir=ck, **kw)
    assert sorted(os.listdir(ck)) == [f"level_{i:02d}.npz" for i in range(3)]
    log = str(tmp_path / "resume.jsonl")
    resumed = _port(a, ap, b, checkpoint_dir=ck, resume_from_level=0,
                    log_path=log, **kw)
    assert [r["level"] for r in _events(log, "resume_level")] == [2, 1]
    assert [st["level"] for st in resumed.stats] == [0]
    _same_bits(first, _jax(a, ap, b, **kw))
    _same_bits(resumed, _jax(a, ap, b, **kw))


def test_resume_with_keep_levels_gives_the_audit_layout(tmp_path):
    """Resumed levels are NumPy arrays from the npz: keep_levels still
    gives every level's (bp float32, s int32), finest first, equal to a
    clean run's."""
    a, ap, b = make_pair(20, 22, seed=6)
    ck = str(tmp_path / "ck")
    clean = t_create(a, ap, b, TParams(levels=3, device="cpu",
                                       checkpoint_dir=ck), keep_levels=True)
    resumed = t_create(a, ap, b, TParams(levels=3, device="cpu",
                                         checkpoint_dir=ck,
                                         resume_from_level=0),
                       keep_levels=True)
    assert len(resumed.levels) == 3
    for (bp_r, s_r), (bp_c, s_c) in zip(resumed.levels, clean.levels):
        assert bp_r.dtype == np.float32 and s_r.dtype == np.int32
        np.testing.assert_array_equal(bp_r, bp_c)
        np.testing.assert_array_equal(s_r, s_c)


def test_stale_digest_is_skipped_not_quarantined(tmp_path):
    bp, s = _planes(np.random.default_rng(1))
    path = ckpt.save_level(str(tmp_path), 4, bp, s, digest="old-config")
    assert ckpt.load_level(str(tmp_path), 4, digest="new-config") is None
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")
    np.testing.assert_array_equal(
        ckpt.load_level(str(tmp_path), 4, digest="old-config")[0], bp)


def test_stale_run_is_recomputed(tmp_path):
    """Another kappa in the same directory: nothing resumes, and the run
    equals the JAX package's at that kappa."""
    a, ap, b = make_pair(16, 16, seed=5)
    ck = str(tmp_path / "ck")
    _port(a, ap, b, checkpoint_dir=ck)
    log = str(tmp_path / "log.jsonl")
    res = _port(a, ap, b, kappa=0.5, checkpoint_dir=ck, resume_from_level=0,
                log_path=log)
    assert not _events(log, "resume_level")
    assert not _events(log, "ckpt_quarantined")
    _same_bits(res, _jax(a, ap, b, kappa=0.5))


def test_legacy_npz_without_digest_loads_only_when_no_digest_asked(
        tmp_path):
    np.savez(ckpt.level_path(str(tmp_path), 7), level=7,
             bp=np.zeros((4, 4), np.float32), s=np.zeros((4, 4), np.int32))
    assert ckpt.load_level(str(tmp_path), 7) is not None
    assert ckpt.load_level(str(tmp_path), 7, digest="abc") is None


def _flip_payload_byte(path):
    blob = bytearray(open(path, "rb").read())
    at = blob.rfind(b"\x93NUMPY")  # the last array's header
    blob[at + 200] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _truncate(path):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])


@pytest.mark.parametrize("damage", [_flip_payload_byte, _truncate],
                         ids=["flipped_byte", "truncated"])
def test_damaged_checkpoint_is_quarantined_and_recomputed(tmp_path, damage):
    """A damaged level file fails its seal (or its container): it is
    moved aside as ``.corrupt`` with a ``ckpt_quarantined`` record, that
    level is recomputed, the others resume, and the bits are the clean
    run's."""
    a, ap, b = make_pair(20, 22, seed=5)
    ck = str(tmp_path / "ck")
    clean = _port(a, ap, b, levels=3, checkpoint_dir=ck)
    path = ckpt.level_path(ck, 1)
    damage(path)
    log = str(tmp_path / "log.jsonl")
    res = _port(a, ap, b, levels=3, checkpoint_dir=ck, resume_from_level=0,
                log_path=log)
    assert os.path.exists(path + ".corrupt")
    assert [r["path"] for r in _events(log, "ckpt_quarantined")] == [path]
    assert [r["level"] for r in _events(log, "resume_level")] == [2]
    assert [st["level"] for st in res.stats] == [1, 0]
    assert os.path.exists(path)  # level 1 saved again
    _same_bits(res, clean)


@pytest.mark.parametrize("shape,digest", [((8, 9), ""), ((5, 3), "d1gest"),
                                          ((16, 16), "0123456789abcdef")])
def test_payload_checksum_equals_jax(shape, digest):
    bp, s = _planes(np.random.default_rng(2), shape)
    assert ckpt._payload_checksum(bp, s, digest) == \
        jckpt._payload_checksum(bp, s, digest)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    bp, s = _planes(np.random.default_rng(3))
    save, load = ((ckpt.save_level, jckpt.load_level) if writer == "port"
                  else (jckpt.save_level, ckpt.load_level))
    save(str(tmp_path), 1, bp, s, digest="shared")
    out = load(str(tmp_path), 1, digest="shared")
    np.testing.assert_array_equal(out[0], bp)
    np.testing.assert_array_equal(out[1], s)
    assert load(str(tmp_path), 1, digest="other") is None


@pytest.mark.parametrize("field,value,changes", [
    ("kappa", 0.5, True), ("log_path", "x.jsonl", False),
    ("checkpoint_dir", "ck", False), ("level_retries", 3, False),
    ("dispatch_timeout_s", 9.0, False)])
def test_run_digest_fields(field, value, changes):
    base = TParams()
    d0 = ckpt.run_digest(base, (16, 16), (16, 16))
    d1 = ckpt.run_digest(base.replace(**{field: value}), (16, 16), (16, 16))
    assert (d0 != d1) is changes
    assert ckpt.run_digest(base, (16, 16), (16, 17)) != d0


# -------------------------------------------------------------------- log


def test_log_path_writes_one_record_per_level(tmp_path):
    """One record per level with its stats.  The JAX package's log also
    opens with a run manifest and closes with ``run_end``: those wait for
    the port of obs (ROADMAP Queue 1 item 10)."""
    a, ap, b = make_pair(12, 12, seed=5)
    log = str(tmp_path / "log.jsonl")
    _port(a, ap, b, log_path=log)
    recs = _records(log)
    assert [r["level"] for r in recs] == [1, 0]
    for r in recs:
        for key in ("level", "db_rows", "pixels", "coherence_ratio", "ms",
                    "backend", "ts"):
            assert key in r, key
        assert not any(k.startswith("_") for k in r)


# ---------------------------------------------------------------- retries


def test_injected_fault_recovers_and_matches_jax(tmp_path):
    a, ap, b = make_pair(14, 14, seed=5)
    log = str(tmp_path / "log.jsonl")
    failure.inject_failures(1)  # the first level's first attempt dies
    res = _port(a, ap, b, level_retries=2, log_path=log)
    retries = _events(log, "level_retry")
    assert len(retries) == 1 and retries[0]["error"] == "InjectedFailure"
    assert retries[0]["level"] == 1 and retries[0]["attempt"] == 1
    _same_bits(res, _jax(a, ap, b))


def test_exhausted_budget_propagates_the_original_exception(tmp_path):
    log = str(tmp_path / "log.jsonl")
    raised = []

    def always_oom():
        exc = torch.cuda.OutOfMemoryError("CUDA out of memory (synthetic)")
        raised.append(exc)
        raise exc

    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        failure.run_with_retry(always_oom, retries=2, backoff_s=0.0,
                               log_path=log, context={"level": 3})
    assert len(raised) == 3 and ei.value is raised[-1]
    assert len(_events(log, "level_retry")) == 2
    done = _events(log, "retry_exhausted")
    assert len(done) == 1 and done[0]["attempts"] == 3
    assert done[0]["error"] == "OutOfMemoryError" and done[0]["level"] == 3


def test_exhausted_budget_in_a_run_propagates():
    a, ap, b = make_pair(12, 12, seed=5)
    failure.inject_failures(3)  # more faults than the budget
    with pytest.raises(failure.InjectedFailure):
        _port(a, ap, b, levels=1, level_retries=1)


@pytest.mark.parametrize("exc", [
    ValueError("a bug, not a fault"),
    RuntimeError("argmin_l2 launch: CUDA error 700 (an illegal memory "
                 "access was encountered)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA kernel build failed:\nargmin_l2: nvcc exit 1"),
], ids=["value_error", "launch_error", "torch_cuda_error", "build_failure"])
def test_non_transient_errors_are_not_retried(exc):
    calls = []

    def bad():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        failure.run_with_retry(bad, retries=5, backoff_s=0.0)
    assert len(calls) == 1


def _chained(inner, depth=2):
    exc = inner
    for k in range(depth):
        try:
            try:
                raise exc
            except BaseException as e:
                raise RuntimeError(f"wrapper {k}") from e
        except RuntimeError as outer:
            exc = outer
    return exc


def test_is_transient_walks_chains_and_cycles():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert failure._is_transient(_chained(oom))
    assert failure._is_transient(_chained(failure.InjectedFailure("x")))
    assert failure._is_transient(failure.WatchdogTimeout("wedged"))
    assert not failure._is_transient(_chained(RuntimeError(
        "argmin_l2 launch: CUDA error 700 (an illegal memory access was "
        "encountered)")))
    assert not failure._is_transient(_chained(ValueError("plain bug")))
    loop = RuntimeError("loop")
    loop.__context__ = loop
    assert not failure._is_transient(loop)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_backoff_delay_equals_jax(seed):
    for attempt in range(1, 7):
        assert failure.backoff_delay(attempt, jitter_seed=seed) == \
            jfailure.backoff_delay(attempt, jitter_seed=seed)
    assert failure.backoff_delay(3, backoff_s=0.0) == 0.0


def test_retry_resets_the_device_state(monkeypatch):
    """A retry clears the upload cache and argmin_l2's merge workspaces
    before the next attempt."""
    from image_analogies_tpu_torch.ops import match

    devcache.device_put_cached(np.ones((128, 128), np.float32), CPU)
    match._ARGMIN_WORKSPACE[(0, 0)] = (torch.zeros(1), torch.zeros(1))
    seen = []

    def flaky():
        seen.append((len(devcache._cache), len(match._ARGMIN_WORKSPACE)))
        if len(seen) == 1:
            raise failure.InjectedFailure("first attempt")
        return "ok"

    assert failure.run_with_retry(flaky, retries=1, backoff_s=0.0) == "ok"
    assert seen == [(1, 1), (0, 0)]


# --------------------------------------------------------------- watchdog


def test_watchdog_times_out_a_wedged_body(tmp_path):
    log = str(tmp_path / "log.jsonl")
    t0 = time.monotonic()
    with pytest.raises(failure.WatchdogTimeout):
        failure.run_with_watchdog(lambda: time.sleep(1.0), 0.05,
                                  context={"level": 2}, log_path=log)
    assert time.monotonic() - t0 < 0.9
    rec = _events(log, "watchdog_timeout")
    assert len(rec) == 1 and rec[0]["level"] == 2
    assert rec[0]["timeout_s"] == 0.05


def test_watchdog_inside_retry_recovers():
    calls = []

    def body():
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            time.sleep(0.6)
        return "recovered"

    assert failure.run_with_retry(
        lambda: failure.run_with_watchdog(body, 0.05), retries=2,
        backoff_s=0.0) == "recovered"
    assert calls == ["ia-watchdog-body"] * 2


def test_watchdog_zero_timeout_runs_inline():
    ident = []

    def body():
        ident.append(threading.current_thread())
        return 7

    assert failure.run_with_watchdog(body, 0.0) == 7
    assert ident == [threading.main_thread()]


def test_watchdogged_run_loads_kernels_first_and_matches_jax():
    """With a deadline the driver loads every level's kernel libraries
    before the level loop (never a build under the deadline); the run
    equals the JAX package's."""
    order = []

    class Spy(CudaMatcher):
        def load_kernels(self, jobs):
            order.append(("load", sorted(job.level for job in jobs)))

        def build_features(self, job):
            order.append(("build", job.level))
            return super().build_features(job)

    a, ap, b = make_pair(16, 16, seed=5)
    params = TParams(levels=2, device="cpu", level_retries=1,
                     dispatch_timeout_s=60.0)
    res = t_create(a, ap, b, params, backend=Spy(params, CPU))
    assert order == [("load", [0, 1]), ("build", 1), ("build", 0)]
    _same_bits(res, _jax(a, ap, b))
    order.clear()
    t_create(a, ap, b, params.replace(dispatch_timeout_s=0.0),
             backend=Spy(params, CPU))
    assert order == [("build", 1), ("build", 0)]


def _level_jobs(params, size, channels=0):
    from image_analogies_tpu_torch.ops.pyramid import num_feasible_levels

    levels = num_feasible_levels((size, size), params.levels,
                                 params.patch_size)
    shape = lambda lv: (size >> lv, size >> lv) + ((channels,)
                                                   if channels else ())
    return [LevelJob(level=lv,
                     spec=spec_for_level(params, lv, levels, channels or 1),
                     kappa_mult=1.0, a_src=np.zeros(shape(lv), np.float32),
                     a_filt=np.zeros(shape(lv)[:2], np.float32),
                     b_src=np.zeros(shape(lv), np.float32))
            for lv in range(levels)]


@pytest.mark.parametrize("case,want", [
    ("npr_1024", ["packed2k_best"] * 2 + ["argmin_l2"] * 3),
    ("batched", ["argmin_bf16"] * 5),
    ("exact", [None] * 5),
    ("exact_hi2", ["packed3_best"] * 5),
    ("rgb_patch7_exact_hi2", ["packed3w_best"] * 2),
    ("rgb_patch7_auto", ["packed2kw_best"] * 2),
    ("scan_rescue", ["pertile_champions"] * 5),
    ("two_pass_1p", ["argmin2"] * 5),
])
def test_kernel_libraries_follow_the_routes(case, want, monkeypatch):
    """The libraries a watchdogged run loads up front are the ones its
    levels launch: the anchor mode's by the width rules, or the
    approximate match's (a matcher for the card, asked on the CPU: no
    kernel runs)."""
    monkeypatch.setenv("IA_EXPERIMENTAL", "1")
    params, channels = PRESETS["npr_1024"], 0
    if case in ("batched", "exact"):
        params = params.replace(strategy=case)
    elif case in ("exact_hi2", "scan_rescue", "two_pass_1p"):
        params = params.replace(match_mode=case)
    elif case.startswith("rgb_patch7"):
        params = PRESETS["super_resolution"].replace(
            color_mode="source_rgb", remap_luminance=False,
            match_mode="exact_hi2" if case.endswith("exact_hi2")
            else "auto")
        channels = 3
    matcher = CudaMatcher(params, torch.device("cuda"))
    jobs = _level_jobs(params, 1024, channels)
    got = [(matcher.kernel_libraries(job) or (None,))[0] for job in jobs]
    assert got == want
    assert CudaMatcher(params, CPU).kernel_libraries(jobs[0]) == ()


# ------------------------------------------------- pipeline and donation


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_pipelined_donating_run_is_bit_identical(strategy):
    """pipeline + donation + no per-level wait against the lock-step run
    and the JAX package's lock-step run."""
    a, ap, b = make_pair(20, 22, seed=5)
    seq = _port(a, ap, b, strategy=strategy, pipeline=False,
                donate_buffers=False)
    pipe = _port(a, ap, b, strategy=strategy, level_sync=False,
                 pipeline=True, donate_buffers=True)
    _same_bits(pipe, seq)
    _same_bits(pipe, _jax(a, ap, b, strategy=strategy))
    assert pipe.timing["donated_levels"] == 1.0
    assert "donated_levels" not in seq.timing


def test_pipeline_timing_accounting():
    a, ap, b = make_pair(20, 22, seed=6)
    res = _port(a, ap, b, levels=3, level_sync=False)
    t = res.timing
    assert t["prepped_levels"] == 2.0  # levels - 1 lookaheads
    assert t["prefetch_errors"] == 0.0
    assert t["prep_ms"] >= 0.0 and t["wait_ms"] >= 0.0
    assert t["host_hidden_ms"] >= 0.0 and t["host_gap_ms"] >= 0.0
    for st in res.stats:  # nothing waited for: no device time per level
        assert "enqueue_ms" in st and "ms" not in st


def test_sequential_run_records_host_gap_and_no_prep():
    a, ap, b = make_pair(16, 16, seed=7)
    res = _port(a, ap, b)
    assert res.timing["host_gap_ms"] >= 0.0
    assert "prep_ms" not in res.timing and "prepped_levels" not in \
        res.timing
    assert "donated_levels" not in res.timing  # auto: on the card only
    for st in res.stats:
        assert "ms" in st and "enqueue_ms" not in st


def test_retries_turn_off_pipeline_and_donation():
    p = TParams(device="cpu", levels=2, level_retries=1, pipeline=True,
                donate_buffers=True, level_sync=False)
    assert p.pipeline_active() is False
    a, ap, b = make_pair(20, 22, seed=8)
    failure.inject_failures(1)
    res = t_create(a, ap, b, p)
    assert "donated_levels" not in res.timing
    assert "prep_ms" not in res.timing
    for st in res.stats:  # retries force the per-level wait
        assert "ms" in st
    _same_bits(res, _jax(a, ap, b))


def test_failing_prefetch_is_swallowed_and_counted():
    class Broken(CudaMatcher):
        def prefetch_level(self, job):
            raise OSError("prefetch fault")

    a, ap, b = make_pair(20, 22, seed=6)
    params = TParams(levels=3, device="cpu", level_sync=False)
    res = t_create(a, ap, b, params, backend=Broken(params, CPU))
    assert res.timing["prefetch_errors"] == 2.0
    _same_bits(res, _port(a, ap, b, levels=3))


# --------------------------------------------------------------- devcache


def test_devcache_is_content_keyed():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    orig = a.copy()
    d1 = devcache.device_put_cached(a, CPU)
    assert devcache.device_put_cached(a.copy(), CPU) is d1  # same bytes
    a2 = a.copy()
    a2[0, 0] += 1.0
    d3 = devcache.device_put_cached(a2, CPU)
    assert d3 is not d1
    np.testing.assert_array_equal(d3.numpy(), a2)
    a[:] = 0.0  # the cached copy never aliases the caller's array
    np.testing.assert_array_equal(d1.numpy(), orig)
    # float64 input is cached as its float32 bytes
    assert devcache.device_put_cached(a2.astype(np.float64), CPU) is d3
    tiny = np.zeros((4,), np.float32)  # passes through, never cached
    t1 = devcache.device_put_cached(tiny, CPU)
    assert devcache.device_put_cached(tiny, CPU) is not t1
    assert len(devcache._cache) == 2
    assert devcache.device_put_cached(None, CPU) is None


def test_devcache_budget_evicts_least_recently_used(monkeypatch):
    plane = 128 * 128 * 4  # 64 KiB: the smallest cached size
    devcache.set_max_bytes(3 * plane)
    arrs = [np.full((128, 128), float(k), np.float32) for k in range(4)]
    first = [devcache.device_put_cached(x, CPU) for x in arrs[:3]]
    assert devcache.device_put_cached(arrs[0], CPU) is first[0]  # touch
    devcache.device_put_cached(arrs[3], CPU)  # evicts arrs[1], the oldest
    assert devcache._bytes == 3 * plane
    assert devcache.device_put_cached(arrs[0], CPU) is first[0]
    assert devcache.device_put_cached(arrs[2], CPU) is first[2]
    assert devcache.device_put_cached(arrs[1], CPU) is not first[1]
    monkeypatch.setenv("IA_DEVCACHE_BYTES", str(plane))  # env wins
    assert devcache.max_bytes() == plane
    devcache.device_put_cached(arrs[3], CPU)
    assert devcache._bytes == plane


def test_cached_planes_are_unchanged_after_a_run():
    """Every consumer treats a cached upload as immutable: after two full
    runs (and the gather maps of the batched strategy) each cached plane
    still hashes to its key."""
    import hashlib

    a, ap, b = make_pair(128, 128, seed=3)  # planes at the 64 KiB floor
    for strategy in ("wavefront", "batched"):
        res = _port(a, ap, b, levels=1, strategy=strategy, kappa=5.0)
        assert res.bp_y.shape == (128, 128)
    keys = list(devcache._cache)
    planes = [k for k in keys if k[0] != "gather_maps"]
    assert len(planes) == 3 and len(keys) == 4  # A, A', B; batched's maps
    for key in planes:
        value = devcache._cache[key].value
        assert hashlib.sha1(value.numpy().tobytes()).hexdigest() == key[0]


# -------------------------------------------- profile and saved levels


def test_profile_dir_writes_a_trace(tmp_path):
    a, ap, b = make_pair(12, 12, seed=5)
    prof = tmp_path / "prof"
    _port(a, ap, b, levels=1, profile_dir=str(prof))
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_save_levels_writes_one_png_per_level(tmp_path):
    a, ap, b = make_pair(20, 22, seed=5)
    out = tmp_path / "levels"
    res = t_create(a, ap, b, TParams(levels=3, device="cpu",
                                     save_levels_dir=str(out)),
                   keep_levels=True)
    assert sorted(os.listdir(out)) == [f"level_{i:02d}.png"
                                       for i in range(3)]
    for lv, (bp, _) in enumerate(res.levels):
        want = (np.clip(bp, 0, 1) * 255.0 + 0.5).astype(np.uint8) / 255.0
        np.testing.assert_allclose(load_image(str(out /
                                                  f"level_{lv:02d}.png")),
                                   want, atol=1e-6)


def test_gate_probe_is_hermetic():
    """The bf16 gate's probe synthesis writes nothing of the caller's and
    waits on no deadline: every surrounding knob is off."""
    base = gate._probe_base_params(TParams(
        checkpoint_dir="ck", resume_from_level=0, log_path="l.jsonl",
        save_levels_dir="lv", profile_dir="prof", level_retries=2,
        dispatch_timeout_s=1.0, level_sync=False, pipeline=True,
        donate_buffers=True))
    assert (base.checkpoint_dir, base.resume_from_level, base.log_path,
            base.save_levels_dir, base.profile_dir) == (None,) * 5
    assert (base.level_retries, base.dispatch_timeout_s, base.level_sync,
            base.pipeline, base.donate_buffers) == (0, 0.0, True, False,
                                                     False)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("flag,value,field,want", [
    ("--no-level-sync", None, "level_sync", False),
    ("--level-retries", "2", "level_retries", 2),
    ("--dispatch-timeout-s", "1.5", "dispatch_timeout_s", 1.5),
    ("--checkpoint-dir", "ck", "checkpoint_dir", "ck"),
    ("--resume-from-level", "1", "resume_from_level", 1),
    ("--log-path", "run.jsonl", "log_path", "run.jsonl"),
    ("--save-levels", "lv", "save_levels_dir", "lv"),
    ("--profile-dir", "prof", "profile_dir", "prof"),
    ("--devcache-bytes", "4096", "devcache_max_bytes", 4096),
])
@pytest.mark.parametrize("cmd", ["run", "video", "sweep"])
def test_cli_flag_reaches_its_field(cmd, flag, value, field, want):
    argv = {"run": ["run", "--ap", "x.png", "--out", "y.png"],
            "video": ["video", "--a", "a.png", "--ap", "x.png", "--frames",
                      "f.png", "--out-dir", "o"],
            "sweep": ["sweep", "--ap", "x.png", "--b", "b.png",
                      "--out-dir", "o"]}[cmd]
    args = tcli.build_parser().parse_args(
        argv + [flag] + ([value] if value is not None else []))
    params = tcli._params_from_args(args, PRESETS["oil_filter"])
    assert getattr(params, field) == want
    default = tcli._params_from_args(tcli.build_parser().parse_args(argv),
                                     PRESETS["oil_filter"])
    assert getattr(default, field) == getattr(PRESETS["oil_filter"], field)


def test_cli_run_writes_checkpoints_and_log(tmp_path, capsys):
    from image_analogies_tpu_torch.utils import assets

    for name, img in assets.make_all(16, 1).items():
        if name.startswith("filter_"):
            save_image(str(tmp_path / f"{name}.png"), img)
    ck, log = tmp_path / "ck", tmp_path / "run.jsonl"
    rc = tcli.main(["run", "--mode", "filter", "--a",
                    str(tmp_path / "filter_a.png"), "--ap",
                    str(tmp_path / "filter_ap.png"), "--b",
                    str(tmp_path / "filter_b.png"), "--out",
                    str(tmp_path / "bp.png"), "--levels", "2",
                    "--device", "cpu", "--checkpoint-dir", str(ck),
                    "--log-path", str(log), "--no-level-sync"])
    capsys.readouterr()
    assert rc == 0 and os.path.exists(tmp_path / "bp.png")
    assert sorted(os.listdir(ck)) == ["level_00.npz", "level_01.npz"]
    assert [r["level"] for r in _records(str(log))] == [1, 0]
