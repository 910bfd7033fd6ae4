"""The port's lane engine (``image_analogies_tpu_torch/batch/``, the lane
forms of ``backends/cuda.py``'s scans, ``tune/``) on the CPU.

Inputs are NumPy arrays made from a seed and handed to both packages.
Held here:

- ``tune/buckets.py`` and ``batch_pad_waste_pct`` against the JAX
  package's;
- every lane bit-identical to the port's singleton run of its member
  (``bp``, ``bp_y``, the source map, coherence and refined ratios), for the
  wavefront and batched strategies, gray and ``source_rgb``, an even and
  an odd width, every anchor mode, and bucketed members of different
  heights; padded query rows never reach a real row;
- the port's lanes against the JAX engine (``backend="tpu"`` on JAX's
  CPU), to ``test_torch_strategies.py``'s standard: equal source maps, B'
  within 1e-5, equal ratios;
- every refusal with the JAX engine's reason on the same inputs, lane-fault
  isolation, and one anchor (approximate-match) call a step (row) for all
  lanes.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from image_analogies_tpu.batch import BatchIncompatible as JIncompatible
from image_analogies_tpu.batch import (
    create_image_analogy_batch as j_batch,
)
from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.tune import buckets as jbuckets
from image_analogies_tpu.tune import geometry as jgeometry
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import (
    BatchIncompatible,
    create_image_analogy,
    create_image_analogy_batch,
)
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.backends.base import LevelJob
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.tune import buckets as tbuckets
from image_analogies_tpu_torch.tune import resolve as tresolve
from tests.test_torch_wavefront import _bits, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
PROBE_MODES = ("scan_rescue", "scan_rescue_1p", "two_pass", "two_pass_1p")


def _kw(**kw):
    """Fields both packages' params take (the lanes need
    remap_luminance=False: remapped A planes differ per target)."""
    kw.setdefault("levels", 2)
    kw.setdefault("remap_luminance", False)
    return kw


def _load(shapes, seed=7, channels=0):
    """One exemplar pair and a target of each shape, uniform in [0, 1)."""
    rng = np.random.RandomState(seed)
    ext = (channels,) if channels else ()
    h, w = shapes[0]
    a = rng.rand(h, w, *ext).astype(np.float32)
    ap = rng.rand(h, w, *ext).astype(np.float32)
    return a, ap, [rng.rand(hh, ww, *ext).astype(np.float32)
                   for hh, ww in shapes]


def _same_run(res, ref, lanes):
    """A lane of ``lanes`` against its singleton's result, bit for bit."""
    assert not isinstance(res, Exception), res
    assert _bits(res.bp).tobytes() == _bits(ref.bp).tobytes()
    assert _bits(res.bp_y).tobytes() == _bits(ref.bp_y).tobytes()
    np.testing.assert_array_equal(res.source_map, ref.source_map)
    assert len(res.stats) == len(ref.stats)
    for st, st_ref in zip(res.stats, ref.stats):
        assert st["level"] == st_ref["level"]
        assert st["coherence_ratio"] == st_ref["coherence_ratio"]
        assert st.get("refined_ratio") == st_ref.get("refined_ratio")
        assert st.get("match_mode") == st_ref.get("match_mode")
        assert st["lanes"] == lanes and "lanes" not in st_ref
    assert res.timing == {"lanes": float(lanes)}


def _hold_to_singletons(a, ap, targets, params, **kw):
    results = create_image_analogy_batch(a, ap, targets, params,
                                         device="cpu", **kw)
    assert len(results) == len(targets)
    for b, res in zip(targets, results):
        assert res.bp.shape[:2] == b.shape[:2]
        _same_run(res, create_image_analogy(a, ap, b, params, device="cpu",
                                            **kw), len(targets))
    return results


# ------------------------------------------------------------------ tune/


@pytest.mark.parametrize("fn", ["bucket_rows", "pad_waste_frac",
                                "buckets_enabled"])
def test_bucket_functions_match_jax(fn, monkeypatch):
    ns = np.arange(1, 70001)
    if fn == "bucket_rows":
        assert [tbuckets.bucket_rows(int(n)) for n in ns] == [
            jbuckets.bucket_rows(int(n)) for n in ns]
    elif fn == "pad_waste_frac":
        for bucket in (0, 4096):
            assert [tbuckets.pad_waste_frac(int(n), bucket) for n in ns] == [
                jbuckets.pad_waste_frac(int(n), bucket) for n in ns]
    else:
        for env in ("", "1", "0", "false", "no", "off", "yes", " On ",
                    "TRUE", "junk"):
            monkeypatch.setenv("IA_SHAPE_BUCKETS", env)
            for flag in (False, True):
                got = tbuckets.buckets_enabled(TParams(shape_buckets=flag))
                want = jbuckets.buckets_enabled(JParams(shape_buckets=flag))
                assert got == want, (env, flag)
            assert tbuckets.buckets_enabled() == jbuckets.buckets_enabled()


@pytest.mark.parametrize("env,want,warns", [
    (None, jgeometry.DEFAULT_BATCH_PAD_WASTE, False), ("60", 60, False),
    (" 7 ", 7, False), ("abc", 25, True), ("0", 25, True),
    ("-5", 25, True)])
def test_batch_pad_waste_pct(env, want, warns, monkeypatch, caplog):
    """The default (the JAX package's), the env value, and a bad value
    ignored with one warning a process."""
    monkeypatch.setattr(tresolve, "_ENV_WARNED", set())
    if env is None:
        monkeypatch.delenv("IA_BATCH_PAD_WASTE", raising=False)
    else:
        monkeypatch.setenv("IA_BATCH_PAD_WASTE", env)
    with caplog.at_level(logging.WARNING, logger="image_analogies_tpu_torch"):
        assert tresolve.batch_pad_waste_pct() == want
        assert tresolve.batch_pad_waste_pct() == want
    warned = [r for r in caplog.records if "IA_BATCH_PAD_WASTE" in
              r.getMessage()]
    assert len(warned) == int(warns)


def test_shape_buckets_field():
    assert TParams().shape_buckets is False
    assert TParams(shape_buckets=True).shape_buckets is True


# ------------------------------------------------ lanes against singletons


@pytest.mark.parametrize("kind", ["gray", "source_rgb"])
@pytest.mark.parametrize("shape", [(16, 16), (17, 21)])
@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_lanes_bit_identical_to_singletons(strategy, shape, kind):
    """k = 3 lanes at an even and at an odd width (21: lanes of 24
    columns in a batched row, three of them pad)."""
    channels = 3 if kind == "source_rgb" else 0
    extra = dict(color_mode="source_rgb") if channels else {}
    a, ap, targets = _load([shape] * 3, seed=11, channels=channels)
    params = TParams(**_kw(strategy=strategy, **extra))
    _hold_to_singletons(a, ap, targets, params)


@pytest.mark.parametrize("mode", ["exact_hi", "exact_hi2_2p", "exact_hi2",
                                  *PROBE_MODES])
def test_lanes_bit_identical_in_every_anchor_mode(mode, monkeypatch):
    monkeypatch.setenv("IA_EXPERIMENTAL", "1")
    a, ap, targets = _load([(16, 16)] * 3, seed=5)
    params = TParams(**_kw(strategy="wavefront", match_mode=mode))
    for res in _hold_to_singletons(a, ap, targets, params):
        assert {st["match_mode"] for st in res.stats} == {mode}


def test_lanes_bit_identical_with_the_bf16_approx_form():
    """Batched lanes with the card's approximate-match form (the bf16
    kernel's plain version, ``bf16_approx=True``) at k x wbp rows a call."""
    a, ap, targets = _load([(17, 21)] * 3, seed=3)
    params = TParams(**_kw(strategy="batched"))
    backend = tcuda.CudaMatcher(params, CPU, bf16_approx=True)
    _hold_to_singletons(a, ap, targets, params, backend=backend)


@pytest.mark.parametrize("width", [20, 21])
def test_bucketed_mixed_heights_bit_identical(width):
    """One query bucket at every level, three heights: each lane equals
    its singleton, bucketed and not (shape_buckets changes no bit)."""
    a, ap, targets = _load([(20, width), (22, width), (21, width)], seed=11)
    params = TParams(**_kw(strategy="batched", patch_size=3,
                           shape_buckets=True))
    for b, res in zip(targets, _hold_to_singletons(a, ap, targets, params)):
        plain = create_image_analogy(
            a, ap, b, params.replace(shape_buckets=False), device="cpu")
        assert _bits(res.bp_y).tobytes() == _bits(plain.bp_y).tobytes()
        np.testing.assert_array_equal(res.source_map, plain.source_map)


def _level(params, b, a, ap):
    spec = tfeat.spec_for_level(params, 0, 1, 1)
    return LevelJob(level=0, spec=spec,
                    kappa_mult=params.kappa_factor(0) ** 2,
                    a_src=a, a_filt=ap, b_src=b)


def _poison(db, n):
    """The level state with every query-side row past ``n`` poisoned."""
    sq, fi = db.static_q.clone(), db.flat_idx.clone()
    vd, wr = db.valid.clone(), db.written.clone()
    sq[n:] = 1e9  # any read would swing every distance it touches
    fi[n:] = 3  # in range: a read would gather a REAL pixel
    vd[n:] = 1.0  # pad rows claim every neighbour valid
    wr[n:] = 1.0  # ... and written
    return dataclasses.replace(db, static_q=sq, flat_idx=fi, valid=vd,
                               written=wr)


@pytest.mark.parametrize("lanes", [1, 2])
def test_query_padding_is_honest_under_adversarial_pad(lanes):
    """Poison the bucket's pad rows of every query-side tensor: no output
    bit and no count moves, in a singleton (its row loop stops at the real hb) and in
    lanes of heights 12 and 14 (the shorter lane's rows 12-13 read its own
    pad rows and write carry rows the crop drops)."""
    params = TParams(levels=1, patch_size=3, strategy="batched",
                     remap_luminance=False, shape_buckets=True)
    rng = np.random.RandomState(5)
    a = rng.rand(12, 12).astype(np.float32)
    ap = rng.rand(12, 12).astype(np.float32)
    bs = [rng.rand(12 + 2 * i, 12).astype(np.float32) for i in range(lanes)]
    m = tcuda.CudaMatcher(params, CPU)
    jobs = [_level(params, b, a, ap) for b in bs]
    dbs = [m.build_features(job) for job in jobs]
    assert all(db.static_q.shape[0] == 256 for db in dbs)  # bucketed
    bad = [_poison(db, b.size) for db, b in zip(dbs, bs)]
    if lanes == 1:
        outs = [m.synthesize_level(dbs[0], jobs[0])]
        poisoned = [m.synthesize_level(bad[0], jobs[0])]
    else:
        outs = m.synthesize_level_lanes(dbs, jobs)
        poisoned = m.synthesize_level_lanes(bad, jobs)
    for b, (bp0, s0, st0), (bp1, s1, st1) in zip(bs, outs, poisoned):
        assert bp0.shape == s0.shape == b.shape
        assert torch.equal(bp0, bp1) and torch.equal(s0, s1)
        for key in ("_n_coh", "_n_ref"):  # pad rows stay out of the counts
            assert int(st0[key]) == int(st1[key])


@pytest.mark.parametrize("sync", [True, False])
def test_lane_stats(sync):
    """Each lane's stats: ``lanes``, the scan's wall as ``ms`` (or
    ``enqueue_ms`` without level_sync), device-scalar counts."""
    params = TParams(**_kw(strategy="batched", level_sync=sync, levels=1))
    a, ap, targets = _load([(16, 16)] * 2)
    m = tcuda.CudaMatcher(params, CPU)
    jobs = [_level(params, b, a, ap) for b in targets]
    outs = m.synthesize_level_lanes([m.build_features(j) for j in jobs],
                                    jobs)
    for _, _, st in outs:
        assert st["lanes"] == 2 and st["pixels"] == 256
        assert st["strategy"] == "batched" and st["backend"] == "cpu"
        assert ("ms" in st) == sync == ("pixels_per_s" in st)
        assert ("enqueue_ms" in st) == (not sync)
        for key in ("_n_coh", "_n_ref"):
            assert isinstance(st[key], torch.Tensor) and st[key].dim() == 0
    assert outs[0][2]["_n_coh"] is not outs[1][2]["_n_coh"]


# ------------------------------------------------- against the JAX engine


@pytest.mark.parametrize("kind", ["gray", "source_rgb"])
@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_lanes_match_the_jax_engine(strategy, kind):
    """The port's lanes against JAX ``create_image_analogy_batch`` on
    JAX's CPU: equal source maps, B' within 1e-5, equal ratios."""
    channels = 3 if kind == "source_rgb" else 0
    extra = dict(color_mode="source_rgb") if channels else {}
    a, ap, targets = _load([(16, 16)] * 3, seed=21, channels=channels)
    kw = _kw(strategy=strategy, kappa=3.0, **extra)
    refs = j_batch(a, ap, targets, JParams(backend="tpu", **kw))
    ports = create_image_analogy_batch(a, ap, targets, TParams(**kw),
                                       device="cpu")
    for port, ref in zip(ports, refs):
        assert not isinstance(ref, Exception), ref
        np.testing.assert_array_equal(port.source_map,
                                      np.asarray(ref.source_map))
        np.testing.assert_allclose(port.bp, np.asarray(ref.bp), rtol=0,
                                   atol=1e-5)
        for st, st_j in zip(port.stats, ref.stats):
            assert st["coherence_ratio"] == st_j["coherence_ratio"]
            assert st.get("refined_ratio") == st_j.get("refined_ratio")


def _refusal_case(case, tmp_path):
    """(A, A', targets, params kw) of each refusal, the JAX engine's."""
    a, ap, targets = _load([(16, 16)] * 2)
    kw = _kw(strategy="batched", levels=1)
    if case == "level_retries":
        kw["level_retries"] = 1
    elif case in ("exact", "rowwise"):
        kw["strategy"] = case
    elif case == "checkpoint":
        kw["checkpoint_dir"] = str(tmp_path / "ckpt")
    elif case == "save_levels":
        kw["save_levels_dir"] = str(tmp_path / "levels")
    elif case == "profile":
        kw["profile_dir"] = str(tmp_path / "prof")
    elif case == "resume":
        kw["resume_from_level"] = 0
    elif case == "a_ap_shapes":
        ap = ap[:12]
    elif case == "channels":
        a = np.stack([a] * 3, -1)
        kw["color_mode"] = "source_rgb"
    elif case == "wavefront_shapes":
        kw["strategy"] = "wavefront"
        targets = _load([(16, 16), (20, 20)])[2]
    elif case == "unbucketed_shapes":
        targets = _load([(16, 16), (20, 16)])[2]
    elif case == "bucketed_widths":
        kw["shape_buckets"] = True
        targets = _load([(16, 16), (16, 20)])[2]
    elif case == "feasible_levels":
        kw["levels"] = 3
        targets = _load([(16, 16), (6, 6)])[2]
    elif case == "mixed_bucket":
        kw["shape_buckets"] = True
        targets = _load([(16, 16), (40, 16)])[2]  # buckets 256 and 768
    elif case == "remap":
        kw["remap_luminance"] = True
    elif case == "pad_waste":
        kw["shape_buckets"] = True
        targets = _load([(17, 16)] * 2, seed=9)[2]  # 272 of 512 rows
    return a, ap, targets, kw


REFUSALS = {
    "level_retries": "level_retries", "exact": "unsupported",
    "rowwise": "unsupported", "checkpoint": "unsupported",
    "save_levels": "unsupported", "profile": "unsupported",
    "resume": "unsupported", "a_ap_shapes": "shape_mismatch",
    "channels": "shape_mismatch", "wavefront_shapes": "shape_mismatch",
    "unbucketed_shapes": "shape_mismatch",
    "bucketed_widths": "shape_mismatch",
    "feasible_levels": "shape_mismatch", "mixed_bucket": "mixed_bucket",
    "remap": "remap_divergence", "pad_waste": "pad_waste"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_the_jax_engine(case, tmp_path, monkeypatch):
    """Each refusal on the JAX engine's own inputs: the port raises
    BatchIncompatible with the JAX engine's reason, before any scan."""
    monkeypatch.delenv("IA_BATCH_PAD_WASTE", raising=False)
    monkeypatch.delenv("IA_SHAPE_BUCKETS", raising=False)
    a, ap, targets, kw = _refusal_case(case, tmp_path)
    with pytest.raises(JIncompatible) as jexc:
        j_batch(a, ap, targets, JParams(backend="tpu", **kw))
    scans = []
    monkeypatch.setattr(tcuda.CudaMatcher, "synthesize_level_lanes",
                        lambda self, dbs, jobs: scans.append(1))
    with pytest.raises(BatchIncompatible) as exc:
        create_image_analogy_batch(a, ap, targets, TParams(**kw),
                                   device="cpu")
    assert exc.value.reason == jexc.value.reason == REFUSALS[case]
    assert not scans


def test_pad_waste_env_admits(monkeypatch):
    """IA_BATCH_PAD_WASTE=60 admits the 47%-padded batch that the default
    ceiling refuses, and the admitted lanes stay bit-identical."""
    monkeypatch.setenv("IA_BATCH_PAD_WASTE", "60")
    a, ap, targets, kw = _refusal_case("pad_waste", None)
    _hold_to_singletons(a, ap, targets, TParams(**kw))


# ------------------------------------------------ faults and launches


class _FailingLane(tcuda.CudaMatcher):
    """A matcher whose ``build_features`` raises for the second lane built
    at level 1."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = {}

    def build_features(self, job):
        n = self.calls[job.level] = self.calls.get(job.level, 0) + 1
        if job.level == 1 and n == 2:
            raise RuntimeError("injected lane fault")
        return super().build_features(job)


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_lane_fault_isolation(strategy):
    a, ap, targets = _load([(16, 16)] * 3, seed=13)
    params = TParams(**_kw(strategy=strategy))
    results = create_image_analogy_batch(
        a, ap, targets, params, backend=_FailingLane(params, CPU))
    assert isinstance(results[1], RuntimeError)
    assert "injected lane fault" in str(results[1])
    for i in (0, 2):
        _same_run(results[i], create_image_analogy(a, ap, targets[i], params,
                                                   device="cpu"), 3)


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_one_match_call_a_step_for_every_lane(strategy, monkeypatch):
    """k lanes call the anchor (wavefront) or the approximate match
    (batched) once a step or scan row, as often as one singleton does."""
    name = "make_anchor_fn" if strategy == "wavefront" else "make_approx_fn"
    make = getattr(tcuda, name)
    calls = []

    def counting(db):
        fn = make(db)

        def call(queries):
            calls.append(queries.shape[0])
            return fn(queries)
        return call

    monkeypatch.setattr(tcuda, name, counting)
    a, ap, targets = _load([(16, 18)] * 3, seed=2)
    params = TParams(**_kw(strategy=strategy))
    create_image_analogy_batch(a, ap, targets, params, device="cpu")
    lane_rows = list(calls)
    calls.clear()
    create_image_analogy(a, ap, targets[0], params, device="cpu")
    assert len(lane_rows) == len(calls)
    # c (h - 1) + w steps (c = 3) or h rows, at 16x18 and 8x9
    assert len(calls) == ((3 * 15 + 18) + (3 * 7 + 9) if strategy ==
                          "wavefront" else 16 + 8)
    if strategy == "wavefront":
        assert lane_rows == [3 * m for m in calls]
    else:  # rows of 3 lanes of 24 and 16 columns (18 and 9 rounded to 8)
        assert set(lane_rows) == {72, 48}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    a, ap, targets = _load([(12, 12)] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_image_analogy_batch(a, ap, targets,
                                   TParams(levels=1, remap_luminance=False))


def test_one_member_batch_is_the_singleton():
    a, ap, targets = _load([(16, 16)])
    params = TParams(**_kw())
    (res,) = create_image_analogy_batch(a, ap, targets, params, device="cpu")
    ref = create_image_analogy(a, ap, targets[0], params, device="cpu")
    assert _bits(res.bp_y).tobytes() == _bits(ref.bp_y).tobytes()
    assert all("lanes" not in st for st in res.stats)
    assert create_image_analogy_batch(a, ap, [], params, device="cpu") == []
