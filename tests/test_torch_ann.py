"""The port's two-stage ANN matcher (``image_analogies_tpu_torch/ops/ann.py``,
its wiring in ``backends/cuda.py`` and ``backends/gate.py``, the knobs in
``tune/``) on the CPU, held against the JAX package on seeded NumPy inputs.

- stage 1 (``ann_topm_candidates``): the candidate SETS of ``lax.top_k``,
  exactly, including an m-th-place tie among duplicate DB rows (the lowest
  indices kept), ``n_valid`` below the slab and shape-bucket padding rows,
  which are never chosen;
- stage 2 (``ann_rescore_slab``): equal picks, distances within 1e-6
  relative;
- the fresh basis against ``_ann_arrays_on_device``: means within 1e-5
  and the subspace projector ``proj projᵀ`` within 1e-4 (columns have
  sign freedom);
- syntheses at 32² and 64² (wavefront) and 32² (batched), gate bypassed
  on both sides: every mismatch against the JAX package's two-stage run is
  tie-explained (its ``utils/parity.py``); the gate's verdict on the CPU
  is the JAX package's; a bucketed ANN run against the JAX package's
  bucketed ANN run the same way;
- off is bit-identical to a run without the flag; a refused verdict stays
  exact with ``ann.disabled_unexplained`` / ``ann.fallback_exact``; an
  allowed one counts ``ann.gate_ok`` and ``ann.prefilter_used`` per level;
- ``ann_top_m=1`` still synthesizes; the knobs' precedence (override >
  env > default); ``ia tune --knob ann`` reports and stores nothing; the
  parameter validation; four lanes each give their
  singleton's picks, with one stage-1 product on k M rows a step;
- sealed bases: ``catalog build`` seals one per level and a request hits
  them; a damaged one quarantines, runs that level exact, reseals, and the
  next request hits every level with the first run's bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu.backends import tpu as jtpu
from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import create_image_analogy as j_create
from image_analogies_tpu.ops.pallas_match import (
    ann_rescore_slab as j_rescore,
)
from image_analogies_tpu.ops.pallas_match import (
    ann_topm_candidates as j_topm,
)
from image_analogies_tpu.utils.parity import audit_source_map_mismatches
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch import create_image_analogy_batch
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.backends import gate
from image_analogies_tpu_torch.catalog import ann as catalog_ann
from image_analogies_tpu_torch.catalog import build as catalog_build
from image_analogies_tpu_torch.catalog import tiers
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.ops import ann
from image_analogies_tpu_torch.tune import geometry
from image_analogies_tpu_torch.tune import resolve as tune
from image_analogies_tpu_torch.utils.assets import make_structured
from tests.conftest import make_pair
from tests.test_torch_wavefront import _bits, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
_OK = {"ok": True, "mismatches": 0, "unexplained": 0,
       "first_divergence_is_tie": None}
_REFUSED = {"ok": False, "mismatches": 3, "unexplained": 3,
            "first_divergence_is_tie": False}


@pytest.fixture(autouse=True)
def _clean_ann_state(monkeypatch, tmp_path):
    """Gate verdicts, the catalog's root and the tune store are process
    state: no test leaks them, or reads a developer's."""
    for var in ("IA_ANN_TOP_M", "IA_ANN_PROJ_DIMS", "IA_CATALOG_DIR",
                "IA_CATALOG_HOST_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "no_store.json"))
    gate.reset_ann_gate()
    jtpu.reset_ann_gate()
    tiers.clear()
    tiers.configure(None)
    yield
    gate.reset_ann_gate()
    jtpu.reset_ann_gate()
    tiers.clear()
    tiers.configure(None)


def _stage1_inputs(m=24, n=300, f=20, kp=6, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.rand(m, f).astype(np.float32)
    proj = rng.randn(f, kp).astype(np.float32)
    mean = rng.rand(f).astype(np.float32)
    dbp = rng.randn(n, kp).astype(np.float32)
    return q, proj, mean, dbp


def _halfnorm(dbp):
    return (0.5 * (dbp.astype(np.float64) ** 2).sum(1)).astype(np.float32)


def _both_stage1(q, proj, mean, dbp, dbnh, n_valid, top_m):
    t = ann.ann_topm_candidates(
        torch.from_numpy(q), torch.from_numpy(proj), torch.from_numpy(mean),
        torch.from_numpy(dbp), torch.from_numpy(dbnh), n_valid, top_m)
    j = j_topm(jnp.asarray(q), jnp.asarray(proj), jnp.asarray(mean),
               jnp.asarray(dbp), jnp.asarray(dbnh), n_valid, top_m)
    return t.numpy(), np.asarray(j)


def _same_sets(t, j):
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.sort(t, axis=1), np.sort(j, axis=1))


@pytest.mark.parametrize("seed,top_m", [(0, 16), (1, 64), (2, 1), (3, 299),
                                        (4, 300), (5, 1000)])
def test_stage1_candidate_sets_equal_lax_top_k(seed, top_m):
    q, proj, mean, dbp = _stage1_inputs(seed=seed)
    _same_sets(*_both_stage1(q, proj, mean, dbp, _halfnorm(dbp), 300, top_m))


@pytest.mark.parametrize("top_m", [2, 3, 4, 6])
def test_stage1_boundary_tie_keeps_the_lowest_indices(top_m):
    """Duplicate DB rows give exactly equal projected scores; a query at
    the duplicates ranks them first, so the slab boundary falls inside the
    tie for top_m < 7: ``lax.top_k`` keeps the lowest indices, and so must
    the port (shuffled positions, so index order is not score order)."""
    q, proj, mean, dbp = _stage1_inputs(m=8, seed=7)
    dups = [250, 13, 177, 64, 120, 31, 290]
    dbp[dups] = dbp[dups[0]]
    dbnh = _halfnorm(dbp)
    dbnh[dups] = dbnh[dups[0]]
    # every query projects exactly onto the duplicated row
    q[:] = (mean + np.linalg.pinv(proj.T) @ dbp[dups[0]]).astype(np.float32)
    t, j = _both_stage1(q, proj, mean, dbp, dbnh, 300, top_m)
    _same_sets(t, j)
    assert set(t[0]) == set(sorted(dups)[:top_m])


def test_stage1_ties_across_rows_and_the_chunked_fixup():
    """Many tied rows, a tie group across the boundary in every query row:
    the fix-up pass runs on all of them."""
    rng = np.random.RandomState(11)
    q, proj, mean, dbp = _stage1_inputs(m=40, n=256, seed=11)
    dbp = np.round(dbp * 2) / 2  # coarse grid: many exactly equal rows
    _same_sets(*_both_stage1(q, proj, mean, dbp.astype(np.float32),
                             _halfnorm(dbp), 256, 37))
    q2 = rng.rand(40, 20).astype(np.float32)
    _same_sets(*_both_stage1(q2, proj, mean, dbp.astype(np.float32),
                             _halfnorm(dbp), 256, 5))


@pytest.mark.parametrize("n_valid,top_m", [(5, 16), (1, 4), (200, 16),
                                           (299, 64)])
def test_stage1_padding_rows_never_chosen(n_valid, top_m):
    """Rows at or past ``n_valid`` (a shape bucket's zero rows, which
    project to finite scores) are masked, and the clamp keeps every
    candidate a real row, as in the JAX package."""
    q, proj, mean, dbp = _stage1_inputs(seed=3)
    dbp[n_valid:] = 0.0  # zero rows score finite, near the best
    t, j = _both_stage1(q, proj, mean, dbp, _halfnorm(dbp), n_valid, top_m)
    _same_sets(t, j)
    assert t.max() < n_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage2_rescore_equal_jax(seed):
    rng = np.random.RandomState(seed)
    db = rng.rand(120, 20).astype(np.float32)
    db[77] = db[5]  # a duplicate: the lower index wins
    q = rng.rand(16, 20).astype(np.float32)
    q[3] = db[5]
    cand = rng.randint(0, 120, size=(16, 12)).astype(np.int64)
    cand[3, :3] = [77, 5, 77]  # duplicates from the clamp collapse
    ti, td = ann.ann_rescore_slab(torch.from_numpy(q), torch.from_numpy(db),
                                  torch.from_numpy(cand), 120)
    ji, jd = j_rescore(jnp.asarray(q), jnp.asarray(db),
                       jnp.asarray(cand.astype(np.int32)), 120)
    assert ti.dtype == torch.int64 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=0)
    assert int(ti[3]) == 5


def test_fresh_basis_against_jax():
    """Means within 1e-5 and the subspace projector within 1e-4 of
    ``_ann_arrays_on_device``; the projected DB and its half norms of the
    port's own basis within 1e-4."""
    rng = np.random.RandomState(4)
    scale = np.linspace(2.0, 0.05, 24).astype(np.float32)  # distinct gaps
    src = (rng.randn(500, 24).astype(np.float32) * scale + 0.3)
    tm, tp, tdbp, tdbnh = ann.ann_arrays(torch.from_numpy(src), 8)
    jm, jp, _, _ = jtpu._ann_arrays_on_device(jnp.asarray(src), 8)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    tp, jp = tp.numpy(), np.asarray(jp)
    assert tp.shape == jp.shape == (24, 8)
    np.testing.assert_allclose(tp @ tp.T, jp @ jp.T, atol=1e-4)
    xc = src - tm.numpy()[None, :]
    np.testing.assert_allclose(tdbp.numpy(), xc @ tp, atol=1e-4)
    np.testing.assert_allclose(tdbnh.numpy(),
                               0.5 * ((xc @ tp) ** 2).sum(1), rtol=1e-4)
    # rank clamps to min(dims, F, N)
    assert ann.ann_arrays(torch.from_numpy(src[:5]), 64)[1].shape[1] == 5


# ---------------------------------------------------------- syntheses


def _pair_params(strategy, **kw):
    base = dict(levels=2, kappa=5.0, strategy=strategy, patch_size=3,
                coarse_patch_size=3, **kw)
    return TParams(**base), JParams(backend="tpu", **base)


def _audit(a, ap, b, jp, x, y):
    audit = audit_source_map_mismatches(a, ap, b, jp, x.levels, y.levels)
    assert audit["unexplained"] == 0, audit
    assert audit["first_divergence_is_tie"] in (True, None), audit
    return audit


@pytest.mark.parametrize("strategy,size", [("wavefront", 32),
                                           ("wavefront", 64),
                                           ("batched", 32)])
def test_two_stage_synthesis_against_jax(strategy, size):
    a, ap, b = make_structured(size, 5)
    tp, jp = _pair_params(strategy, ann_prefilter=True)
    with gate.ann_gate_bypass():
        port = t_create(a, ap, b, tp, device="cpu", keep_levels=True)
    with jtpu.ann_gate_bypass():
        ref = j_create(a, ap, b, jp, keep_levels=True)
    if strategy == "wavefront":
        assert [st["match_mode"] for st in port.stats] == ["ann_rescue"] * 2
    _audit(a, ap, b, jp.replace(ann_prefilter=False), port, ref)


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_gate_verdict_on_cpu_equals_jax(strategy):
    tp, jp = _pair_params(strategy, ann_prefilter=True)
    # the JAX gate keys its verdict by the device kind it sees before its
    # probe, which is "any" until some JAX work has brought the backend up
    jnp.zeros(1).block_until_ready()
    key = f"{jtpu.tune.device_kind()}|{strategy}"
    assert gate.ann_gate_allows(tp, CPU, strategy) == \
        jtpu._ann_gate_allows(jp, strategy)
    mine = gate.ann_gate_verdict(CPU, strategy)
    theirs = jtpu._ANN_GATE[key]
    assert mine["ok"] == theirs["ok"]
    assert mine["unexplained"] == theirs["unexplained"] == 0


def test_bucketed_two_stage_against_jax_bucketed():
    """Shape buckets with ANN: the prefilter's DB grows with the bucket's
    zero rows (mean and basis include them, as in the JAX package), stage 1
    masks them; held to the JAX package's bucketed ANN run."""
    a, ap, b = make_pair(40, 44, seed=6)
    tp, jp = _pair_params("wavefront", ann_prefilter=True,
                          shape_buckets=True)
    with gate.ann_gate_bypass():
        port = t_create(a, ap, b, tp, device="cpu", keep_levels=True)
    with jtpu.ann_gate_bypass():
        ref = j_create(a, ap, b, jp, keep_levels=True)
    _audit(a, ap, b, jp.replace(ann_prefilter=False), port, ref)


def test_off_is_bit_identical():
    a, ap, b = make_pair(20, 20, seed=7)
    p = TParams(levels=2, patch_size=3, coarse_patch_size=3)
    x = t_create(a, ap, b, p, device="cpu")
    y = t_create(a, ap, b, p.replace(ann_prefilter=False), device="cpu")
    assert _bits(x.bp).tobytes() == _bits(y.bp).tobytes()
    np.testing.assert_array_equal(x.source_map, y.source_map)


def _counted(a, ap, b, p, runs=1):
    outs = []
    with obs_trace.run_scope(p) as ctx:
        for _ in range(runs):
            outs.append(t_create(a, ap, b, p, device="cpu"))
    snap = ctx.registry.snapshot()
    return outs, snap["counters"], snap["gauges"]


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_refused_verdict_caches_and_stays_exact(monkeypatch, strategy):
    calls = []

    def refused(params, device, strat):
        calls.append(strat)
        return dict(_REFUSED)

    monkeypatch.setattr(gate, "_ann_probe_verdict", refused)
    a, ap, b = make_pair(20, 20, seed=7)
    p = TParams(levels=2, patch_size=3, coarse_patch_size=3,
                strategy=strategy, metrics=True)
    ref = t_create(a, ap, b, p, device="cpu")
    outs, c, _ = _counted(a, ap, b, p.replace(ann_prefilter=True), runs=2)
    assert calls == [strategy]  # the second run hits the cached refusal
    for out in outs:
        assert _bits(out.bp).tobytes() == _bits(ref.bp).tobytes()
    assert c["ann.disabled_unexplained"] == 1
    assert c["ann.fallback_exact"] == 4  # two levels x two runs
    assert "ann.prefilter_used" not in c and "ann.gate_ok" not in c


def test_allowed_verdict_engages_every_level(monkeypatch):
    monkeypatch.setattr(gate, "_ann_probe_verdict",
                        lambda params, device, strat: dict(_OK))
    a, ap, b = make_pair(20, 20, seed=7)
    p = TParams(levels=2, patch_size=3, coarse_patch_size=3, metrics=True,
                ann_prefilter=True)
    (out,), c, g = _counted(a, ap, b, p)
    assert c["ann.gate_ok"] == 1
    assert c["ann.prefilter_used"] == 2
    assert c["ann.projection_built"] == 2  # no catalog root: on the fly
    assert "ann.fallback_exact" not in c
    assert g["ann.top_m"] == tune.ann_top_m() == geometry.DEFAULT_ANN_TOP_M
    assert g["ann.proj_dims"] == 32  # the last (finest) level's: F = 36
    assert [st["match_mode"] for st in out.stats] == ["ann_rescue"] * 2
    assert out.bp.shape == b.shape and np.isfinite(out.bp).all()


def test_unsupported_strategy_is_refused_by_validation():
    with pytest.raises(ValueError, match="ann_prefilter"):
        TParams(strategy="exact", ann_prefilter=True)
    with pytest.raises(ValueError, match="ann_prefilter"):
        TParams(strategy="rowwise", ann_prefilter=True)
    for s in ("wavefront", "batched", "auto"):
        TParams(strategy=s, ann_prefilter=True)
    with pytest.raises(ValueError, match="catalog_host_bytes"):
        TParams(catalog_host_bytes=0)
    TParams(catalog_host_bytes=1, catalog_dir="/x")


def test_top_m_one_is_a_valid_synthesis():
    """Slab floor: one prefilter survivor per query degenerates the
    re-score to the prefilter's champion — still a valid synthesis."""
    a, ap, b = make_structured(32, 5)
    p = TParams(levels=2, kappa=5.0, patch_size=3, coarse_patch_size=3,
                ann_prefilter=True)
    with tune.override(ann_top_m=1), gate.ann_gate_bypass():
        out = t_create(a, ap, b, p, device="cpu")
    assert out.bp.shape == b.shape and np.isfinite(out.bp).all()
    assert out.bp.min() >= ap.min() - 1e-6
    assert out.bp.max() <= ap.max() + 1e-6
    assert (out.source_map >= 0).all() and (out.source_map < a.size).all()


def test_knob_precedence_env_and_override(monkeypatch):
    assert tune.ann_top_m() == geometry.DEFAULT_ANN_TOP_M == 64
    assert tune.ann_proj_dims() == geometry.DEFAULT_ANN_PROJ_DIMS == 32
    monkeypatch.setenv("IA_ANN_TOP_M", "48")
    monkeypatch.setenv("IA_ANN_PROJ_DIMS", "12")
    assert tune.ann_top_m() == 48 and tune.ann_proj_dims() == 12
    with tune.override(ann_top_m=7, ann_proj_dims=5):
        assert tune.ann_top_m() == 7 and tune.ann_proj_dims() == 5
    assert tune.ann_top_m() == 48
    monkeypatch.setenv("IA_ANN_TOP_M", "not-a-number")
    assert tune.ann_top_m() == geometry.DEFAULT_ANN_TOP_M


def test_knobs_resolve_through_the_store(monkeypatch, tmp_path):
    """A store row under the wildcard key ``ia tune --knob ann`` writes is
    read; env still wins over it."""
    from image_analogies_tpu_torch.tune import store as tstore

    path = str(tmp_path / "s.json")
    tstore.merge_entries({tune.make_key("any", "wavefront", "f32", 128,
                                        "*"): {"ann_top_m": 24}}, path)
    monkeypatch.setenv("IA_TUNE_STORE", path)
    assert tune.ann_top_m() == 24
    monkeypatch.setenv("IA_ANN_TOP_M", "40")
    assert tune.ann_top_m() == 40


def test_ann_sweep_reports_and_stores_nothing(tmp_path):
    """``ia tune --knob ann`` on the CPU: each candidate audited against
    the exact run of the probe pair, the default's time beside the
    winner's, and nothing written to the store even with persistence on."""
    from image_analogies_tpu_torch.tune import autotune

    path = tmp_path / "s.json"
    plan = autotune.build_plan(knob="ann", reps=2, candidates=(16, 64),
                               store=str(path), device="cpu")
    res = autotune.run_plan(plan, persist=True)
    (sw,) = res["sweeps"]
    assert res["all_verified"] and sw["verified"]
    assert [r["candidate"]["ann_top_m"] for r in sw["results"]] == [16, 64]
    assert all(r["tie_ok"] for r in sw["results"])
    assert sw["default_ms"] == sw["results"][1]["ms"]
    assert isinstance(sw["beats_default_by_more_than_spread"], bool)
    assert res["persisted"] is None and not path.exists()


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_four_lanes_give_their_singletons_picks(monkeypatch, strategy):
    a, ap, _ = make_pair(24, 24, seed=3)
    targets = [make_pair(24, 24, seed=s)[2] for s in (3, 4, 5, 6)]
    p = TParams(levels=2, patch_size=3, coarse_patch_size=3,
                remap_luminance=False, strategy=strategy, ann_prefilter=True)
    rows = []
    real = tcuda.ann_topm_candidates

    def spy(queries, *args):
        rows.append(int(queries.shape[0]))
        return real(queries, *args)

    monkeypatch.setattr(tcuda, "ann_topm_candidates", spy)
    with gate.ann_gate_bypass():
        lanes = create_image_analogy_batch(a, ap, targets, p, device="cpu")
        lane_rows = list(rows)
        rows.clear()
        singles = [t_create(a, ap, b, p, device="cpu") for b in targets]
    single_rows = rows[:len(rows) // 4]  # the first singleton's calls
    # one product a step (wavefront) or scan row (batched) for all lanes:
    # the 4 lanes' queries, each lane's row padded to 8 columns (batched)
    width = (lambda r: r) if strategy == "wavefront" else (
        lambda r: tcuda.lane_row_width(r, 4))
    assert lane_rows == [4 * width(r) for r in single_rows]
    for res, ref in zip(lanes, singles):
        assert _bits(res.bp_y).tobytes() == _bits(ref.bp_y).tobytes()
        np.testing.assert_array_equal(res.source_map, ref.source_map)


def test_kernel_libraries_skip_an_ann_level():
    """A level the two-stage matcher runs builds no anchor library."""
    p = TParams(levels=2, ann_prefilter=True)
    m = tcuda.CudaMatcher(p, torch.device("cuda"))
    a, ap, b = make_pair(20, 20, seed=7)
    from image_analogies_tpu_torch.backends.base import LevelJob
    from image_analogies_tpu_torch.ops.features import spec_for_level

    job = LevelJob(level=0, spec=spec_for_level(p, 0, 2, 1), kappa_mult=1.0,
                   a_src=a, a_filt=ap, b_src=b)
    with gate.ann_gate_bypass():
        assert m.kernel_libraries(job) == ()
    exact = tcuda.CudaMatcher(p.replace(ann_prefilter=False),
                              torch.device("cuda"))
    assert exact.kernel_libraries(job) == ("argmin_l2",)


# ------------------------------------------------------- sealed bases


def test_catalog_build_seals_bases_and_a_request_hits(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(gate, "_ann_probe_verdict",
                        lambda params, device, strat: dict(_OK))
    a, ap, b = make_pair(20, 20, seed=7)
    root = str(tmp_path / "cat")
    p = TParams(levels=2, patch_size=3, coarse_patch_size=3, metrics=True,
                ann_prefilter=True, catalog_dir=root)
    rep = catalog_build.build_style(a, ap, p, root_dir=root, target=b)
    sealed = [f for f in os.listdir(os.path.join(root, catalog_ann.ANN_DIR))
              if f.endswith(".npz")]
    assert len(sealed) == rep["levels"] == 2
    assert [e["ann_dims"] for e in rep["entries"]] == [18, 32]
    (first,), c, _ = _counted(a, ap, b, p)
    assert c["ann.artifact_hits"] == 2 and c["ann.prefilter_used"] == 2
    assert "ann.projection_built" not in c

    # damage one basis: that level runs exact, quarantines, reseals
    key = rep["entries"][1]["key"]  # level 0
    path = catalog_ann.artifact_path(root, key)
    catalog_ann.damage_artifact(path, seed=3)
    (hurt,), c, _ = _counted(a, ap, b, p)
    assert os.path.exists(path + ".corrupt") and os.path.exists(path)
    assert c["ann.fallback_exact"] == 1 and c["ann.artifacts_rebuilt"] == 1
    assert c["ann.quarantined"] == 1 and c["ann.artifact_hits"] == 1
    assert [st["match_mode"] for st in
            sorted(hurt.stats, key=lambda s: s["level"])] == [
        "exact_hi", "ann_rescue"]
    # the reseal recovers the two-stage path, with the first run's bits
    (again,), c, _ = _counted(a, ap, b, p)
    assert c["ann.artifact_hits"] == 2 and "ann.fallback_exact" not in c
    assert _bits(again.bp).tobytes() == _bits(first.bp).tobytes()
    np.testing.assert_array_equal(again.source_map, first.source_map)
