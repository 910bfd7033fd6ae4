"""The port's exact, rowwise and batched strategies against the JAX package,
on the CPU.

Inputs are NumPy arrays made from a seed and handed to both packages.  The
JAX kernel runs in interpret mode.  On the CPU both packages score the
approximate match in exact fp32 (the JAX package off a TPU, the port
without a card), so whole syntheses agree to the bit; the bf16 form the
card runs (``argmin_l2_bf16``) is held against the JAX kernel fed bf16
operands, alone and inside ``batched_scan_core``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu.backends import tpu as jtpu
from image_analogies_tpu.backends.base import LevelJob as JLevelJob
from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import (
    create_image_analogy as j_create,
)
from image_analogies_tpu.ops import features as jfeat
from image_analogies_tpu.ops import pallas_match as pm
from image_analogies_tpu.utils.ssim import ssim
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.backends.base import LevelJob as TLevelJob
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.ops import match
from image_analogies_tpu_torch.utils.state import level_db_from_numpy
from tests.conftest import make_pair
from tests.test_torch_wavefront import (  # noqa: F401
    _bits, _level_inputs, one_torch_thread)

CPU = torch.device("cpu")
KW = dict(fine_size=5, coarse_size=3, has_coarse=True, src_channels=1)
# |score - plain| of the bf16 form against the JAX kernel: both sum exact
# bf16 products in fp32, in different orders (scores are O(10))
SCORE_ATOL = 2e-5
# picks may differ only where the reference's best two scores are closer
SCORE_BAND = 4e-5


# ------------------------------------------------------------ level build


@pytest.mark.parametrize("h,w,p", [(7, 9, 5), (4, 5, 3), (16, 16, 7)])
def test_gather_maps_match_jax(h, w, p):
    got = tcuda.gather_maps_device(h, w, p, CPU)
    want = jtpu._gather_maps_device(h, w, p)
    assert got[0].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, x in zip(got[1:], want[1:]):
        assert np.array_equal(_bits(g.numpy()), _bits(x))


def _jax_rowsafe_level(planes, pad_tile=256):
    """The JAX batched level: ``_prepare_level_arrays`` with
    ``pad_full=False`` and the template's rowsafe mask (fp32 pre-pad when
    ``pad_tile``), plus the template."""
    jspec = jfeat.FeatureSpec(**KW)
    jjob = JLevelJob(level=0, spec=jspec, kappa_mult=4.0, **planes)
    tmpl = jtpu.make_level_template(JParams(backend="tpu",
                                            strategy="batched"),
                                    jjob, "batched")
    j = {k: jnp.asarray(v) for k, v in planes.items()}
    out = jtpu._prepare_level_arrays(
        jspec, j["a_src"], j["a_filt"], j["a_src_coarse"], j["a_filt_coarse"],
        None, j["b_src"], j["b_src_coarse"], j["b_filt_coarse"], None,
        tmpl.rowsafe, pad_tile, False, "f32", 0, 0)
    return {k: (None if v is None else np.array(v))
            for k, v in out.items()}, tmpl


def test_prepare_level_arrays_rowsafe_matches_jax():
    planes = _level_inputs(seed=5)
    want, tmpl = _jax_rowsafe_level(planes)
    rowsafe = tcuda.rowsafe_mask(5)
    assert np.array_equal(_bits(rowsafe), _bits(tmpl.rowsafe))
    t = {k: torch.from_numpy(v) for k, v in planes.items()}
    got = tcuda.prepare_level_arrays(
        tfeat.FeatureSpec(**KW), t["a_src"], t["a_filt"], t["a_src_coarse"],
        t["a_filt_coarse"], t["b_src"], t["b_src_coarse"],
        t["b_filt_coarse"], pad_mode="bf16_uncentered",
        rowsafe=torch.from_numpy(rowsafe))
    for name in ("db", "db_rowsafe", "static_q", "a_filt_flat"):
        assert np.array_equal(_bits(got[name].numpy()), _bits(want[name]))
    n = want["db"].shape[0]
    assert not np.array_equal(want["db_rowsafe"], want["db"])
    for name in ("db_sqnorm", "db_rowsafe_sqnorm"):  # reductions
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6)
    dbn = want["dbn_pad"].reshape(-1)
    np.testing.assert_allclose(got["dbn_pad"][:n].numpy(), dbn[:n],
                               rtol=1e-6)
    assert torch.isinf(got["dbn_pad"][n:]).all() and np.isinf(dbn[n:]).all()
    # the bf16 scan copy is the JAX fp32 pre-pad of the rows-above DB,
    # rounded (as JAX .astype): bit for bit, padding rows and lanes zero
    assert got["db_pad"].dtype == torch.bfloat16
    assert got["db_pad"].shape == want["db_pad"].shape == (768, 128)
    rounded = torch.from_numpy(want["db_pad"]).to(torch.bfloat16)
    assert torch.equal(got["db_pad"].view(torch.int16),
                       rounded.view(torch.int16))
    assert got["feat_mean"] is None and got["db_live"] is None


# ------------------------------------------------------------ the kernel


def _bf16_case(m, n, npad, f=68, fp=128, seed=0):
    """Seeded bf16-form operands: rows with a duplicate pair (rows 3 and
    n-5), +inf-norm padding rows, and queries, one equal to row 3."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(0, 1, (n, f)).astype(np.float32)
    if n > 8:
        db[n - 5] = db[3]
    q = rng.uniform(0, 1, (m, f)).astype(np.float32)
    q[0] = db[min(3, n - 1)]
    qp = np.zeros((m, fp), np.float32)
    qp[:, :f] = q
    dbp = np.zeros((npad, fp), np.float32)
    dbp[:n, :f] = db
    dbn = np.full((npad,), np.inf, np.float32)
    dbn[:n] = (db.astype(np.float64) ** 2).sum(1)
    return qp, dbp, dbn


@pytest.mark.parametrize("m,n,npad,tile", [(37, 900, 1024, 512),
                                           (130, 3000, 3072, 1024),
                                           (5, 1, 256, 256)])
def test_argmin_l2_bf16_plain_matches_pallas_kernel(m, n, npad, tile):
    """``argmin_l2_bf16_plain`` against ``_argmin_kernel`` fed bf16
    operands (``pallas_argmin_l2_prepadded``, interpret mode): the rounded
    operands are the same bits, scores agree to SCORE_ATOL, picks are equal
    except where the reference's best two scores lie within SCORE_BAND,
    duplicate rows go to the lowest index and padding rows never win."""
    qp, dbp, dbn = _bf16_case(m, n, npad)
    q_t = torch.from_numpy(qp).to(torch.bfloat16)
    db_t = torch.from_numpy(dbp).to(torch.bfloat16)
    q_j = jnp.asarray(qp).astype(jnp.bfloat16)
    db_j = jnp.asarray(dbp).astype(jnp.bfloat16)
    assert np.array_equal(q_t.view(torch.int16).numpy(),
                          np.asarray(q_j).view(np.int16))
    assert np.array_equal(db_t.view(torch.int16).numpy(),
                          np.asarray(db_j).view(np.int16))
    mp = (m + 15) // 16 * 16  # the TPU's bf16 row tile
    q_pad = jnp.zeros((mp, 128), jnp.bfloat16).at[:m].set(q_j)
    j_idx, j_val = pm.pallas_argmin_l2_prepadded(
        q_pad, db_j, jnp.asarray(dbn)[None, :], tile_n=tile, interpret=True)
    j_idx, j_val = np.asarray(j_idx)[:m], np.asarray(j_val)[:m]
    idx, val = match.argmin_l2_bf16(torch.from_numpy(qp), db_t,
                                    torch.from_numpy(dbn), 80)
    assert idx.dtype == torch.int32 and match.LAUNCHES["argmin_l2_bf16"] == 0
    np.testing.assert_allclose(val.numpy(), j_val, rtol=0, atol=SCORE_ATOL)
    scores = dbn[None, :] - 2.0 * (q_t.float() @ db_t.float().T).numpy()
    second = np.sort(scores, axis=1)[:, 1] if n > 1 else np.full(m, np.inf)
    differ = idx.numpy() != j_idx
    assert not (differ & (np.abs(second - j_val) > SCORE_BAND)).any()
    assert int(idx.max()) < n and int(j_idx.max()) < n
    assert int(idx[0]) == int(j_idx[0]) == min(3, n - 1)


def test_prepadded_argmin_queries_adds_the_query_norm():
    qp, dbp, dbn = _bf16_case(9, 300, 512, seed=3)
    queries = torch.from_numpy(qp[:, :68].copy())
    db_t = torch.from_numpy(dbp).to(torch.bfloat16)
    idx, d = match.prepadded_argmin_queries(queries, db_t,
                                            torch.from_numpy(dbn))
    i2, score = match.argmin_l2_bf16_plain(queries, db_t[:, :68],
                                           torch.from_numpy(dbn))
    assert torch.equal(idx, i2) and int(idx[0]) == 3
    want = torch.clamp(score + (queries * queries).sum(1), min=0.0)
    assert torch.equal(d, want) and (d >= 0).all()


# ------------------------------------------------- modules on one state


def _both_states(seed=4, ha=26, wa=24, hb=22, wb=20, pad_tile=0):
    """One batched level from the JAX build: the JAX ``TpuLevelDB`` and the
    port's ``LevelDB`` carried over by ``level_db_from_numpy``."""
    planes = _level_inputs(seed=seed, ha=ha, wa=wa, hb=hb, wb=wb)
    arrs, tmpl = _jax_rowsafe_level(planes, pad_tile)
    jdb = dataclasses.replace(tmpl, **{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrs.items()})
    arrs.update({k: np.asarray(getattr(tmpl, k)) for k in (
        "flat_idx", "valid", "written", "rowsafe", "off", "fine_sqrtw")})
    meta = dict(ha=ha, wa=wa, hb=hb, wb=wb, fine_start=tmpl.fine_start,
                match_mode="exact_hi", strategy="batched",
                n_rowsafe=tmpl.n_rowsafe, refine_passes=tmpl.refine_passes)
    return jdb, level_db_from_numpy(arrs, meta, CPU), planes


def _mid_scan(na, nb, seed=8):
    rng = np.random.default_rng(seed)
    bp = rng.uniform(0, 1, nb).astype(np.float32)
    s = rng.integers(0, na, nb).astype(np.int32)
    return bp, s


def test_row_queries_and_rows_above_coherence_match_jax():
    jdb, tdb, _ = _both_states()
    bp, s = _mid_scan(26 * 24, 22 * 20)
    nrs = jdb.n_rowsafe
    assert tdb.n_rowsafe == nrs == 10
    for r in (0, 1, 7, 21):
        jq = np.asarray(jtpu._row_queries(jdb, r, jnp.asarray(bp),
                                          jdb.rowsafe))
        tq = tcuda._row_queries(tdb, r, torch.from_numpy(bp), tdb.rowsafe)
        assert np.array_equal(_bits(tq.numpy()), _bits(jq))
        rows = slice(r * 20, (r + 1) * 20)
        jp, jd, jh = jtpu._batched_coherence(
            jdb, jnp.asarray(s), jnp.asarray(jq),
            jdb.flat_idx[rows, :nrs], jdb.valid[rows, :nrs] > 0, nrs,
            lambda i: jdb.db_rowsafe[i])
        s_t = torch.from_numpy(s.astype(np.int64))
        tp, td, th = tcuda._batched_coherence(
            tdb, tq, s_t[tdb.flat_idx[rows, :nrs]],
            tdb.valid[rows, :nrs] > 0, row_fn=lambda i: tdb.db_rowsafe[i])
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert (th.numpy() == (r > 0)).all()  # row 0 has no row above
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


@pytest.mark.parametrize("kappa", [0.0, 4.0])
def test_left_refine_matches_jax(kappa):
    jdb, tdb, _ = _both_states()
    bp, s = _mid_scan(26 * 24, 22 * 20, seed=9)
    rng = np.random.default_rng(2)
    q = np.asarray(jtpu._row_queries(jdb, 5, jnp.asarray(bp), jdb.rowsafe))
    # a row of picks with runs, so shifted candidates exist
    p = np.repeat(rng.integers(0, 26 * 24 - 30, 5), 4).astype(np.int32)
    d_app = rng.uniform(0.5, 3.0, 20).astype(np.float32)
    d_pick = np.where(rng.uniform(size=20) < 0.5, np.inf,
                      rng.uniform(0, 2, 20)).astype(np.float32)
    jp, jd = jtpu._left_refine(jdb, jnp.asarray(q), jnp.asarray(p),
                               jnp.asarray(d_pick), jnp.asarray(d_app),
                               jnp.float32(kappa),
                               lambda i: jdb.db_rowsafe[i])
    tp, td = tcuda._left_refine(
        tdb, torch.from_numpy(q.copy()), torch.from_numpy(p.astype(np.int64)),
        torch.from_numpy(d_pick), torch.from_numpy(d_app),
        torch.tensor(kappa, dtype=torch.float32),
        lambda i: tdb.db_rowsafe[i])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert (tp.numpy() != p).any() == (kappa > 0)


@pytest.mark.parametrize("kappa", [0.5, 4.0])
def test_batched_core_with_the_bf16_form_matches_jax(kappa):
    """``batched_scan_core`` with the bf16 approximate match on both sides:
    the port's plain version against ``pallas_argmin_l2(bf16=True)`` in
    interpret mode, on the JAX package's level state — equal B', source
    map and counts.  The port's scan on its own level build gives the same
    result (the state carries over whole)."""
    jdb, tdb, planes = _both_states(seed=6)
    approx_j = lambda q: pm.pallas_argmin_l2(
        q, jdb.db_rowsafe, jdb.db_rowsafe_sqnorm, bf16=True, interpret=True)
    jbp, js, jc = jtpu.batched_scan_core(jdb, jnp.float32(kappa), approx_j)
    runs = []
    own = tcuda.CudaMatcher(TParams(strategy="batched"), CPU,
                            bf16_approx=True).build_features(TLevelJob(
                                level=0, spec=tfeat.FeatureSpec(**KW),
                                kappa_mult=kappa, **planes))
    assert own.db_pad.dtype == torch.bfloat16
    for ldb in (tdb, own):
        dbp, dbn = tcuda.pad_bf16_uncentered(ldb.db_rowsafe,
                                             ldb.db_rowsafe_sqnorm)
        runs.append(tcuda.batched_scan_core(
            ldb, kappa,
            lambda q: match.prepadded_argmin_queries(q, dbp, dbn)))
    runs.append(tcuda.batched_scan_core(own, kappa,
                                        tcuda.make_approx_fn(own)))
    for bp, s, counts in runs:
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert np.array_equal(_bits(bp.numpy()), _bits(jbp))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    # kappa 4 exercises coherence and the refinement, 0.5 the bf16 picks
    assert (int(jc[0]) > 0 and int(jc[1]) > 0) or kappa < 1


# ------------------------------------------------------- whole syntheses


def _inputs(kind, h=28, w=24, seed=3):
    if kind == "gray":
        return make_pair(h, w, seed=seed), {}
    a, ap, b = make_pair(h, w, seed=seed, channels=3)
    return (a, ap, b), ({} if kind == "rgb" else
                        dict(color_mode="source_rgb"))


@pytest.mark.parametrize("strategy,kind", [
    ("batched", "gray"), ("batched", "rgb"), ("batched", "source_rgb"),
    ("rowwise", "gray"), ("rowwise", "source_rgb"),
    ("exact", "gray"), ("exact", "source_rgb")])
def test_strategy_synthesis_matches_jax(strategy, kind):
    """``create_image_analogy`` on the port's CPU against the JAX package's
    (its approximate match off the TPU is exact fp32, as the port's):
    equal source maps at every level, B' within 1e-5, equal coherence (and
    batched refinement) ratios."""
    (a, ap, b), kw = _inputs(kind)
    base = dict(levels=2, kappa=3.0, strategy=strategy, **kw)
    ref = j_create(a, ap, b, JParams(backend="tpu", **base),
                   keep_levels=True)
    port = t_create(a, ap, b, TParams(**base), device="cpu",
                    keep_levels=True)
    assert port.bp.shape == ref.bp.shape
    for (bp_t, s_t), (bp_j, s_j) in zip(port.levels, ref.levels):
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_allclose(bp_t, bp_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.bp, ref.bp, rtol=0, atol=1e-5)
    for st_t, st_j in zip(port.stats, ref.stats):
        assert st_t["strategy"] == st_j["strategy"] == strategy
        assert st_t["coherence_ratio"] == st_j["coherence_ratio"]
        assert st_t.get("refined_ratio") == st_j.get("refined_ratio")
        assert ("refined_ratio" in st_t) == (strategy == "batched")


@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_best_match_matches_jax(strategy):
    a, ap, b = make_pair(10, 11, seed=5)
    spec_kw = dict(level=0, kappa_mult=JParams(levels=1).kappa_factor(0) ** 2,
                   a_src=a, a_filt=ap, b_src=b)
    jm = jtpu.TpuMatcher(JParams(levels=1, backend="tpu", strategy=strategy))
    jjob = JLevelJob(spec=jfeat.spec_for_level(JParams(levels=1), 0, 1, 1),
                     **spec_kw)
    tm = tcuda.CudaMatcher(TParams(levels=1, strategy=strategy), CPU)
    tjob = TLevelJob(spec=tfeat.spec_for_level(TParams(levels=1), 0, 1, 1),
                     **spec_kw)
    jdb, tdb = jm.build_features(jjob), tm.build_features(tjob)
    n = b.size
    bp = np.zeros(n, np.float32)
    s = np.zeros(n, np.int32)
    bp[:40] = ap.reshape(-1)[:40]
    s[:40] = np.arange(40)
    coh = []
    for q in (0, 1, 17, 39, 40, 41, 87, 109):
        pj, dj, cj = jm.best_match(jdb, jjob, q, bp, s)
        pt, dt, ct = tm.best_match(tdb, tjob, q, bp, s)
        assert (pt, ct) == (pj, cj), q
        assert dt == pytest.approx(dj, rel=1e-5, abs=1e-6), q
        coh.append(ct)
    assert any(coh) and not all(coh)


def test_matcher_has_no_fp32_approximate_match_on_the_card():
    """The card's approximate match is the bf16 kernel: asking a card
    matcher for the fp32 form raises (no card needed to refuse)."""
    with pytest.raises(ValueError, match="CPU only"):
        tcuda.CudaMatcher(TParams(strategy="batched"), "cuda",
                          bf16_approx=False)
    assert tcuda.CudaMatcher(TParams(), "cuda").bf16_approx
    assert not tcuda.CudaMatcher(TParams(), CPU).bf16_approx


# --------------------------- the JAX package's quality invariants, ported


@pytest.mark.parametrize("strategy", ["rowwise", "batched"])
@pytest.mark.parametrize("bf16", [False, True])
def test_fast_strategies_self_analogy_quality(strategy, bf16):
    """tests/test_backend_equivalence.py's invariant on the port, in the
    CPU's fp32 form and in the card's bf16 form: with B == A the output
    tracks A' and the source map is mostly the identity."""
    a, ap, _ = make_pair(24, 24, seed=4)
    p = TParams(levels=2, kappa=2.0, strategy=strategy)
    r = t_create(a, ap, a.copy(), p,
                 backend=tcuda.CudaMatcher(p, CPU, bf16_approx=bf16))
    sv = ssim(r.bp_y, np.asarray(ap), data_range=1.0)
    ident = (r.source_map.reshape(-1) == np.arange(a.size)).mean()
    assert sv >= 0.9, f"self-analogy SSIM {sv}"
    assert ident >= 0.8, f"identity source-map fraction {ident}"


def test_batched_quality_not_worse_than_oracle():
    a, ap, b = make_pair(24, 24, seed=2)
    ideal = np.round(np.asarray(b) * 5) / 5.0
    r_cpu = j_create(a, ap, b, JParams(levels=2, kappa=3.0, backend="cpu"))
    r_bat = t_create(a, ap, b, TParams(levels=2, kappa=3.0,
                                       strategy="batched"), device="cpu")
    mae_cpu = np.abs(r_cpu.bp_y - ideal).mean()
    mae_bat = np.abs(r_bat.bp_y - ideal).mean()
    assert mae_bat <= mae_cpu * 1.25, (mae_bat, mae_cpu)
