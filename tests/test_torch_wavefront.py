"""The port's level build, wavefront scan and synthesis loop against the JAX
package, on the CPU (where every port kernel runs its plain version and the
JAX ``backend="tpu"`` runs its exact fp32 XLA scan).

Inputs are NumPy arrays made from a seed and handed to both packages.
Elementwise level arrays are bit-equal; reductions (norms, the centering
shift) agree to rtol 1e-6 because the summation order differs; source maps
agree up to mismatches the JAX package's tie-audit explains as fp ties.
"""

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
from image_analogies_tpu.utils.parity import audit_source_map_mismatches
from image_analogies_tpu.utils.ssim import ssim
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.backends.base import LevelJob as TLevelJob
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.utils.assets import make_structured
from image_analogies_tpu_torch.utils.state import level_db_from_numpy
from tests.conftest import make_pair

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's CPU kernels on one thread while a port test runs: the suite
    runs files in parallel workers, and timing-sensitive files of the JAX
    package share the cores.  Imported by the other CPU port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


def _level_inputs(seed=2, ha=24, wa=22, hb=20, wb=18):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    return dict(a_src=u(ha, wa), a_filt=u(ha, wa),
                a_src_coarse=u((ha + 1) // 2, (wa + 1) // 2),
                a_filt_coarse=u((ha + 1) // 2, (wa + 1) // 2),
                b_src=u(hb, wb), b_src_coarse=u((hb + 1) // 2, (wb + 1) // 2),
                b_filt_coarse=u((hb + 1) // 2, (wb + 1) // 2))


def _jax_level(spec, planes, pad_mode):
    off = jfeat.window_offsets(spec.fine_size)
    rowsafe = jnp.asarray((off[:, 0] < 0).astype(np.float32)
                          * jfeat.causal_mask(spec.fine_size))
    j = {k: jnp.asarray(v) for k, v in planes.items()}
    out = jtpu._prepare_level_arrays(
        spec, j["a_src"], j["a_filt"], j["a_src_coarse"], j["a_filt_coarse"],
        None, j["b_src"], j["b_src_coarse"], j["b_filt_coarse"], None,
        rowsafe, 256, True, pad_mode, 0, 0)
    return {k: (None if v is None else np.array(v)) for k, v in out.items()}


def _torch_level(spec, planes, pad_mode):
    t = {k: torch.from_numpy(v) for k, v in planes.items()}
    return tcuda.prepare_level_arrays(
        spec, t["a_src"], t["a_filt"], t["a_src_coarse"], t["a_filt_coarse"],
        t["b_src"], t["b_src_coarse"], t["b_filt_coarse"], pad_mode=pad_mode)


@pytest.mark.parametrize("pad_mode", ["f32", "packed2"])
def test_prepare_level_arrays_matches_jax(pad_mode):
    kw = dict(fine_size=5, coarse_size=3, has_coarse=True, src_channels=1)
    planes = _level_inputs()
    want = _jax_level(jfeat.FeatureSpec(**kw), planes, pad_mode)
    got = _torch_level(tfeat.FeatureSpec(**kw), planes, pad_mode)
    for name in ("db", "static_q", "a_filt_flat"):
        assert np.array_equal(_bits(got[name].numpy()), _bits(want[name]))
    np.testing.assert_allclose(got["db_sqnorm"].numpy(), want["db_sqnorm"],
                               rtol=1e-6)
    n = want["db"].shape[0]
    if pad_mode == "f32":
        assert np.array_equal(_bits(got["db_pad"].numpy()),
                              _bits(want["db_pad"]))
        dbn = want["dbn_pad"].reshape(-1)
        assert np.isinf(dbn[n:]).all() and np.isinf(
            got["dbn_pad"][n:].numpy()).all()
        np.testing.assert_allclose(got["dbn_pad"][:n].numpy(), dbn[:n],
                                   rtol=1e-6)
        assert got["db_live"] is None and want["db_live"] is None
        return
    live = want["live_idx"]
    lw = live.size
    assert np.array_equal(got["live_idx"].numpy(), live)
    # reductions: the centering shift and the half norms
    np.testing.assert_allclose(got["feat_mean"].numpy(), want["feat_mean"],
                               rtol=1e-6, atol=1e-7)
    dbnh = want["dbnh_pad"].reshape(-1)
    np.testing.assert_allclose(got["dbnh_pad"][:n].numpy(), dbnh[:n],
                               rtol=1e-6)
    assert np.isinf(got["dbnh_pad"][n:].numpy()).all()
    # the packed lanes: the jitted JAX build recomputes its shift inside
    # fusions, so compare what the lanes encode — d1 + d2 + d3 is the
    # centered live row and the three norm lanes sum to -half_norm (or
    # -3e38 on padding rows) — to fp32 resolution
    assert got["db_pad"].shape == want["db_pad"].shape
    wk_t = got["db_pad"].float().numpy()
    wk_j = want["db_pad"].astype(np.float32)
    o2 = 2 * lw + 3
    for w in (wk_t, wk_j):
        row = w[:n, :lw] + w[:n, lw:2 * lw] + w[:n, o2 + lw:o2 + 2 * lw]
        np.testing.assert_allclose(row, want["db"][:, live]
                                   - want["feat_mean"][live], rtol=1e-5,
                                   atol=1e-6)
        nl = w[:, 2 * lw:2 * lw + 3].astype(np.float64).sum(1)
        np.testing.assert_allclose(nl[:n], -dbnh[:n], rtol=1e-6)
        assert (nl[n:] < -2.9e38).all()
    # elementwise half, bit for bit: JAX's packing run eagerly (its shift
    # and half norms are then exactly the ones it returns) against
    # pack_wk given those same reductions
    npad = want["db_pad"].shape[0]
    jspec = jfeat.FeatureSpec(**kw)
    wk_e, _, dbnh_e, shift_e, _ = jtpu._packed_weight_arrays(
        jnp.asarray(want["db"]), jspec, npad, mode2p=True)
    f = want["db"].shape[1]
    wk, dbnh_t = tcuda.pack_wk(
        torch.from_numpy(want["db"].copy()),
        torch.from_numpy(np.asarray(shift_e)[:f].copy()),
        torch.from_numpy(np.asarray(dbnh_e)[:n].copy()),
        torch.from_numpy(live).long(), npad)
    assert np.array_equal(wk.view(torch.int16).numpy(),
                          np.asarray(wk_e).view(np.int16))
    assert np.array_equal(_bits(dbnh_t.numpy()), _bits(dbnh_e))
    dl_got, dl_want = got["db_live"].numpy(), want["db_live"]
    assert np.array_equal(_bits(dl_got[:, :lw]), _bits(dl_want[:, :lw]))
    assert np.array_equal(_bits(dl_got[:, lw + 1]), _bits(dl_want[:, lw + 1]))
    np.testing.assert_allclose(dl_got[:, lw], dl_want[:, lw], rtol=1e-6)


@pytest.mark.parametrize("build", ["f32", "packed2", "packed", "rowsafe"])
def test_prepare_level_arrays_temporal_matches_jax(build):
    """The level build with the temporal block (video mode): A' at this
    level on the DB side (``a_temporal``), the previous output frame on the
    query side (``b_temporal``), for the wavefront's f32 and packed builds
    and the rows-above build of the other strategies.  The elementwise
    arrays are bit-equal to the JAX ``_prepare_level_arrays``'s; the
    temporal lanes are static query lanes, live in the packed layouts and
    gathered into ``db_live`` as the JAX arrays have them."""
    kw = dict(fine_size=5, coarse_size=3, has_coarse=True, src_channels=1,
              temporal_weight=1.5)
    planes = _level_inputs(seed=8)
    prev = np.random.default_rng(9).uniform(0, 1, planes["b_src"].shape)
    temporal = dict(a_temporal=planes["a_filt"],
                    b_temporal=prev.astype(np.float32))
    jspec = jfeat.FeatureSpec(**kw)
    off = jfeat.window_offsets(5)
    rowsafe = (off[:, 0] < 0).astype(np.float32) * jfeat.causal_mask(5)
    j = {k: jnp.asarray(v) for k, v in {**planes, **temporal}.items()}
    pad_mode = "bf16_uncentered" if build == "rowsafe" else build
    want = jtpu._prepare_level_arrays(
        jspec, j["a_src"], j["a_filt"], j["a_src_coarse"], j["a_filt_coarse"],
        j["a_temporal"], j["b_src"], j["b_src_coarse"], j["b_filt_coarse"],
        j["b_temporal"], jnp.asarray(rowsafe), 256, build != "rowsafe",
        "f32" if build == "rowsafe" else build, 0, 0)
    want = {k: (None if v is None else np.array(v)) for k, v in want.items()}
    t = {k: torch.from_numpy(v) for k, v in {**planes, **temporal}.items()}
    got = tcuda.prepare_level_arrays(
        tfeat.FeatureSpec(**kw), t["a_src"], t["a_filt"], t["a_src_coarse"],
        t["a_filt_coarse"], t["b_src"], t["b_src_coarse"], t["b_filt_coarse"],
        pad_mode=pad_mode,
        rowsafe=torch.from_numpy(rowsafe) if build == "rowsafe" else None,
        a_temporal=t["a_temporal"], b_temporal=t["b_temporal"])
    tsl = tfeat.FeatureSpec(**kw).slices()[4]
    assert tsl.stop == want["db"].shape[1] == 93 and tsl.stop - tsl.start == 25
    for name in ("db", "static_q", "a_filt_flat", "db_rowsafe"):
        assert np.array_equal(_bits(got[name].numpy()), _bits(want[name]))
    # the temporal block is A' on the DB side, the previous frame on the
    # query side, scaled by sqrt(temporal_weight * window weight)
    sw = tfeat.FeatureSpec(**kw).sqrt_weights()[tsl]
    assert np.array_equal(
        got["static_q"][:, tsl].numpy(),
        tfeat.extract_patches_np(temporal["b_temporal"], 5) * sw[None, :])
    assert np.array_equal(
        got["db"][:, tsl].numpy(),
        tfeat.extract_patches_np(planes["a_filt"], 5) * sw[None, :])
    n = want["db"].shape[0]
    if build == "rowsafe":
        assert not np.array_equal(want["db_rowsafe"], want["db"])
        assert np.array_equal(got["db_rowsafe"][:, tsl].numpy(),
                              want["db"][:, tsl])
        assert torch.equal(got["db_pad"][:n, :93],
                           got["db_rowsafe"].to(torch.bfloat16))
        return
    if build == "f32":
        assert np.array_equal(_bits(got["db_pad"].numpy()),
                              _bits(want["db_pad"]))
        return
    live = want["live_idx"]
    assert np.array_equal(got["live_idx"].numpy(), live)
    assert np.array_equal(live[-25:], np.arange(tsl.start, tsl.stop))
    assert got["db_pad"].shape == want["db_pad"].shape
    lw = live.size
    dl_got, dl_want = got["db_live"].numpy(), want["db_live"]
    assert np.array_equal(_bits(dl_got[:, :lw]), _bits(dl_want[:, :lw]))
    np.testing.assert_allclose(dl_got[:, lw], dl_want[:, lw], rtol=1e-6)
    np.testing.assert_allclose(got["feat_mean"].numpy(), want["feat_mean"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("h,w,c", [(20, 18, 3), (64, 64, 3), (31, 50, 4),
                                   (7, 5, 2)])
def test_diag_schedule_is_the_jax_schedule(h, w, c):
    got, want = tcuda._diag_schedule_np(h, w, c), jtpu._diag_schedule_np(
        h, w, c)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert np.array_equal(g, x)


def _audit(a, ap, b, base, port, ref):
    return audit_source_map_mismatches(a, ap, b, JParams(**base),
                                       port.levels, ref.levels)


def _run_both(a, ap, b, base, match_mode="auto"):
    ref = j_create(a, ap, b, JParams(backend="tpu", strategy="wavefront",
                                     **base), keep_levels=True)
    port = t_create(a, ap, b, TParams(match_mode=match_mode, **base),
                    device="cpu", keep_levels=True)
    return port, ref


@pytest.mark.parametrize("case", [
    "kappa5_two_levels", "kappa0_pure_approx", "kappa1_structured",
    "patch7", "a_b_sizes_differ"])
def test_port_matches_jax_end_to_end(case):
    if case == "kappa5_two_levels":
        (a, ap, b), base = make_pair(26, 24, seed=3), dict(levels=2,
                                                             kappa=5.0)
    elif case == "kappa0_pure_approx":
        (a, ap, b), base = make_pair(22, 22, seed=9), dict(levels=1,
                                                             kappa=0.0)
    elif case == "kappa1_structured":
        (a, ap, b), base = make_structured(32, 7), dict(levels=3, kappa=1.0)
    elif case == "patch7":
        (a, ap, b), base = make_pair(24, 24, seed=5), dict(
            levels=2, kappa=0.5, patch_size=7)
    else:
        rng = np.random.default_rng(13)
        a = rng.uniform(0, 1, (28, 26)).astype(np.float32)
        ap = (np.round(a * 5) / 5).astype(np.float32)
        b = rng.uniform(0, 1, (20, 24)).astype(np.float32)
        base = dict(levels=2, kappa=3.0)
    port, ref = _run_both(a, ap, b, base)
    assert port.bp_y.shape == ref.bp_y.shape == b.shape[:2]
    assert port.source_map.dtype == np.int32
    audit = _audit(a, ap, b, base, port, ref)
    assert audit["unexplained"] == 0, audit
    assert audit["first_divergence_is_tie"] in (True, None), audit
    assert ssim(port.bp_y, ref.bp_y) >= 0.999
    assert [st["level"] for st in port.stats] == list(
        range(len(port.levels) - 1, -1, -1))
    for st in port.stats:
        assert 0.0 <= st["coherence_ratio"] <= 1.0
        assert st["match_mode"] == "exact_hi"


def test_forced_packed_scan_matches_jax_exact_scan():
    """exact_hi2_2p on the port (the packed product set drops ~2^-16
    terms) against the JAX package's exact fp32 scan: not bit-equal, but
    the first divergence is a tie and the rest is explained."""
    a, ap, b = make_structured(64, 7)
    base = dict(levels=3, kappa=5.0)
    port, ref = _run_both(a, ap, b, base, match_mode="exact_hi2_2p")
    assert {st["match_mode"] for st in port.stats} == {"exact_hi2_2p"}
    audit = _audit(a, ap, b, base, port, ref)
    assert audit["first_divergence_is_tie"] in (True, None), audit
    assert audit["unexplained"] / max(audit["mismatches"], 1) <= 1e-4
    assert ssim(port.bp_y, ref.bp_y) >= 0.99


@pytest.mark.parametrize("mode", sorted(tcuda.PAD_MODES))
def test_state_from_jax_build_gives_the_same_scan(mode, monkeypatch):
    """`level_db_from_numpy` on the JAX package's level arrays: the port's
    scan over that state equals its scan over its own build, in every
    anchor mode."""
    monkeypatch.setenv("IA_EXPERIMENTAL", "1")
    p = 5
    planes = _level_inputs(seed=4, ha=26, wa=24, hb=22, wb=20)
    kw = dict(fine_size=p, coarse_size=3, has_coarse=True, src_channels=1)
    jspec, tspec = jfeat.FeatureSpec(**kw), tfeat.FeatureSpec(**kw)
    pad_mode = tcuda.PAD_MODES[mode]
    arrs = _jax_level(jspec, planes, pad_mode)
    jparams = JParams(backend="tpu", strategy="wavefront", match_mode=mode)
    jjob = JLevelJob(level=0, spec=jspec, kappa_mult=4.0, **planes)
    tmpl = jtpu.make_level_template(jparams, jjob, "wavefront", mode)
    arrs.update(diag=[np.asarray(s) for s in tmpl.diag],
                off=np.asarray(tmpl.off),
                fine_sqrtw=np.asarray(tmpl.fine_sqrtw))
    ha, wa = planes["a_src"].shape
    hb, wb = planes["b_src"].shape
    meta = dict(ha=ha, wa=wa, hb=hb, wb=wb, fine_start=tmpl.fine_start,
                match_mode=mode,
                scan_tile=tcuda.scan_tile_rows(arrs["db_pad"].shape[0]))
    from_jax = level_db_from_numpy(arrs, meta, CPU)

    tparams = TParams(match_mode=mode, device="cpu")
    tjob = TLevelJob(level=0, spec=tspec, kappa_mult=4.0, **planes)
    own = tcuda.CudaMatcher(tparams, CPU).build_features(tjob)
    assert own.match_mode == mode and from_jax.db_pad.dtype == own.db_pad.dtype
    outs = []
    for ldb in (from_jax, own):
        outs.append(tcuda.wavefront_scan_core(
            ldb, 4.0, tcuda.make_anchor_fn(ldb)))
    (bp_j, s_j, n_j), (bp_o, s_o, n_o) = outs
    assert torch.equal(s_j, s_o)
    torch.testing.assert_close(bp_j, bp_o, rtol=0, atol=0)
    assert int(n_j) == int(n_o)
