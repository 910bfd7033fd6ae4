"""The port's video mode (``models/video.py``) and its temporal term against
the JAX package, on the CPU.

The tie-audit takes no temporal plane and no remap anchor, so each frame's
source map is held to the JAX run's directly: equal, except at pixels where
the two picks' full feature distances (the temporal block included) differ
by at most 2e-6 of the score magnitude, the audit's ``tol``.  The test
computes those distances with the port's features.  Under the batched
strategy the CPU port equals the JAX package bit for bit.
"""

import dataclasses
import functools

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
from image_analogies_tpu.models import video as jvideo
from image_analogies_tpu.models.video import video_analogy as j_video
from image_analogies_tpu.ops import features as jfeat
from image_analogies_tpu.ops import pallas_match as pm
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import VideoResult, video_analogy
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.models import video as tvideo
from image_analogies_tpu_torch.models.analogy import (
    _prep_planes,
    create_image_analogy as t_create,
)
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.ops.pyramid import build_pyramid_np
from image_analogies_tpu_torch.utils.state import level_db_from_numpy
from tests.conftest import make_pair
from tests.test_torch_wavefront import _level_inputs
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401

TOL = 2e-6  # the tie-audit's band (utils/parity.py)


def clip(h=24, w=22, n=3, seed=11):
    """A/A' and ``n`` seeded B frames: a gradient scene drifting right."""
    a, ap, b = make_pair(h, w, seed=seed)
    rng = np.random.default_rng(seed + 1)
    frames = [np.clip(np.roll(b, t, axis=1) + 0.03 * t
                      + 0.02 * rng.standard_normal(b.shape), 0, 1).astype(
                          np.float32) for t in range(n)]
    return a, ap, frames


def tied_mismatches(a, ap, b, prev, anchor, params, port_levels,
                    jax_levels):
    """Per level (finest first), the pixels where the two runs' source maps
    differ, each checked against the tie band: the full feature distance of
    either pick to the port run's query (static B features with the
    temporal block, the coarser level's B' and the causal window of this
    level's B'), float64.  Returns (mismatches, the widest relative gap)."""
    a_src, b_src, a_filt, _, _ = _prep_planes(a, ap, b, params,
                                              remap_anchor=anchor)
    levels = len(port_levels)
    temporal = params.temporal_weight > 0 and prev is not None
    pyr = lambda x: build_pyramid_np(x, levels)
    a_src_p, a_filt_p, b_src_p = pyr(a_src), pyr(a_filt), pyr(b_src)
    prev_p = pyr(np.asarray(prev, np.float32)) if temporal else None
    chans = 1 if a_src.ndim == 2 else a_src.shape[-1]
    n_mism, worst = 0, 0.0
    for level in range(levels):
        (bp_t, s_t), (_, s_j) = port_levels[level], jax_levels[level]
        mism = np.nonzero(np.asarray(s_t).reshape(-1)
                          != np.asarray(s_j).reshape(-1))[0]
        if not mism.size:
            continue
        n_mism += mism.size
        spec = tfeat.spec_for_level(params, level, levels, chans,
                                    temporal=temporal)
        coarse = level + 1 < levels
        db = tfeat.build_features_np(
            spec, a_src_p[level], a_filt_p[level],
            a_src_p[level + 1] if coarse else None,
            a_filt_p[level + 1] if coarse else None,
            temporal_fine=a_filt_p[level] if temporal else None)
        q = tfeat.build_features_np(
            spec, b_src_p[level], None, b_src_p[level + 1] if coarse else None,
            port_levels[level + 1][0] if coarse else None,
            temporal_fine=prev_p[level] if temporal else None)
        hb, wb = np.asarray(bp_t).shape
        flat, _, written = tfeat.fine_gather_maps(hb, wb, spec.fine_size)
        fsl = spec.fine_filt_slice
        q[:, fsl] = (np.asarray(bp_t, np.float32).reshape(-1)[flat]
                     * written * spec.sqrt_weights()[fsl])
        for px in mism:
            qq = q[px].astype(np.float64)
            dt, dj = (((db[s].astype(np.float64) - qq) ** 2).sum()
                      for s in (np.asarray(s_t).reshape(-1)[px],
                                np.asarray(s_j).reshape(-1)[px]))
            scale = (qq ** 2).sum() + max(
                (db[np.asarray(s).reshape(-1)[px]].astype(np.float64) ** 2
                 ).sum() for s in (s_t, s_j))
            gap = abs(dt - dj) / max(scale, 1e-30)
            worst = max(worst, gap)
            assert gap <= TOL, (level, int(px), dt, dj)
    return n_mism, worst


@pytest.fixture(scope="module")
def runs():
    """Both packages' video runs of one seeded clip, each scheme, computed
    once (two levels, the video preset's weights)."""
    a, ap, frames = clip()
    base = dict(levels=2, kappa=5.0, temporal_weight=1.0)
    out = {}
    for scheme in ("sequential", "two_phase"):
        jp = JParams(backend="tpu", **base)
        calls = {"jax": [], "port": []}
        out[scheme] = (
            _recorded(j_video, "jax", calls, a, ap, frames, jp, scheme),
            _recorded(video_analogy, "port", calls, a, ap, frames,
                      TParams(device="cpu", **base), scheme),
            calls)
    return a, ap, frames, out


def _recorded(video_fn, side, calls, a, ap, frames, params, scheme):
    """``video_fn`` with its package's create_image_analogy keeping every
    level, each call's (b, temporal_prev, remap_anchor, result) recorded."""
    mod = tvideo if side == "port" else jvideo
    orig = mod.create_image_analogy

    def create(a_, ap_, b, params_, *args, temporal_prev=None,
               remap_anchor=None, **kwargs):
        res = orig(a_, ap_, b, params_, *args, temporal_prev=temporal_prev,
                   remap_anchor=remap_anchor, keep_levels=True, **kwargs)
        calls[side].append((b, temporal_prev, remap_anchor, res))
        return res

    mod.create_image_analogy = create
    try:
        return video_fn(a, ap, frames, params, scheme=scheme)
    finally:
        mod.create_image_analogy = orig


@pytest.mark.parametrize("scheme", ["sequential", "two_phase"])
def test_video_matches_jax(scheme, runs):
    """Each frame of each scheme against the JAX run: the same calls (B,
    previous frame, anchor), the same number of outputs, source maps equal
    but at pixels tied within the audit's band."""
    a, ap, frames, out = runs
    jres, tres, calls = out[scheme]
    assert isinstance(tres, VideoResult) and len(tres.frames) == 3
    assert len(calls["jax"]) == len(calls["port"]) == (
        3 if scheme == "sequential" else 5)
    params = TParams(device="cpu", levels=2, kappa=5.0, temporal_weight=1.0)
    n_temporal = 0
    for (jb, jprev, janc, jr), (tb, tprev, tanc, tr) in zip(calls["jax"],
                                                           calls["port"]):
        assert np.array_equal(jb, tb) and janc is frames[0] is tanc
        assert (jprev is None) == (tprev is None)
        if tprev is not None:
            n_temporal += 1
            np.testing.assert_allclose(tprev, jprev, rtol=0, atol=1e-6)
        mism, _ = tied_mismatches(a, ap, tb, tprev, tanc, params, tr.levels,
                                  jr.levels)
        assert mism <= 0.01 * tb.size
    assert n_temporal == 2
    last = [0, 1, 2] if scheme == "sequential" else [0, 3, 4]
    for t, k in enumerate(last):
        assert np.array_equal(tres.source_maps[t],
                              calls["port"][k][3].source_map)
    for t in range(3):
        assert tres.frames[t].shape == jres.frames[t].shape
        np.testing.assert_allclose(tres.frames_y[t], jres.frames_y[t],
                                   rtol=0, atol=1e-6)
    phases = [st["phase"] for st in tres.stats]
    want = ({"seq"} if scheme == "sequential" else {"phase1", "phase2"})
    assert set(phases) == want
    assert sorted({st["frame"] for st in tres.stats}) == [0, 1, 2]
    f = tres.flicker()
    assert len(f) == 2 and all(-1.0 <= x <= 1.0 for x in f)
    np.testing.assert_allclose(f, jres.flicker(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("color", [False, True])
def test_create_with_temporal_prev_and_anchor_matches_jax(color):
    """``create_image_analogy(..., temporal_prev=..., remap_anchor=...)``
    against the JAX call with the same arguments (gray and RGB B, whose
    chroma rides into B'), two levels: source maps equal but at tied
    pixels; every level's spec carries the temporal block."""
    a, ap, frames = clip(22, 20, seed=3)
    b = frames[1]
    if color:
        b = np.stack([b, 0.8 * b, 1 - b], -1).astype(np.float32)
    prev = frames[0] * 0.9
    base = dict(levels=2, kappa=2.0, temporal_weight=1.5)
    jr = j_create(a, ap, b, JParams(backend="tpu", **base),
                  temporal_prev=prev, remap_anchor=frames[0],
                  keep_levels=True)
    params = TParams(device="cpu", **base)
    tr = t_create(a, ap, b, params, temporal_prev=prev,
                  remap_anchor=frames[0], keep_levels=True)
    tied_mismatches(a, ap, b, prev, frames[0], params, tr.levels, jr.levels)
    assert tr.bp.shape == jr.bp.shape
    np.testing.assert_allclose(tr.bp, jr.bp, rtol=0, atol=1e-5)
    # the temporal block changes the synthesis; without a previous frame
    # temporal_weight is inert
    plain = t_create(a, ap, b, params, remap_anchor=frames[0])
    off = t_create(a, ap, b, dataclasses.replace(params, temporal_weight=0),
                   remap_anchor=frames[0])
    assert np.array_equal(plain.source_map, off.source_map)
    assert not np.array_equal(plain.source_map, tr.source_map)


@pytest.mark.parametrize("scheme", ["sequential", "two_phase"])
def test_video_batched_strategy_bit_equal_to_jax(scheme):
    """The temporal term under the batched strategy: the CPU port equals
    the JAX package bit for bit, frame by frame."""
    a, ap, frames = clip(20, 18, seed=5)
    base = dict(levels=2, kappa=3.0, temporal_weight=1.0, strategy="batched")
    jres = j_video(a, ap, frames, JParams(backend="tpu", **base),
                   scheme=scheme)
    tres = video_analogy(a, ap, frames, TParams(device="cpu", **base),
                         scheme=scheme)
    for t in range(3):
        assert np.array_equal(tres.frames_y[t], jres.frames_y[t]), t
    assert {st["strategy"] for st in tres.stats} == {"batched"}


def test_video_arguments_and_device(monkeypatch):
    """An unknown scheme raises, an empty clip gives an empty result, one
    matcher serves the whole clip, and the default device is the card."""
    a, ap, frames = clip(14, 12, n=2, seed=2)
    p = TParams(device="cpu", levels=1, temporal_weight=1.0)
    with pytest.raises(ValueError, match="unknown scheme"):
        video_analogy(a, ap, frames, p, scheme="bogus")
    empty = video_analogy(a, ap, [], p)
    assert empty.frames == [] and empty.flicker() == []
    made = []
    orig = tcuda.CudaMatcher.__init__

    def counting(self, *args, **kwargs):
        made.append(self)
        orig(self, *args, **kwargs)

    monkeypatch.setattr(tcuda.CudaMatcher, "__init__", counting)
    res = video_analogy(a, ap, frames, p, scheme="two_phase")
    assert len(made) == 1 and len(res.frames) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        video_analogy(a, ap, frames, dataclasses.replace(p, device="cuda"))


def test_temporal_term_raises_frame_coherence():
    """With a strong temporal term consecutive output frames of a static
    scene are closer than without it (the JAX package's check)."""
    a, ap, _ = make_pair(16, 16, seed=11)
    r = np.random.default_rng(1)
    frames = [np.clip(a + 0.04 * r.standard_normal(a.shape), 0, 1)
              .astype(np.float32) for _ in range(2)]
    d = []
    for tw in (0.0, 8.0):
        res = video_analogy(a, ap, frames, TParams(
            device="cpu", levels=1, temporal_weight=tw), scheme="sequential")
        d.append(np.abs(res.frames_y[1] - res.frames_y[0]).mean())
    assert d[1] <= d[0] + 1e-6, d


@pytest.mark.parametrize("mode", ["exact_hi2", "exact_hi2_2p"])
def test_temporal_packed_anchor_matches_jax(mode, monkeypatch):
    """The packed anchors with the temporal block (static query lanes, live
    in every packed layout): the port's anchor on the level state the JAX
    package built with ``a_temporal`` / ``b_temporal``, against the JAX
    anchor with its packed kernel in interpret mode -- the same picks."""
    monkeypatch.setattr(jtpu, "packed2k_best", functools.partial(
        pm.packed2k_best, interpret=True))
    monkeypatch.setattr(jtpu, "packed3_best", functools.partial(
        pm.packed3_best, interpret=True))
    planes = _level_inputs(seed=6, ha=22, wa=20, hb=18, wb=16)
    rng = np.random.default_rng(7)
    planes["a_temporal"] = planes["a_filt"]
    planes["b_temporal"] = rng.uniform(0, 1, (18, 16)).astype(np.float32)
    jspec = jfeat.FeatureSpec(fine_size=5, coarse_size=3, has_coarse=True,
                              src_channels=1, temporal_weight=1.0)
    pad_mode = tcuda.PAD_MODES[mode]
    j = {k: jnp.asarray(v) for k, v in planes.items()}
    off = jfeat.window_offsets(5)
    rowsafe = jnp.asarray((off[:, 0] < 0).astype(np.float32)
                          * jfeat.causal_mask(5))
    arrs = jtpu._prepare_level_arrays(
        jspec, j["a_src"], j["a_filt"], j["a_src_coarse"], j["a_filt_coarse"],
        j["a_temporal"], j["b_src"], j["b_src_coarse"], j["b_filt_coarse"],
        j["b_temporal"], rowsafe, 256, True, pad_mode, 0, 0)
    arrs = {k: (None if v is None else np.array(v)) for k, v in arrs.items()}
    assert arrs["live_idx"].size == 80  # 25 + 12 + 9 + 9 + 25 temporal
    jparams = JParams(backend="tpu", strategy="wavefront", match_mode=mode,
                      temporal_weight=1.0)
    jjob = JLevelJob(level=0, spec=jspec, kappa_mult=4.0, **planes)
    tmpl = jtpu.make_level_template(jparams, jjob, "wavefront", mode)
    jdb = dataclasses.replace(tmpl, **{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrs.items()})
    arrs.update(diag=[np.asarray(s) for s in tmpl.diag],
                off=np.asarray(tmpl.off),
                fine_sqrtw=np.asarray(tmpl.fine_sqrtw))
    tdb = level_db_from_numpy(arrs, dict(
        ha=22, wa=20, hb=18, wb=16, fine_start=tmpl.fine_start,
        match_mode=mode), torch.device("cpu"))
    q = arrs["static_q"][rng.integers(0, 18 * 16, 29)]
    q = (q + rng.uniform(0, 0.05, q.shape)).astype(np.float32)
    q[0] = arrs["db"][33]
    jp, _ = jtpu.make_anchor_fn(jdb)(jnp.asarray(q))
    tp, _ = tcuda.make_anchor_fn(tdb)(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(tp[0]) == 33
    # and the port's own build of the same level agrees with the JAX one
    tspec = tfeat.FeatureSpec(fine_size=5, coarse_size=3, has_coarse=True,
                              src_channels=1, temporal_weight=1.0)
    tjob = tcuda.LevelJob(level=0, spec=tspec, kappa_mult=4.0, **planes)
    own = tcuda.CudaMatcher(TParams(match_mode=mode, device="cpu"),
                            torch.device("cpu")).build_features(tjob)
    assert torch.equal(own.live_idx, torch.from_numpy(arrs["live_idx"]))
    op, _ = tcuda.make_anchor_fn(own)(torch.from_numpy(q))
    assert int(op[0]) == 33
    assert (op == tp).float().mean() >= 0.9
