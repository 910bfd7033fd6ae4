"""``chip_smoke.py``'s video side on the CPU: each clip held call by call
to its ``exact_hi`` run, at 32^2.

The side runs four clips with the video preset (``video_cases``):
luminance two_phase and sequential, RGB sources with
``color_mode="source_rgb"`` two_phase, and the same with
``match_mode="exact_hi2"``.  Each ``create_image_analogy`` call a clip
makes is recorded and run once more with ``match_mode="exact_hi"`` on its
recorded inputs, previous frame and anchor, then held by ``parity_hold``,
whose tie-audit carries the temporal block (``utils/parity.py``'s
``temporal_prev`` and ``remap_anchor``).  Here the same functions run with
``device="cpu"`` (every kernel's plain version), the crossover lowered so
that level 0 (32^2 = 1,024 A rows) takes the packed scan and levels 1-2
the fp32 argmin, and each scan wrapper counts a launch by the width rule
the card would take (``cpu_parity``).  The audit is also held to the JAX
package's video runs (``tests/test_torch_video.py``), to hand-made picks
that tie in every block but the temporal one and, with no clip arguments,
to the JAX package's audit.  The limits the luminance clips report
(``PARITY_REPORTED``) rest on the JAX package's own packed scan against
its fp32 scan: at the 512^2 clip's first pixel, and on whole clip calls;
their unexplained mismatches and first divergence are then held to the
packed scan's own scores (the audit's packed replay), on the clip's first
call cropped to its corner.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import video_analogy
from image_analogies_tpu_torch.backends import cuda as bcuda
from image_analogies_tpu_torch.models import video as tvideo
from image_analogies_tpu_torch.models.analogy import _prep_planes
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.utils.parity import _packed2k_band
from image_analogies_tpu_torch.utils.parity import (
    audit_source_map_mismatches as t_audit,
)
from tests.test_torch_app_parity import (  # noqa: F401
    CROSSOVER,
    SIZE,
    _moved_off_a_tie,
    cpu_parity,
    jax_tpu_kernels,
)
from tests.test_torch_video import clip, runs, tied_mismatches  # noqa: F401
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401


def _clip(label):
    """The side's clip ``label`` at 32^2 on the CPU: (a, ap, frames,
    params, scheme)."""
    for name, *case in chip_smoke.video_cases(SIZE, device="cpu"):
        if name == label:
            return case
    raise KeyError(label)


# clip: (level 0's (kernel, lanes the scan takes: packed2k 4L+3, packed3
# 2L, each rounded up to 16) without and with the temporal block, the
# levels that ran exact_hi in both runs of a call)
PAIRS = {
    "video_two_phase": ((("packed_best", 224), ("packed_best", 336)),
                        [1, 2]),
    "video_sequential": ((("packed_best", 224), ("packed_best", 336)),
                         [1, 2]),
    "video_rgb": ((("packed_best", 496), ("packed2kw_best", 608)), [1, 2]),
    "video_rgb_exact_hi2": ((("packed3_best", 256), ("packed3w_best", 304)),
                            []),
}


@pytest.mark.parametrize("label", list(PAIRS))
def test_video_pair_holds_on_the_cpu(cpu_parity, label):
    """Each clip of the side at 32^2: one record a call with its frame and
    phase, level 0 on the route the card would take at its width (with the
    temporal block where it rode: phase 2, every sequential frame but the
    first), the lower levels bit-equal to the exact_hi run's and the audit
    explaining every mismatch; the RGB clips launch their wide kernel."""
    (plain, block), equal = PAIRS[label]
    launches, recs = chip_smoke.video_pair(label, *_clip(label))
    frames, scheme = _clip(label)[2], _clip(label)[4]
    n = len(frames)
    assert n == (chip_smoke.VIDEO_RGB_FRAMES if "rgb" in label else 3)
    if scheme == "sequential":
        want = [("seq", t) for t in range(n)]
    else:
        want = ([("phase1", t) for t in range(n)]
                + [("phase2", t) for t in range(1, n)])
    assert [(r["phase"], r["frame"]) for r in recs] == want
    for rec in recs:
        assert rec["pair"] == label
        assert tuple(rec["routes"][0]) == (block if rec["temporal"]
                                           else plain), rec["routes"]
        assert rec["temporal"] == (rec["phase"] == "phase2"
                                   or (rec["phase"] == "seq"
                                       and rec["frame"] > 0))
        assert rec["bit_equal_levels"] == equal
        assert set(rec["exact_hi_launches"]) == {"argmin_l2"}
        assert rec["unexplained"] == 0, rec
        assert rec["first_divergence_is_tie"] in (True, None), rec
        assert rec["ssim"] >= chip_smoke.SSIM_MIN
        assert rec["failures"] == []
    assert sum(r["temporal"] for r in recs) == n - 1
    assert block[0] in launches and plain[0] in launches
    chip_smoke.parity_verdict(recs)


def test_rgb_clip_launches_held_to_its_source_channels(cpu_parity):
    """An RGB ``source_rgb`` clip's launch check takes the clip's three
    source channels: its launches are ``want_video_launches`` at 3
    channels (packed2k at 496 lanes, packed2kw at 608 with the temporal
    block), which the luminance route (224 and 336 lanes) would not
    give."""
    a, ap, frames, params, scheme = _clip("video_rgb")
    chans = chip_smoke.source_channels(a, ap, frames[0], params)
    assert chans == 3
    shape = frames[0].shape[:2]
    res, launches, _ = chip_smoke.run_app(
        "video", "rgb", lambda: video_analogy(a, ap, frames, params,
                                              scheme=scheme),
        lambda r: chip_smoke.want_video_launches(params, shape, r.stats,
                                                 chans))
    assert set(launches) == {"packed_best", "packed2kw_best", "argmin_l2"}
    luminance = chip_smoke.want_video_launches(params, shape, res.stats, 1)
    assert "packed2kw_best" not in luminance
    assert luminance != launches


def test_tampered_phase2_pick_fails_the_verdict(cpu_parity, capsys):
    """A phase-2 call of the RGB clip (packed2kw with the temporal block;
    its pair holds every limit) whose pick at level 0's first pixel (no
    causal context: its decision rests on the static queries and the
    temporal block, equal in both runs) is moved off the exact_hi run's:
    the audit with the clip's previous frame and anchor finds it
    unexplained and ``parity_verdict`` fails, while the untampered call
    holds."""
    from image_analogies_tpu_torch import create_image_analogy

    a, ap, frames, params, scheme = _clip("video_rgb")
    calls = []
    with chip_smoke.recording_calls(calls, tvideo):
        video_analogy(a, ap, frames, params, scheme=scheme)
    ca, cap, cb, cp, cres, claunches, cwall, prev, anchor = calls[-1]
    assert prev is not None and cres.stats[0]["phase"] == "phase2"
    ep = cp.replace(match_mode="exact_hi")
    eres = create_image_analogy(ca, cap, cb, ep, temporal_prev=prev,
                                remap_anchor=anchor, keep_levels=True)
    pre = (ca, cap, cb, cp, cres, claunches, cwall)
    exact = (ca, cap, cb, ep, eres, {}, 0.0)
    kw = dict(temporal_prev=prev, remap_anchor=anchor, frame=2,
              phase="phase2")
    held = chip_smoke.parity_hold("video_rgb", pre, exact, **kw)
    bad = chip_smoke.parity_hold("video_rgb", _moved_off_a_tie(pre, exact),
                                 exact, **kw)
    assert held["failures"] == [] and held["reported"] == []
    assert bad["unexplained"] >= 1
    assert any("unexplained" in f for f in bad["failures"]), bad
    chip_smoke.parity_verdict([held])
    with pytest.raises(SystemExit) as ei:
        chip_smoke.parity_verdict([held, bad])
    assert ei.value.code == 1
    assert "unexplained" in capsys.readouterr().err


VIDEO_PARAMS = TParams(device="cpu", levels=2, kappa=5.0, temporal_weight=1.0)


@pytest.mark.parametrize("scheme", ["sequential", "two_phase"])
def test_audit_with_the_temporal_block_against_the_jax_video(scheme, runs):
    """The port's audit of each call of the port's clip against the JAX
    package's call (24x22, ``tests/test_torch_video.py``'s runs), with the
    call's previous frame and anchor: every mismatch explained, per level
    the count of pixels whose picks differ, in all ``tied_mismatches``'
    count (each within the tie band of the port's query, the temporal
    block included).  At this size the two packages' maps agree (no
    mismatch): the test holds the audit's bookkeeping of a video call;
    ``test_audit_reads_the_temporal_block_of_a_tie`` holds its
    classification."""
    a, ap, frames, out = runs
    _, _, calls = out[scheme]
    n_temporal = 0
    for (_, _, _, jr), (tb, tprev, tanc, tr) in zip(calls["jax"],
                                                   calls["port"]):
        audit = t_audit(a, ap, tb, VIDEO_PARAMS, tr.levels, jr.levels,
                        temporal_prev=tprev, remap_anchor=tanc)
        n_temporal += tprev is not None
        assert audit["unexplained"] == 0, audit
        assert audit["first_divergence_is_tie"] in (True, None), audit
        for rec in audit["per_level"]:
            lv = rec["level"]
            assert rec["mismatches"] == int(np.count_nonzero(
                np.asarray(tr.levels[lv][1]) != np.asarray(jr.levels[lv][1])))
        mism, _ = tied_mismatches(a, ap, tb, tprev, tanc, VIDEO_PARAMS,
                                  tr.levels, jr.levels)
        assert audit["mismatches"] == mism
    assert n_temporal == 2


def test_audit_reads_the_temporal_block_of_a_tie():
    """The audit on hand-made picks of one video call (one level, the
    temporal block on, A two copies of one exemplar, A' too but for one
    bump in its right copy): at the call's first pixel (no causal
    context), run X picks a DB row and run Y its twin in the other copy.
    An exact twin is ``tie_exact``, as the float64 reference
    (``tied_mismatches``) finds it; a twin whose features differ only in
    the temporal block (the bump one row below the row, inside its A'
    window but outside the causal fine block) is ``unexplained`` with the
    call's previous frame, and would read as a tie without it."""
    from image_analogies_tpu_torch import create_image_analogy

    a, ap, frames = clip(24, 16, seed=9)
    a2 = np.concatenate([a, a], 1)
    ap2 = np.concatenate([ap, ap], 1)
    ap2[12, 24] += 0.25
    _, _, frames2 = clip(24, 32, seed=4)
    params = VIDEO_PARAMS.replace(levels=1)
    call = dict(temporal_prev=frames2[0] * 0.9, remap_anchor=frames2[0])
    res = create_image_analogy(a2, ap2, frames2[1], params, keep_levels=True,
                               **call)
    bp, s = res.levels[0]
    w = a2.shape[1]

    def audit(x, y, **kw):
        sx, sy = np.array(s), np.array(s)
        sx.reshape(-1)[0], sy.reshape(-1)[0] = x, y
        return t_audit(a2, ap2, frames2[1], params, [(bp, sx)], [(bp, sy)],
                       **kw), [(bp, sx)], [(bp, sy)]

    twin = 5 * w + 6  # row 5, column 6: its twin 16 columns right
    got, lx, ly = audit(twin + 16, twin, **call)
    assert (got["mismatches"], got["tie_exact"], got["unexplained"]) == \
        (1, 1, 0), got
    assert tied_mismatches(a2, ap2, frames2[1], call["temporal_prev"],
                           call["remap_anchor"], params, lx, ly) == (1, 0.0)
    bumped = 11 * w + 24  # the bump at row 12 is one row below it
    got, _, _ = audit(bumped, bumped - 16, **call)
    assert (got["mismatches"], got["unexplained"]) == (1, 1), got
    assert got["first_divergence"]["kind"] == "unexplained"
    # its gap, from the call's own features: A's planes remapped against
    # the anchor, the temporal block of the previous frame
    a_src, b_src, a_filt, _, _ = _prep_planes(a2, ap2, frames2[1], params,
                                              remap_anchor=frames2[0])
    spec = tfeat.spec_for_level(params, 0, 1, 1, temporal=True)
    db = tfeat.build_features_np(spec, a_src, a_filt, None, None,
                                 temporal_fine=a_filt).astype(np.float64)
    q = tfeat.build_features_np(spec, b_src, None, None, None,
                                temporal_fine=call["temporal_prev"])[0]
    d = [((db[r] - q) ** 2).sum() for r in (bumped, bumped - 16)]
    scale = (q.astype(np.float64) ** 2).sum() + max(
        (db[r] ** 2).sum() for r in (bumped, bumped - 16))
    assert got["first_divergence"]["rel_gap"] == pytest.approx(
        abs(d[0] - d[1]) / scale, rel=1e-9)
    blind, _, _ = audit(bumped, bumped - 16)
    assert (blind["tie_exact"], blind["unexplained"]) == (1, 0), blind


@pytest.mark.parametrize("scheme", ["sequential", "two_phase"])
def test_audit_without_clip_arguments_equals_the_jax_audit(scheme, runs):
    """With neither ``temporal_prev`` nor ``remap_anchor`` the port's audit
    is the JAX package's, field for field, on each call of the clip (the
    port's run against the JAX package's, as the JAX audit sees them)."""
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.utils.parity import (
        audit_source_map_mismatches as j_audit)

    a, ap, frames, out = runs
    _, _, calls = out[scheme]
    jp = JParams(backend="tpu", levels=2, kappa=5.0, temporal_weight=1.0)
    for (_, _, _, jr), (tb, _, _, tr) in zip(calls["jax"], calls["port"]):
        want = j_audit(a, ap, tb, jp, tr.levels, jr.levels)
        got = t_audit(a, ap, tb, VIDEO_PARAMS, tr.levels, jr.levels)
        assert {k: got[k] for k in want} == want


# calls of the card's clip (make_all's seed 0) on which the JAX package's
# own packed scan leaves its fp32 scan: (make_all's side, the frame,
# whether the temporal block rides: the call is phase 2's, its previous
# frame the JAX package's phase-1 output of the frame before, whether the
# first divergence is a tie, whether the port's runs make the JAX picks);
# the crossover sends level 0 to the packed scan and levels 1-2 to the
# fp32 argmin.  At 128^2 a tie, and the synthesis that follows comes out
# another texture; with the temporal block the port's plain packed scan
# breaks that call's first tie (1.6e-8 of the score apart) the other way.
# At 160^2 a near tie past the audit's band, one unexplained mismatch of
# 39.  At 96^2 seed 0's four calls (frames 1 and 2 of either phase) keep
# the fp32 picks
JAX_CLIP_CALLS = {"phase1": (128, 1, False, True, True),
                  "phase2": (128, 2, True, True, False),
                  "phase1_near_tie": (160, 2, False, False, True)}


@pytest.mark.parametrize("call", list(JAX_CLIP_CALLS))
def test_jax_packed_scan_with_the_temporal_block_against_its_fp32_scan(
        cpu_parity, jax_tpu_kernels, monkeypatch, call):
    """Why the luminance clips report their SSIM, first divergence and
    unexplained fraction (``PARITY_REPORTED``): the JAX package's own
    packed2k scan (``match_mode="auto"`` past a lowered crossover, its
    Pallas kernels in interpret mode, the DB padded as on its TPU; 224
    lanes, or 336 with the temporal block) against its fp32 scan
    (``exact_hi``) on one call of the card's luminance clip with the video
    preset, as the port's audit reads it with the call's previous frame and
    anchor.  Where the first divergence is a tie every mismatch is
    explained, yet B' is far from the fp32 run's (SSIM < ``SSIM_MIN``):
    one tie flip re-routes every later causal window.  Where it is a near
    tie past the band, it is unexplained, past ``UNEXPLAINED_MAX`` of the
    mismatches.  The port's runs of the same call make the JAX package's
    picks, or leave them at a tie whose mismatches the audit counts level
    by level and explains; the port's pair passes because those limits are
    the ones reported, its unexplained mismatches each the packed scan's
    own pick (the audit's packed replay)."""
    from image_analogies_tpu.config import PRESETS as JPRESETS
    from image_analogies_tpu.models.analogy import (
        create_image_analogy as j_create)
    from image_analogies_tpu.utils.ssim import ssim as j_ssim
    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.utils.assets import make_all

    size, frame, temporal, tie, same_picks = JAX_CLIP_CALLS[call]
    jtpu, packed_calls = jax_tpu_kernels
    monkeypatch.setattr(jtpu, "_PACKED_CROSSOVER_ROWS", size * size // 2)
    monkeypatch.setattr(bcuda, "PACKED_CROSSOVER_ROWS", size * size // 2)
    x = make_all(size, 0)
    a, ap, frames = x["filter_a"], x["filter_ap"], [
        x[f"video_f{t}"] for t in range(3)]
    params = PRESETS["video"].replace(device="cpu")
    jp = JPRESETS["video"].replace(backend="tpu")
    for field in ("levels", "patch_size", "kappa", "temporal_weight",
                  "remap_luminance", "color_mode", "match_mode"):
        assert getattr(jp, field) == getattr(params, field), field
    prev = (np.array(j_create(a, ap, frames[frame - 1], jp,
                              remap_anchor=frames[0]).bp_y)
            if temporal else None)
    kw = dict(temporal_prev=prev, remap_anchor=frames[0], keep_levels=True)
    jres = j_create(a, ap, frames[frame], jp, **kw)
    assert packed_calls, "the JAX anchor never reached its packed kernel"
    jeres = j_create(a, ap, frames[frame], jp.replace(match_mode="exact_hi"),
                     **kw)
    clip_kw = dict(temporal_prev=prev, remap_anchor=frames[0])
    audit = t_audit(a, ap, frames[frame], params, jres.levels, jeres.levels,
                    **clip_kw)
    jssim = j_ssim(np.asarray(jres.bp_y), np.asarray(jeres.bp_y))
    assert audit["first_divergence_is_tie"] is tie, audit
    if tie:
        assert audit["mismatches"] > 500 and audit["unexplained"] == 0, audit
        assert jssim < chip_smoke.SSIM_MIN
    else:
        assert audit["first_divergence"]["rel_gap"] > audit["tol"]
        assert (audit["unexplained"] / audit["mismatches"]
                > chip_smoke.UNEXPLAINED_MAX), audit
    pre = create_image_analogy(a, ap, frames[frame], params, **kw)
    ep = params.replace(match_mode="exact_hi")
    exact = create_image_analogy(a, ap, frames[frame], ep, **kw)
    for run, ref in ((pre, jres), (exact, jeres)):
        vs = t_audit(a, ap, frames[frame], params, run.levels, ref.levels,
                     **clip_kw)
        for rec in vs["per_level"]:
            lv = rec["level"]
            assert rec["mismatches"] == int(np.count_nonzero(
                np.asarray(run.levels[lv][1])
                != np.asarray(ref.levels[lv][1])))
        assert vs["unexplained"] == 0, vs
        assert vs["first_divergence_is_tie"] in (True, None), vs
        assert (vs["mismatches"] == 0) is (same_picks or run is exact), vs
    rec = chip_smoke.parity_hold(
        "video_two_phase", (a, ap, frames[frame], params, pre, {}, 0.0),
        (a, ap, frames[frame], ep, exact, {}, 0.0), **clip_kw)
    assert rec["reported"] == list(chip_smoke.LUMINANCE_VIDEO_REPORTED)
    assert rec["failures"] == [], rec
    assert rec["packed_pick"] == rec["unexplained"], rec
    if same_picks:
        assert rec["unexplained"] == audit["unexplained"]
        assert rec["ssim"] < chip_smoke.SSIM_MIN or not tie
        assert rec["first_divergence"]["packed_pick"] is not tie


@pytest.fixture(scope="module")
def first_corner():
    """The 512^2 luminance clip's first call (frame 0: phase 1, and the
    sequential clip's first frame) on the 32^2 top-left crop of its frame,
    against the full A and A', A remapped against the full first frame as
    the clip does: at the video preset's match mode (level 0's 262,144 DB
    rows take the packed2k scan, as on the card) and with ``exact_hi``.
    The first pixels' queries read only the corner of B and of the coarser
    levels, whose decisions read only their own corners, so the crop makes
    the full call's first decisions: its first divergence is the card's to
    every digit, and its B' is the previous frame of phase 2's first pixel
    (whose gap is the card's too).  Returns (a, ap, b, anchor, params, the
    preset run, the exact_hi run)."""
    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.utils.assets import make_all

    x = make_all(512, 0)
    f0 = x["video_f0"]
    a, ap, b = x["filter_a"], x["filter_ap"], f0[:32, :32]
    params = PRESETS["video"].replace(device="cpu")
    runs = [create_image_analogy(a, ap, b, p, remap_anchor=f0,
                                 keep_levels=True)
            for p in (params, params.replace(match_mode="exact_hi"))]
    return (a, ap, b, f0, params, *runs)


def test_audit_replays_the_packed_scan_at_the_clips_first_pixel(first_corner):
    """The luminance clips' first divergence and unexplained mismatches
    are held to the packed scan's own arithmetic (``PARITY_REPORTED``,
    ``parity_hold``): on the clip's first call, cropped, the preset run
    diverges from the exact_hi run at level 0's first pixel, 9.3e-6 of
    the score apart (the card's reading), past the audit's band.  Replayed
    with the packed2k scan's own scores (``packed_levels``), it and every
    other unexplained mismatch are the packed scan's picks, and the pair
    holds; the same pixel moved off it to a row half the DB away is no
    packed pick, and the pair fails.  Without ``packed_levels`` nothing is
    replayed."""
    a, ap, b, anchor, params, pre, exact = first_corner
    assert [st["match_mode"] for st in pre.stats] == [
        "exact_hi", "exact_hi", "exact_hi2_2p"]
    kw = dict(remap_anchor=anchor)
    audit = t_audit(a, ap, b, params, pre.levels, exact.levels,
                    packed_levels=[0], **kw)
    fd = audit["first_divergence"]
    assert (fd["level"], fd["pixel"], fd["kind"]) == (0, 0, "unexplained")
    assert fd["rel_gap"] == pytest.approx(FIRST_PIXEL[False][2], rel=1e-9)
    assert fd["packed_pick"] is True
    assert audit["unexplained"] >= 1
    assert audit["packed_pick"] == audit["unexplained"], audit
    replay = audit["packed_replay"]
    assert len(replay) == audit["unexplained"] and replay[0]["pixel"] == 0
    for r in replay:
        assert r["packed_pick"] and r["packed_gap"] <= audit["tol"], r
        assert 1 <= r["band_rows"] <= 16, r
    plain = t_audit(a, ap, b, params, pre.levels, exact.levels, **kw)
    assert plain["packed_pick"] == 0 and plain["packed_replay"] == []
    assert not plain["first_divergence"]["packed_pick"]
    ours = ("packed_pick", "packed_replay", "first_divergence")
    assert {k: v for k, v in plain.items() if k not in ours} == {
        k: v for k, v in audit.items() if k not in ours}
    ep = params.replace(match_mode="exact_hi")
    runs = ((a, ap, b, params, pre, {}, 0.0), (a, ap, b, ep, exact, {}, 0.0))
    held = chip_smoke.parity_hold("video_two_phase", *runs, **kw)
    assert held["failures"] == [], held
    assert held["packed_pick"] == held["unexplained"]
    bad = chip_smoke.parity_hold(
        "video_two_phase", _moved_off_a_tie(*runs), runs[1], **kw)
    assert bad["unexplained"] > bad["packed_pick"]
    assert sorted(bad["failures"]) == [
        "1 unexplained mismatches are not the packed scan's own pick",
        "the first divergence is neither a tie nor the packed scan's own "
        "pick"], bad


class _Stop(Exception):
    """Raised at level 0 to keep a call's finest level unscanned."""


def _first_pixel_level(temporal, monkeypatch, corner):
    """The 512^2 luminance clip's level-0 job for its first pixel, with the
    port's packed and fp32 level DBs of it: A and A' at full size, B the
    32^2 top-left crop of frame 0 (phase 1) or, with ``temporal``, of
    frame 1 with the previous frame the crop's phase-1 output of frame 0
    (``first_corner``: phase 2's first call), A remapped against the full
    first frame as the clip does."""
    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.utils.assets import make_all

    x = make_all(512, 0)
    f0, f1 = x["video_f0"], x["video_f1"]
    b, kw = f0[:32, :32], dict(remap_anchor=f0)
    if temporal:
        b, kw["temporal_prev"] = f1[:32, :32], np.asarray(corner[5].bp_y)
    params = PRESETS["video"].replace(device="cpu")
    got = {}
    synth = bcuda.CudaMatcher.synthesize_level

    def stop_at_level_0(self, db, job):
        if job.level == 0:
            got.update(db=db, job=job)
            raise _Stop
        return synth(self, db, job)

    monkeypatch.setattr(bcuda.CudaMatcher, "synthesize_level",
                        stop_at_level_0)
    with pytest.raises(_Stop):
        create_image_analogy(x["filter_a"], x["filter_ap"], b, params, **kw)
    job = got["job"]
    exact = bcuda.CudaMatcher(params.replace(match_mode="exact_hi"),
                              torch.device("cpu")).build_features(job)
    return job, got["db"], exact


# the first pixel's packed and fp32 picks (DB rows) and their float64 gap
# relative to the score magnitude, as the tie-audit reads it: the card's
# luminance calls printed these gaps as their first divergence, phase 1
# (and the sequential clip's first frame) without the temporal block,
# phase 2 with it
FIRST_PIXEL = {False: (213728, 213216, 9.301180011577934e-06),
               True: (213728, 213216, 7.751534930053994e-06)}


@pytest.mark.parametrize("temporal", [False, True])
def test_jax_packed_scan_leaves_the_clips_first_pixel_past_the_band(
        jax_tpu_kernels, monkeypatch, first_corner, temporal):
    """Why the luminance clips hold their first divergence and their
    unexplained mismatches to the packed scan's own arithmetic instead of
    the audit's band (``PARITY_REPORTED``): on the card every luminance
    call first diverges at level 0's first pixel (no causal context, the
    coarser levels bit-equal), the packed scan's pick a near tie past the
    audit's 2e-6 band from the fp32 scan's, and a handful of pixels like it
    follow.  On the card's query (the 512^2 DB; 224 lanes, and 336 with
    the temporal block of phase 2's previous frame; each gap the card's to
    every digit) the JAX package's own packed2k scan (its Pallas kernel in
    interpret mode, the DB padded as on its TPU) makes the same far pick
    and its fp32 scan the near one, as the port's scans do, and the audit's
    packed replay finds the far pick alone in the packed scores' band: the
    packed scan's resolution, not a fault of the port."""
    from image_analogies_tpu.backends.base import LevelJob as JLevelJob
    from image_analogies_tpu.config import PRESETS as JPRESETS
    from image_analogies_tpu.ops import features as jfeat

    jtpu, packed_calls = jax_tpu_kernels
    job, db, exact = _first_pixel_level(temporal, monkeypatch, first_corner)
    far, near, gap = FIRST_PIXEL[temporal]
    q = db.static_q[:1].clone()
    assert int(bcuda.make_anchor_fn(db)(q)[0][0]) == far
    assert int(bcuda.make_anchor_fn(exact)(
        exact.static_q[:1].clone())[0][0]) == near
    host = lambda v: None if v is None else np.asarray(
        v.cpu() if torch.is_tensor(v) else v, np.float32)
    planes = {k: host(getattr(job, k)) for k in (
        "a_src", "a_filt", "a_src_coarse", "a_filt_coarse", "b_src",
        "b_src_coarse", "b_filt_coarse", "a_temporal", "b_temporal")}
    picks = {}
    for mode in ("exact_hi2_2p", "exact_hi"):
        jp = JPRESETS["video"].replace(backend="tpu", match_mode=mode)
        jjob = JLevelJob(level=0, spec=jfeat.spec_for_level(
            jp, 0, 3, 1, temporal=temporal),
            kappa_mult=jp.kappa_factor(0) ** 2, **planes)
        jdb = jtpu.TpuMatcher(jp).build_features(jjob)
        jq = np.asarray(jdb.static_q[:1])
        np.testing.assert_allclose(jq, q.numpy(), rtol=0, atol=1e-6)
        picks[mode] = int(np.asarray(jtpu.make_anchor_fn(jdb)(jq)[0])[0])
    assert packed_calls, "the JAX anchor never reached its packed kernel"
    assert picks == {"exact_hi2_2p": far, "exact_hi": near}
    # the gap, in float64 from the call's own features
    dbf = tfeat.build_features_np(
        job.spec, planes["a_src"], planes["a_filt"], planes["a_src_coarse"],
        planes["a_filt_coarse"], temporal_fine=planes["a_temporal"])
    qf = tfeat.build_features_np(
        job.spec, planes["b_src"], None, planes["b_src_coarse"],
        planes["b_filt_coarse"], temporal_fine=planes["b_temporal"])[0]
    rows = dbf[[far, near]].astype(np.float64)
    d = ((rows - qf.astype(np.float64)) ** 2).sum(1)
    scale = (qf.astype(np.float64) ** 2).sum() + (rows ** 2).sum(1).max()
    assert abs(d[0] - d[1]) / scale == pytest.approx(gap, rel=1e-6)
    assert abs(d[0] - d[1]) / scale > 2e-6
    band = _packed2k_band(dbf, np.nonzero(job.spec.query_live_mask())[0],
                          2e-6)
    rows, short = band(qf[None, :], [far])[0]
    assert short == 0.0 and far in rows.tolist()
