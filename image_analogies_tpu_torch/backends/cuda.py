"""CUDA backend: the single-device wavefront main path in PyTorch
(counterpart of the single-chip part of ``image_analogies_tpu/backends/
tpu.py``).

Per level, ``CudaMatcher.build_features`` builds the A/A' feature DB, the
static B queries and the padded scan copy on the device (``LevelDB``), and
``synthesize_level`` runs the raster scan re-scheduled onto anti-diagonals
skewed by c = patch_radius + 1 (``wavefront_scan_core``): pixel (i, j) runs
at t = j + c*i, so every causal dependency — edge-clamped window positions
included — lies on a strictly earlier diagonal, and each diagonal resolves
as one batch:

- the anchor scan over the whole DB (``make_anchor_fn``): the fp32 argmin
  kernel (``exact_hi``), the bf16 lane-packed tensor-core scans
  (``exact_hi2``, ``exact_hi2_2p``), or the bf16 candidate scans of the
  probe modes and ``bf16_scoring`` (``scan_rescue[_1p]``,
  ``two_pass[_1p]``), each followed by an exact fp32 re-score;
- batched Ashikhmin coherence over the causal window (``_batched_coherence``);
- the kappa rule (Hertzmann §3.2 eq. 2);
- a scatter of (A' value, source index) into the carry.

The step loop never waits on the device: no ``.item()``, no ``nonzero``, no
boolean-mask indexing, no Python branch on a tensor; the coherence count
stays a device scalar until the single final fetch.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from image_analogies_tpu_torch.backends.base import LevelJob, Matcher
from image_analogies_tpu_torch.ops.features import (
    FeatureSpec,
    build_features_torch,
    window_offsets,
)
from image_analogies_tpu_torch.backends import gate
from image_analogies_tpu_torch.ops.match import (
    _lex_lt,
    add_norm_lanes,
    argmin_l2,
    bf16_split3,
    packed3_best,
    packed_best,
    pertile_champions_queries,
    prepadded_argmin2_queries,
)

_F32 = torch.float32

# match_mode="auto" switches to the packed scan at this many A rows.  The
# value is the JAX package's (backends/tpu.py _PACKED_CROSSOVER_ROWS),
# measured on a TPU; it decides which kernel runs and is due to be
# re-derived on the H100 (ROADMAP).
PACKED_CROSSOVER_ROWS = 131072

# The JAX scan carries source indices as exact f32 values, exact below
# 2^24 rows; the port keeps integer indices but holds the same cap.
MAX_A_ROWS = 2 ** 24

# DB rows of the padded scan copies are a multiple of this
PAD_TILE = 256

# rescue breadth of the scan_rescue anchor: the exact fp32 re-score covers
# the top-T tile champions by scan score (the JAX package's _RESCUE_T)
_RESCUE_T = 8

# Tile cap of the per-tile champion scan (scan_rescue).  The tile decides
# which rows the rescue re-scores, so it is part of the result, not only of
# the speed.  4096 gives level 0 of npr_1024 (Npad 1,048,576) 256 tiles —
# the tiling the JAX package resolves for F <= 128 without a tune store.
# It is the port's own constant, measured on no device (neither a TPU nor
# the H100), and due to be swept on the H100 (ROADMAP).
SCAN_TILE_CAP = 4096

# pad mode of the scan copy each resolved anchor mode reads
PAD_MODES = {
    "exact_hi": "f32",
    "exact_hi2": "packed",
    "exact_hi2_2p": "packed2",
    "scan_rescue": "bf16",
    "scan_rescue_1p": "bf16",
    "two_pass": "bf16",
    "two_pass_1p": "bf16",
}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass
class LevelDB:
    """Device-resident per-level state of the wavefront scan (the fields of
    the JAX package's ``TpuLevelDB`` that this path reads)."""

    db: torch.Tensor  # (Na, F) fp32: re-score / coherence source
    static_q: torch.Tensor  # (Nb, F) fp32, fine_filt block zero
    a_filt_flat: torch.Tensor  # (Na,) A' values
    fine_sqrtw: torch.Tensor  # (nf,) sqrt weights of the fine_filt block
    off: torch.Tensor  # (nf, 2) int64 window offsets
    diag: Tuple[torch.Tensor, ...]  # anti-diagonal segments (T_s, M_s) int64
    # exact_hi: (Npad, Fp) fp32 padded DB; exact_hi2_2p: (Npad, Kp) bf16 wk
    # exact_hi2: (Npad, Kp) bf16 W1 = [d1|d2]; bf16 pads: (Npad, Fp) bf16
    # centered DB
    db_pad: torch.Tensor
    # exact_hi / bf16 pads: (Npad,) fp32 row norms (of the centered rows for
    # bf16), +inf pads
    dbn_pad: Optional[torch.Tensor]
    # (Fp,) centering shift: live dims (packed pads) or all dims (bf16 pads)
    feat_mean: Optional[torch.Tensor]
    live_idx: Optional[torch.Tensor]  # (L,) int64 query-live columns
    db_live: Optional[torch.Tensor]  # (Na, L+2) [live | dead norm | A']
    ha: int
    wa: int
    hb: int
    wb: int
    fine_start: int
    match_mode: str  # resolved per level (a key of PAD_MODES)
    db_pad2: Optional[torch.Tensor] = None  # exact_hi2: W2 = [d3|d1]
    # (Npad,) fp32 half norms, +inf pads (packed and bf16 pads)
    dbnh_pad: Optional[torch.Tensor] = None
    # per-tile champion scan tile (scan_rescue): decides the rescue set
    scan_tile: int = 0


@functools.lru_cache(maxsize=64)
def _diag_schedule_np(h: int, w: int, c: int) -> Tuple[np.ndarray, ...]:
    """Anti-diagonal wavefront schedule, skew c, as a tuple of SEGMENTS:
    within each segment, row t holds the flat indices of every pixel (i, j)
    with j + c*i == t (-1 padding on short diagonals).  The unimodal width
    curve is cut where the 8-aligned quartile bucket of the width changes
    (segments shorter than 64 steps merged), each segment padded only to
    its own maximum width.  A verbatim copy of the JAX package's schedule:
    segment shapes decide the batch each step scans."""
    t_total = c * (h - 1) + w
    m_max = min(h, (w + c - 1) // c)
    ii = np.arange(h)
    rows = []
    counts = np.empty((t_total,), np.int64)
    for t in range(t_total):
        jj = t - c * ii
        ok = (jj >= 0) & (jj < w)
        rows.append((ii[ok] * w + jj[ok]).astype(np.int32))
        counts[t] = rows[-1].size

    def bucket(n):
        q = max(1, m_max // 4)
        return min(3, (n - 1) // q)

    cuts = [0]
    for t in range(1, t_total):
        if bucket(counts[t]) != bucket(counts[t - 1]):
            cuts.append(t)
    cuts.append(t_total)
    spans = [(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
    merged = []
    for span in spans:
        if merged and (span[1] - span[0] < 64
                       or merged[-1][1] - merged[-1][0] < 64):
            merged[-1] = (merged[-1][0], span[1])
        else:
            merged.append(span)

    segs = []
    for a, b in merged:
        seg_m = int(_round_up(max(int(counts[a:b].max()), 1), 8))
        sched = np.full((b - a, seg_m), -1, np.int32)
        for k, t in enumerate(range(a, b)):
            sched[k, :rows[t].size] = rows[t]
        segs.append(sched)
    return tuple(segs)


# --------------------------------------------------------------- level build


def packed_shift_and_halfnorm(src: torch.Tensor, live: torch.Tensor):
    """The two REDUCTIONS of the packed build: the live-dim centering shift
    (column mean of the real rows' live dims; dead dims stay raw — queries
    are zero there, so shifting them would break shift invariance) and the
    half squared norms of the centered rows.  Returns (shift (F,),
    half_norm (N,))."""
    f = src.shape[1]
    shift = torch.zeros((f,), dtype=_F32, device=src.device)
    shift[live] = src[:, live].mean(dim=0)
    srcc = src - shift[None, :]
    return shift, 0.5 * (srcc * srcc).sum(dim=1)


def _split_live(src: torch.Tensor, shift: torch.Tensor, live: torch.Tensor):
    """(d1, d2, d3) bf16: the bit-mask split of the centered live dims, the
    residual d3 ROUNDED to bf16 (JAX ``.astype``)."""
    h1, h2, r2 = bf16_split3((src - shift[None, :])[:, live])
    return tuple(x.to(torch.bfloat16) for x in (h1, h2, r2))


def _inf_pad(x: torch.Tensor, npad: int) -> torch.Tensor:
    """(npad,) fp32: ``x`` on the real rows, +inf on the padding rows."""
    out = torch.full((npad,), float("inf"), dtype=_F32, device=x.device)
    out[:x.shape[0]] = x
    return out


def pack_w12(src: torch.Tensor, shift: torch.Tensor, half_norm: torch.Tensor,
             live: torch.Tensor, npad: int):
    """The exact_hi2 half of the packed build (JAX ``_packed_weight_arrays``
    with ``mode2p=False``): W1 = [d1|d2] and W2 = [d3|d1], (npad, Kp) bf16
    with Kp = 2L rounded up to 128.  Returns (w1, w2, dbnh (npad,) fp32
    half norms, +inf on padding rows)."""
    n = src.shape[0]
    lw = int(live.numel())
    d1, d2, d3 = _split_live(src, shift, live)
    pk = max(_round_up(2 * lw, 128), 128)

    def pack(left, right):
        w = torch.zeros((npad, pk), dtype=torch.bfloat16, device=src.device)
        w[:n, :lw] = left
        w[:n, lw:2 * lw] = right
        return w

    return pack(d1, d2), pack(d3, d1), _inf_pad(half_norm, npad)


def pack_wk(src: torch.Tensor, shift: torch.Tensor, half_norm: torch.Tensor,
            live: torch.Tensor, npad: int):
    """The ELEMENTWISE half of the packed build (JAX ``_packed_weight_arrays``
    with ``mode2p=True``): the single K-wide weight array

        wk = [ d1 | d2 | n1 n2 n3 | d1 | d3 | 0pad ]   (4L + 3 lanes)

    with d1/d2/d3 the bit-mask bf16 split of the centered live dims and
    n1..n3 the split of -half_norm (``add_norm_lanes``; padding rows get
    finite -3e38 lanes).  Returns (wk (npad, Kp) bf16, dbnh (npad,) fp32
    half norms, +inf on padding rows)."""
    n = src.shape[0]
    lw = int(live.numel())
    d1, d2, d3 = _split_live(src, shift, live)
    dbnh = _inf_pad(half_norm, npad)
    o2 = 2 * lw + 3
    pk = max(_round_up(o2 + 2 * lw, 128), 128)
    wk = torch.zeros((npad, pk), dtype=torch.bfloat16, device=src.device)
    wk[:n, :lw] = d1
    wk[:n, lw:2 * lw] = d2
    add_norm_lanes(wk, dbnh, lw)  # lanes [2lw, 2lw+3)
    wk[:n, o2:o2 + lw] = d1
    wk[:n, o2 + lw:o2 + 2 * lw] = d3
    return wk, dbnh


def prepare_level_arrays(spec: FeatureSpec, a_src, a_filt, a_src_coarse,
                         a_filt_coarse, b_src, b_src_coarse, b_filt_coarse,
                         pad_mode: str = "f32", pad_tile: int = PAD_TILE
                         ) -> Dict[str, Optional[torch.Tensor]]:
    """Torch counterpart of the JAX ``_prepare_level_arrays`` for the
    wavefront (``pad_full=True``, no bucketing), in every pad mode:

    - "f32": fp32 pre-pad + row norms (exact_hi);
    - "packed": W1 = [d1|d2], W2 = [d3|d1] + half norms (exact_hi2);
    - "packed2": the K-wide ``wk`` (exact_hi2_2p);
    - "bf16": the DB centered on the mean of ALL columns, ROUNDED to bf16,
      with the exact fp32 norms and half norms of the centered rows
      (scan_rescue / two_pass).

    Inputs are fp32 tensors on the target device; the dict keys mirror the
    JAX function's (``dbn_pad`` / ``dbnh_pad`` are 1-D here)."""
    if pad_mode not in ("f32", "packed", "packed2", "bf16"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    db = build_features_torch(spec, a_src, a_filt, a_src_coarse,
                              a_filt_coarse)
    static_q = build_features_torch(spec, b_src, None, b_src_coarse,
                                    b_filt_coarse)
    db_sqnorm = (db * db).sum(dim=1)
    dev = db.device
    n, f = db.shape
    fp = max(_round_up(f, 128), 128)
    npad = _round_up(n, pad_tile)
    out: Dict[str, Optional[torch.Tensor]] = {
        "db": db, "db_sqnorm": db_sqnorm, "static_q": static_q,
        "a_filt_flat": a_filt.reshape(-1), "db_pad": None, "db_pad2": None,
        "dbn_pad": None, "dbnh_pad": None, "feat_mean": None,
        "live_idx": None, "db_live": None,
    }
    if pad_mode in ("packed", "packed2", "bf16"):
        feat_mean = torch.zeros((fp,), dtype=_F32, device=dev)
    if pad_mode in ("packed", "packed2"):
        live_np = np.nonzero(spec.query_live_mask())[0]
        dead_np = np.setdiff1d(np.arange(spec.total), live_np)
        live = torch.from_numpy(live_np.astype(np.int64)).to(dev)
        dead = torch.from_numpy(dead_np.astype(np.int64)).to(dev)
        # [live cols | dead norm | A' value]: one gathered row yields the
        # live/dead-split distance and the output value
        out["db_live"] = torch.cat(
            [db[:, live], (db[:, dead] ** 2).sum(dim=1)[:, None],
             a_filt.reshape(-1)[:, None]], dim=1)
        shift, half_norm = packed_shift_and_halfnorm(db, live)
        if pad_mode == "packed2":
            w1, dbnh = pack_wk(db, shift, half_norm, live, npad)
            w2 = None
        else:
            w1, w2, dbnh = pack_w12(db, shift, half_norm, live, npad)
        feat_mean[:f] = shift
        out.update(db_pad=w1, db_pad2=w2, dbnh_pad=dbnh, feat_mean=feat_mean,
                   live_idx=live)
    elif pad_mode == "bf16":
        mean = db.mean(dim=0)
        srcc = db - mean[None, :]
        nrm = (srcc * srcc).sum(dim=1)
        feat_mean[:f] = mean
        db_pad = torch.zeros((npad, fp), dtype=torch.bfloat16, device=dev)
        db_pad[:n, :f] = srcc.to(torch.bfloat16)  # rounds, as JAX .astype
        out.update(db_pad=db_pad, dbn_pad=_inf_pad(nrm, npad),
                   dbnh_pad=_inf_pad(0.5 * nrm, npad),
                   feat_mean=feat_mean)
    else:
        db_pad = torch.zeros((npad, fp), dtype=_F32, device=dev)
        db_pad[:n, :f] = db
        out.update(db_pad=db_pad, dbn_pad=_inf_pad(db_sqnorm, npad))
    return out


# -------------------------------------------------------------- the anchor


def scan_tile_rows(npad: int) -> int:
    """Per-tile scan tile for a DB padded to ``npad`` rows (the JAX
    package's ``tune/geometry.scan_tile_rows`` with the port's cap): the
    largest power of two dividing npad, at most ``SCAN_TILE_CAP``, then
    halved until there are >= 16 tiles."""
    p2_npad = npad & (-npad)
    tile = min(SCAN_TILE_CAP, p2_npad, npad)
    while npad // tile < 16 and tile >= 256:
        tile //= 2
    return tile


def _lex_min(d: torch.Tensor, cand: torch.Tensor):
    """Per row, the lexicographic (distance, index) minimum over the
    columns of (d, cand) — order-free, so it equals the JAX package's
    column-by-column ``_lex_lt`` fold.  Returns (idx int64, d)."""
    bv = d.min(dim=1).values
    big = torch.iinfo(cand.dtype).max
    bi = torch.where(d == bv[:, None], cand,
                     torch.full_like(cand, big)).min(dim=1).values
    return bi, bv


def make_anchor_fn(db: LevelDB):
    """The wavefront's full-DB anchor: queries (M, F) -> (p_app (M,) int64,
    d_app (M,) fp32 EXACT squared distance, or None).  In the JAX package's
    order (``backends/tpu.py make_anchor_fn``):

    - "scan_rescue[_1p]": ``pertile_champions`` over the bf16 centered DB
      (hi/lo query blocks folded, or one rounded block for _1p) gives each
      DB tile's champion; the top ``_RESCUE_T`` tiles by scan score (stable
      descending sort: the lower tile wins ties, as ``lax.top_k``) are
      clamped to a real row and re-scored in exact fp32; the lexicographic
      (distance, index) minimum wins.
    - "exact_hi2" / "exact_hi2_2p": the queries are centered on the live
      dims and split into bf16 q1 + q2 (+ q3, the residual rounded) by bit
      mask.  exact_hi2 scans ``packed3_best`` (rows [q1|q1], [q2|q2] against
      W1 = [d1|d2] plus [q1|q3] against W2 = [d3|d1], minus the half norm:
      the six bf16_6x products); exact_hi2_2p lays the query out as
      [q1|q1|1 1 1|q2|q1|0] against wk so one ``packed_best`` dot gives
      q1.d1 + q1.d2 + q2.d1 + q1.d3 - ||d||^2/2.  The pick is clamped to a
      real row; its fp32 re-score is deferred (d_app None): the step takes
      it from the coherence block's ``db_live`` row gather, which fetches
      the pick's row anyway.
    - "two_pass[_1p]": ``argmin2_l2`` over the bf16 centered DB gives two
      candidates; both are re-scored in exact fp32 (the second only where
      it exists) and the lexicographic minimum wins.
    - "exact_hi": ``argmin_l2`` (exact fp32 scores), then the fp32 re-score
      against the full DB row.
    """
    na = db.ha * db.wa
    mode = db.match_mode
    f = int(db.static_q.shape[1])
    if mode in ("scan_rescue", "scan_rescue_1p"):
        q_split = mode == "scan_rescue"
        tile = db.scan_tile
        ntiles = int(db.db_pad.shape[0]) // tile
        t_rescue = min(_RESCUE_T, ntiles)
        mean = db.feat_mean[:f]

        def anchor(queries):
            vals, idx = pertile_champions_queries(
                queries - mean[None, :], db.db_pad, db.dbnh_pad, tile,
                q_split)
            if t_rescue < ntiles:
                order = torch.sort(vals, dim=1, descending=True,
                                   stable=True).indices[:, :t_rescue]
                cand = idx.gather(1, order)
            else:
                cand = idx
            # champions of all-padding tiles are out-of-range rows (score
            # -inf): clamped to the last real row they can at worst tie the
            # real champion there and lose on the index
            cand = cand.long().clamp(max=na - 1)
            d = ((db.db[cand] - queries[:, None, :]) ** 2).sum(dim=-1)
            return _lex_min(d, cand)

        return anchor

    if mode in ("exact_hi2", "exact_hi2_2p"):
        live = db.live_idx
        lw = int(live.numel())
        shift = db.feat_mean[:f]
        dev = db.db.device
        if mode == "exact_hi2":
            def scan(qc):
                g1, g2, gr = bf16_split3(qc[:, live])
                p, _ = packed3_best(
                    g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                    gr.to(torch.bfloat16), db.db_pad, db.db_pad2,
                    db.dbnh_pad)
                return p
        else:
            o2 = 2 * lw + 3
            kp = int(db.db_pad.shape[1])
            k_used = _round_up(o2 + 2 * lw, 16)

            def scan(qc):
                m = qc.shape[0]
                g1, g2, _ = bf16_split3(qc[:, live])
                q1 = g1.to(torch.bfloat16)
                q2 = g2.to(torch.bfloat16)
                qa = torch.cat([
                    q1, q1,
                    torch.ones((m, 3), dtype=torch.bfloat16, device=dev),
                    q2, q1,
                    torch.zeros((m, kp - o2 - 2 * lw), dtype=torch.bfloat16,
                                device=dev)], dim=1)
                p, _ = packed_best(qa, db.db_pad, k_used)
                return p

        def anchor(queries):
            p = scan(queries - shift[None, :])
            return torch.clamp(p.long(), max=na - 1), None

        return anchor

    if mode in ("two_pass", "two_pass_1p"):
        q_split = mode == "two_pass"
        mean = db.feat_mean[:f]

        def anchor(queries):
            i1, i2, ok2 = prepadded_argmin2_queries(
                queries - mean[None, :], db.db_pad, db.dbn_pad, q_split)
            i1 = i1.long()
            i2 = i2.long().clamp(max=na - 1)  # no second row: masked below
            d1 = ((db.db[i1] - queries) ** 2).sum(dim=1)
            d2 = torch.where(ok2, ((db.db[i2] - queries) ** 2).sum(dim=1),
                             torch.full_like(d1, float("inf")))
            use2 = _lex_lt(d2, i2, d1, i1)
            return torch.where(use2, i2, i1), torch.where(use2, d2, d1)

        return anchor

    def anchor(queries):
        p, _ = argmin_l2(queries, db.db_pad, db.dbn_pad)
        p = p.long()
        return p, ((db.db[p] - queries) ** 2).sum(dim=1)

    return anchor


# --------------------------------------------------------------- coherence


def _batched_coherence(db: LevelDB, queries, s_r, ok, p_app=None):
    """Batched Ashikhmin candidates for M pixels (Hertzmann §3.2): for each
    query the candidates are {s(r) + (q - r)} over its causal window
    positions r (``s_r`` (M, nc) source indices there, ``ok`` their base
    validity), scored in fp32 — against the full DB rows, or, with
    ``p_app`` (the packed anchor's deferred pick), by the live/dead split
    d = sum_live (cf - q)^2 + dead norm over ``db_live`` rows with the pick
    appended as one more gathered column, so its exact re-score and A'
    value ride the same row gather.

    Returns (p_coh, d_coh, has_coh), plus (d_app, af_coh, af_app) when
    ``p_app`` is given."""
    nc = s_r.shape[1]
    off_i = db.off[:nc, 0]
    off_j = db.off[:nc, 1]
    ha, wa = db.ha, db.wa
    ci = s_r // wa - off_i[None, :]
    cj = s_r % wa - off_j[None, :]
    ok = ok & (ci >= 0) & (ci < ha) & (cj >= 0) & (cj < wa)
    cand = ci.clamp(0, ha - 1) * wa + cj.clamp(0, wa - 1)
    if p_app is not None:
        q_live = queries[:, db.live_idx]
        lw = q_live.shape[1]
        cf = db.db_live[torch.cat([cand, p_app[:, None]], dim=1)]
        dca = ((cf[..., :lw] - q_live[:, None, :]) ** 2).sum(dim=-1) \
            + cf[..., lw]  # (M, nc+1)
        dc = dca[:, :nc]
    else:
        cf = db.db[cand]  # (M, nc, F)
        dc = ((cf - queries[:, None, :]) ** 2).sum(dim=-1)
    dc = torch.where(ok, dc, torch.full_like(dc, float("inf")))
    k = torch.argmin(dc, dim=1)
    d_coh = dc.gather(1, k[:, None])[:, 0]
    p_coh = cand.gather(1, k[:, None])[:, 0]
    has_coh = ok.any(dim=1)
    if p_app is None:
        return p_coh, d_coh, has_coh
    af = cf[..., lw + 1]
    return (p_coh, d_coh, has_coh, dca[:, nc],
            af.gather(1, k[:, None])[:, 0], af[:, nc])


# ------------------------------------------------------------ wavefront scan


def wavefront_scan_core(db: LevelDB, kappa_mult: float, anchor_fn):
    """The oracle's raster-scan rule on the anti-diagonal schedule (see the
    module docstring; the dependency proof is in the JAX package's
    ``wavefront_scan_core``).

    Carry: B' values (fp32) and source indices (int64), each with
    ``M_max`` spare rows at the end — the schedule's padding lanes (-1)
    write to distinct spare rows ``nb + lane`` instead of being dropped, so
    the scatter needs no mask and no host sync.  The per-step window
    indices and masks depend only on the schedule, so each segment's are
    computed once, batched over its steps.

    Returns (bp (Nb,) fp32, s (Nb,) int32, n_coh () int64 device scalar)."""
    hb, wb = db.hb, db.wb
    nb = hb * wb
    if db.ha * db.wa > MAX_A_ROWS:
        raise ValueError(
            f"the wavefront scan caps exemplars at {MAX_A_ROWS} A rows "
            f"(a 4096x4096 A); this A is {db.ha}x{db.wa}")
    dev = db.static_q.device
    nf = int(db.off.shape[0])
    nc = (nf - 1) // 2  # causal positions = the first nc raster offsets
    off_i = db.off[:nc, 0]
    off_j = db.off[:nc, 1]
    wsq_c = db.fine_sqrtw[:nc]
    fs = db.fine_start
    m_max = max(int(seg.shape[1]) for seg in db.diag)
    bp = torch.zeros((nb + m_max,), dtype=_F32, device=dev)
    s = torch.zeros((nb + m_max,), dtype=torch.int64, device=dev)
    n_coh = torch.zeros((), dtype=torch.int64, device=dev)
    kappa = torch.tensor(kappa_mult, dtype=_F32, device=dev)
    lanes = torch.arange(m_max, dtype=torch.int64, device=dev)

    for seg in db.diag:
        n_steps, m = int(seg.shape[0]), int(seg.shape[1])
        # schedule-only quantities for every step of the segment
        lane_ok = seg >= 0  # (T, M)
        pixc = seg.clamp(min=0)
        qi = pixc // wb
        qj = pixc - qi * wb
        wi = qi[..., None] + off_i  # (T, M, nc)
        wj = qj[..., None] + off_j
        inb = (wi >= 0) & (wi < hb) & (wj >= 0) & (wj < wb)
        widx = wi.clamp(0, hb - 1) * wb + wj.clamp(0, wb - 1)  # edge-clamped
        # written-mask times sqrt weight: window positions already
        # synthesized (clamped index < pixel index) contribute B' values
        wsq = (widx < pixc[..., None]).to(_F32) * wsq_c
        wpix = torch.where(lane_ok, seg, nb + lanes[:m])
        for t in range(n_steps):
            idx = widx[t]
            dyn = bp[idx] * wsq[t]
            s_r = s[idx]
            queries = db.static_q[pixc[t]]
            queries[:, fs:fs + nc] = dyn
            p_app, d_app = anchor_fn(queries)
            if d_app is None:  # packed anchor: re-score rides the gather
                p_coh, d_coh, has_coh, d_app, af_coh, af_app = \
                    _batched_coherence(db, queries, s_r, inb[t], p_app=p_app)
            else:
                p_coh, d_coh, has_coh = _batched_coherence(
                    db, queries, s_r, inb[t])
                af_coh = af_app = None
            use_coh = has_coh & (d_coh <= d_app * kappa)
            p = torch.where(use_coh, p_coh, p_app)
            af = (db.a_filt_flat[p] if af_app is None
                  else torch.where(use_coh, af_coh, af_app))
            bp.index_copy_(0, wpix[t], af)
            s.index_copy_(0, wpix[t], p)
            n_coh += (use_coh & lane_ok[t]).sum()
    return bp[:nb], s[:nb].to(torch.int32), n_coh


# ------------------------------------------------------------------ matcher


def resolve_match_mode(match_mode: str, a_rows: int) -> str:
    """Per-level anchor scan: "auto" packs at or above the crossover."""
    if match_mode == "auto":
        return ("exact_hi2_2p" if a_rows >= PACKED_CROSSOVER_ROWS
                else "exact_hi")
    return match_mode



class CudaMatcher(Matcher):
    """The port's matcher: every tensor on ``device`` (the card, or the CPU
    where every kernel runs its plain version)."""

    def __init__(self, params, device: torch.device):
        super().__init__(params)
        self.device = torch.device(device)

    def _t(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(self.device, _F32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def build_features(self, job: LevelJob) -> LevelDB:
        spec = job.spec
        ha, wa = job.a_shape
        hb, wb = job.b_shape
        # JAX TpuMatcher.build_features steering: match_mode resolved per
        # level, then bf16_scoring switches to scan_rescue once the parity
        # gate allows it on this device (a refused verdict keeps the exact
        # scan), then the pad mode of the resolved scan
        mode = resolve_match_mode(self.params.match_mode, ha * wa)
        if self.params.bf16_scoring and gate.bf16_gate_allows(self.params,
                                                              self.device):
            mode = "scan_rescue"
        pad_mode = PAD_MODES[mode]
        arrs = prepare_level_arrays(
            spec, self._t(job.a_src), self._t(job.a_filt),
            self._t(job.a_src_coarse), self._t(job.a_filt_coarse),
            self._t(job.b_src), self._t(job.b_src_coarse),
            self._t(job.b_filt_coarse), pad_mode=pad_mode)
        npad = int(arrs["db_pad"].shape[0])
        fsl = spec.fine_filt_slice
        diag = tuple(torch.from_numpy(sg.astype(np.int64)).to(self.device)
                     for sg in _diag_schedule_np(hb, wb,
                                                 spec.fine_size // 2 + 1))
        return LevelDB(
            db=arrs["db"], static_q=arrs["static_q"],
            a_filt_flat=arrs["a_filt_flat"],
            fine_sqrtw=torch.from_numpy(spec.sqrt_weights()[fsl]).to(
                self.device),
            off=torch.from_numpy(
                window_offsets(spec.fine_size).astype(np.int64)).to(
                    self.device),
            diag=diag, db_pad=arrs["db_pad"], dbn_pad=arrs["dbn_pad"],
            feat_mean=arrs["feat_mean"], live_idx=arrs["live_idx"],
            db_live=arrs["db_live"], ha=ha, wa=wa, hb=hb, wb=wb,
            fine_start=fsl.start, match_mode=mode, db_pad2=arrs["db_pad2"],
            dbnh_pad=arrs["dbnh_pad"],
            scan_tile=scan_tile_rows(npad) if pad_mode == "bf16" else 0)

    def synthesize_level(self, db: LevelDB, job: LevelJob
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, Any]]:
        """Returns device-resident (bp (hb, wb), s (hb, wb)) plus stats;
        the coherence count stays a device scalar under "_n_coh"."""
        t0 = time.perf_counter()
        bp, s, n_coh = wavefront_scan_core(
            db, job.kappa_mult, make_anchor_fn(db))
        hb, wb = job.b_shape
        stats: Dict[str, Any] = {
            "level": job.level,
            "db_rows": job.a_shape[0] * job.a_shape[1],
            "pixels": hb * wb,
            "_n_coh": n_coh,
            "backend": self.device.type,
            "strategy": "wavefront",
            "match_mode": db.match_mode,
        }
        # one wait per level (never inside the step loop): per-level ms is
        # the device's time, not the enqueue time
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        stats["ms"] = dt * 1e3
        stats["pixels_per_s"] = hb * wb / max(dt, 1e-9)
        return bp.reshape(hb, wb), s.reshape(hb, wb), stats
