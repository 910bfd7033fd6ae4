"""CUDA backend: every single-device strategy in PyTorch (counterpart of
the single-chip part of ``image_analogies_tpu/backends/tpu.py``).

Per level, ``CudaMatcher.build_features`` builds the A/A' feature DB, the
static B queries and the scan copy on the device (``LevelDB``), and
``synthesize_level`` runs the level's strategy.

**wavefront** (what "auto" resolves to): the raster scan re-scheduled onto
anti-diagonals skewed by c = patch_radius + 1 (``wavefront_scan_core``):
pixel (i, j) runs at t = j + c*i, so every causal dependency — edge-clamped
window positions included — lies on a strictly earlier diagonal, and each
diagonal resolves as one batch:

- the anchor scan over the whole DB (``make_anchor_fn``): the fp32 argmin
  kernel (``exact_hi``), the bf16 lane-packed tensor-core scans
  (``exact_hi2``, ``exact_hi2_2p``), or the bf16 candidate scans of the
  probe modes and ``bf16_scoring`` (``scan_rescue[_1p]``,
  ``two_pass[_1p]``), each followed by an exact fp32 re-score;
- batched Ashikhmin coherence over the causal window (``_batched_coherence``);
- the kappa rule (Hertzmann §3.2 eq. 2);
- a scatter of (A' value, source index) into the carry.

**batched** (``batched_scan_core``): the causal window is cut to the rows
strictly above, for the queries, the DB (``db_rowsafe``) and the coherence
candidates, so a whole scan row resolves in one step: the approximate match
(``make_approx_fn``: one bf16 pass on the card, exact fp32 on the CPU),
rows-above coherence, the kappa rule, then ``refine_passes`` vectorized
passes that restore same-row left-propagation (``_left_refine``).

**rowwise** and **exact** (``_run_rowwise``, ``_run_exact``): the per-pixel
sequential scan, kept for parity validation as in the JAX package — rowwise
takes one approximate match per row and re-scores each pick in fp32, exact
scores every pixel against the full DB in fp32.

The step loops never wait on the device: no ``.item()``, no ``nonzero``, no
boolean-mask indexing, no Python branch on a tensor; the coherence counts
stay device scalars until the single final fetch.
"""

from __future__ import annotations

import dataclasses
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
    causal_mask,
    window_offsets,
)
from image_analogies_tpu_torch.backends import gate
from image_analogies_tpu_torch.ops.match import (
    _lex_lt,
    add_norm_lanes,
    argmin_l2,
    argmin_l2_plain,
    bf16_split3,
    packed3_best,
    packed_best,
    pertile_champions_queries,
    prepadded_argmin2_queries,
    prepadded_argmin_queries,
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
    """Device-resident per-level state of a level scan (the fields of the
    JAX package's ``TpuLevelDB`` that the port's strategies read).  The
    fields after ``scan_tile`` serve the exact, rowwise and batched
    strategies; wavefront levels leave them at their defaults."""

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
    strategy: str = "wavefront"  # resolved ("auto" -> "wavefront")
    db_sqnorm: Optional[torch.Tensor] = None  # (Na,) fp32
    # (Na, F) the DB with its fine_filt block masked to the rows above, and
    # its (Na,) norms: the batched strategy's symmetric metric
    db_rowsafe: Optional[torch.Tensor] = None
    db_rowsafe_sqnorm: Optional[torch.Tensor] = None
    # (Nb, nf) gather maps (``gather_maps_device``): int64 clipped window
    # indices, fp32 in-bounds-and-causal, fp32 causal-and-written
    flat_idx: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    written: Optional[torch.Tensor] = None
    rowsafe: Optional[torch.Tensor] = None  # (nf,) fp32 causal offsets, di<0
    n_rowsafe: int = 0  # (p // 2) * p: the rows-above window positions
    refine_passes: int = 3  # batched left-propagation passes


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


def rowsafe_mask(p: int) -> np.ndarray:
    """(p*p,) fp32: 1 on the causal window offsets strictly above the
    center row (di < 0) — what the batched strategy's queries, DB and
    coherence candidates keep of the fine_filt block."""
    off = window_offsets(p)
    return (off[:, 0] < 0).astype(np.float32) * causal_mask(p)


def gather_maps_device(h: int, w: int, p: int, device):
    """Device twin of ``ops.features.fine_gather_maps`` (the JAX package's
    ``_gather_maps_device``), computed from index arithmetic on ``device``:
    (flat_idx int64, valid fp32, written fp32), each (h*w, p*p) — clipped
    flat window indices, in-bounds-and-causal, and causal-and-already-
    written (clamped index < pixel index)."""
    off = torch.from_numpy(window_offsets(p).astype(np.int64)).to(device)
    ii = torch.arange(h, device=device).repeat_interleave(w)[:, None]
    jj = torch.arange(w, device=device).repeat(h)[:, None]
    qi = ii + off[None, :, 0]
    qj = jj + off[None, :, 1]
    inb = (qi >= 0) & (qi < h) & (qj >= 0) & (qj < w)
    flat = qi.clamp(0, h - 1) * w + qj.clamp(0, w - 1)
    causal = torch.from_numpy(causal_mask(p) > 0).to(device)[None, :]
    valid = (inb & causal).to(_F32)
    written = (causal & (flat < ii * w + jj)).to(_F32)
    return flat, valid, written


def pad_bf16_uncentered(src: torch.Tensor, srcn: torch.Tensor,
                        pad_tile: int = PAD_TILE):
    """The scan copy of the batched/rowwise approximate match on the card:
    the rows ``src`` (N, F) ROUNDED to bf16 (as JAX ``.astype``), not
    centered, lane-padded to (Npad, Fp) with Npad a multiple of
    ``pad_tile``, beside ``srcn`` — the exact fp32 norms of the UNROUNDED
    rows — with +inf on the padding rows.  (The "bf16" pad mode centers on
    the column mean first: rounding centered values gives other numbers.)
    Returns (db_pad (Npad, Fp) bf16, dbn_pad (Npad,) fp32)."""
    n, f = src.shape
    fp = max(_round_up(f, 128), 128)
    npad = _round_up(n, pad_tile)
    db_pad = torch.zeros((npad, fp), dtype=torch.bfloat16, device=src.device)
    db_pad[:n, :f] = src.to(torch.bfloat16)
    return db_pad, _inf_pad(srcn, npad)


def prepare_level_arrays(spec: FeatureSpec, a_src, a_filt, a_src_coarse,
                         a_filt_coarse, b_src, b_src_coarse, b_filt_coarse,
                         pad_mode: Optional[str] = "f32",
                         pad_tile: int = PAD_TILE,
                         rowsafe: Optional[torch.Tensor] = None,
                         a_temporal=None, b_temporal=None
                         ) -> Dict[str, Optional[torch.Tensor]]:
    """Torch counterpart of the JAX ``_prepare_level_arrays`` (no
    bucketing).  With the spec's temporal block, ``a_temporal`` (A' at this
    level) fills it on the DB side and ``b_temporal`` (the previous output
    frame at this level) on the query side; the block is static query
    lanes, live in every packed layout (``FeatureSpec.query_live_mask``).
    ``rowsafe`` None is the wavefront (``pad_full=True``):
    ``db_rowsafe`` aliases the full DB.  With ``rowsafe`` (the (nf,) mask
    of ``rowsafe_mask``; ``pad_full=False``) ``db_rowsafe`` is the DB with
    its fine_filt block times the mask, and the scan copy is built from it.
    Pad modes of the scan copy:

    - "f32": fp32 pre-pad + row norms (exact_hi);
    - "packed": W1 = [d1|d2], W2 = [d3|d1] + half norms (exact_hi2);
    - "packed2": the K-wide ``wk`` (exact_hi2_2p);
    - "bf16": the DB centered on the mean of ALL columns, ROUNDED to bf16,
      with the exact fp32 norms and half norms of the centered rows
      (scan_rescue / two_pass);
    - "bf16_uncentered": ``pad_bf16_uncentered`` (batched and rowwise on
      the card);
    - None: no scan copy (exact, and batched/rowwise on the CPU).

    Inputs are fp32 tensors on the target device; the dict keys mirror the
    JAX function's (``dbn_pad`` / ``dbnh_pad`` are 1-D here)."""
    if pad_mode not in (None, "f32", "packed", "packed2", "bf16",
                        "bf16_uncentered"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    db = build_features_torch(spec, a_src, a_filt, a_src_coarse,
                              a_filt_coarse, temporal_fine=a_temporal)
    static_q = build_features_torch(spec, b_src, None, b_src_coarse,
                                    b_filt_coarse, temporal_fine=b_temporal)
    db_sqnorm = (db * db).sum(dim=1)
    if rowsafe is None:
        db_rowsafe, db_rowsafe_sqnorm = db, db_sqnorm
    else:
        fsl = spec.fine_filt_slice
        db_rowsafe = db.clone()
        db_rowsafe[:, fsl] = db[:, fsl] * rowsafe[None, :]
        db_rowsafe_sqnorm = (db_rowsafe * db_rowsafe).sum(dim=1)
    src, srcn = db_rowsafe, db_rowsafe_sqnorm
    dev = db.device
    n, f = db.shape
    fp = max(_round_up(f, 128), 128)
    npad = _round_up(n, pad_tile)
    out: Dict[str, Optional[torch.Tensor]] = {
        "db": db, "db_sqnorm": db_sqnorm, "db_rowsafe": db_rowsafe,
        "db_rowsafe_sqnorm": db_rowsafe_sqnorm, "static_q": static_q,
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
        shift, half_norm = packed_shift_and_halfnorm(src, live)
        if pad_mode == "packed2":
            w1, dbnh = pack_wk(src, shift, half_norm, live, npad)
            w2 = None
        else:
            w1, w2, dbnh = pack_w12(src, shift, half_norm, live, npad)
        feat_mean[:f] = shift
        out.update(db_pad=w1, db_pad2=w2, dbnh_pad=dbnh, feat_mean=feat_mean,
                   live_idx=live)
    elif pad_mode == "bf16":
        mean = src.mean(dim=0)
        srcc = src - mean[None, :]
        nrm = (srcc * srcc).sum(dim=1)
        feat_mean[:f] = mean
        db_pad = torch.zeros((npad, fp), dtype=torch.bfloat16, device=dev)
        db_pad[:n, :f] = srcc.to(torch.bfloat16)  # rounds, as JAX .astype
        out.update(db_pad=db_pad, dbn_pad=_inf_pad(nrm, npad),
                   dbnh_pad=_inf_pad(0.5 * nrm, npad),
                   feat_mean=feat_mean)
    elif pad_mode == "bf16_uncentered":
        db_pad, dbn_pad = pad_bf16_uncentered(src, srcn, pad_tile)
        out.update(db_pad=db_pad, dbn_pad=dbn_pad)
    elif pad_mode == "f32":
        db_pad = torch.zeros((npad, fp), dtype=_F32, device=dev)
        db_pad[:n, :f] = src
        out.update(db_pad=db_pad, dbn_pad=_inf_pad(srcn, npad))
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


def _batched_coherence(db: LevelDB, queries, s_r, ok, p_app=None,
                       row_fn=None):
    """Batched Ashikhmin candidates for M pixels (Hertzmann §3.2): for each
    query the candidates are {s(r) + (q - r)} over its first nc causal
    window positions r (``s_r`` (M, nc) source indices there, ``ok`` their
    base validity), scored in fp32 — against ``row_fn(cand)``, a gather of
    the scoring DB's rows (default the full DB; the rows-above DB for the
    batched strategy), or, with
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
        cf = db.db[cand] if row_fn is None else row_fn(cand)  # (M, nc, F)
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


# ------------------------------------------------------ per-pixel pieces


def _exact_qvec(db: LevelDB, q: int, bp: torch.Tensor) -> torch.Tensor:
    """(F,) causal query of pixel ``q``: its static row with the fine_filt
    block filled from the B' values already written."""
    nf = int(db.off.shape[0])
    qvec = db.static_q[q].clone()
    qvec[db.fine_start:db.fine_start + nf] = (
        bp[db.flat_idx[q]] * db.written[q] * db.fine_sqrtw)
    return qvec


def _exact_d_app(db: LevelDB, qvec: torch.Tensor):
    """The exact strategy's approximate match: the full-DB fp32 argmin of
    ``db_sqnorm - 2 db.qvec`` (first minimum) and its squared distance,
    clamped at 0.  Returns ((1,) int64, (1,) fp32)."""
    scores = db.db_sqnorm - 2.0 * (db.db @ qvec)
    p = torch.argmin(scores).view(1)
    return p, torch.clamp(scores[p] + qvec @ qvec, min=0.0)


def _rescore_d_app(db: LevelDB, qvec: torch.Tensor, p_app: torch.Tensor):
    """Oracle re-score of a precomputed approximate pick (rowwise): the
    exact fp32 squared distance of the FULL DB row to the causal query."""
    return p_app, ((db.db[p_app] - qvec) ** 2).sum(dim=1)


def _pixel_coherence(db: LevelDB, qvec: torch.Tensor, q: int,
                     s: torch.Tensor):
    """Ashikhmin candidates for one pixel from its full causal window.
    Returns (p_coh (1,) int64, d_coh (1,) fp32, has_coh () bool)."""
    s_r = s[db.flat_idx[q]]
    ci = s_r // db.wa - db.off[:, 0]
    cj = s_r % db.wa - db.off[:, 1]
    inb = ((ci >= 0) & (ci < db.ha) & (cj >= 0) & (cj < db.wa)
           & (db.valid[q] > 0))
    cand = ci.clamp(0, db.ha - 1) * db.wa + cj.clamp(0, db.wa - 1)
    dc = ((db.db[cand] - qvec[None, :]) ** 2).sum(dim=1)
    dc = dc.masked_fill(~inb, float("inf"))
    k = torch.argmin(dc).view(1)
    return cand[k], dc[k], inb.any()


def _resolve_pixel(db: LevelDB, q: int, bp, s, coh, p_app, d_app_fn,
                   kappa):
    """The per-pixel decision of the exact and rowwise strategies: build
    the causal query, take d_app from ``d_app_fn(qvec, p_app)`` (full-DB
    scores for exact, the pick's re-score for rowwise), take the best
    coherence candidate, apply the kappa rule and write (bp, s) and the
    coherence flag at ``q`` in place."""
    qvec = _exact_qvec(db, q, bp)
    p_app, d_app = d_app_fn(qvec, p_app)
    p_coh, d_coh, has_coh = _pixel_coherence(db, qvec, q, s)
    use_coh = has_coh & (d_coh <= d_app * kappa)
    p = torch.where(use_coh, p_coh, p_app)
    bp[q:q + 1] = db.a_filt_flat[p]
    s[q:q + 1] = p
    coh[q:q + 1] = use_coh


def _pixel_scan(db: LevelDB, kappa_mult: float, per_row):
    """The per-pixel raster scan shared by exact and rowwise: ``per_row(r,
    bp)`` returns the row's (d_app_fn, approximate picks or None).
    Returns (bp (Nb,) fp32, s (Nb,) int32, n_coh () int64)."""
    nb = db.hb * db.wb
    dev = db.static_q.device
    bp = torch.zeros((nb,), dtype=_F32, device=dev)
    s = torch.zeros((nb,), dtype=torch.int64, device=dev)
    coh = torch.zeros((nb,), dtype=torch.bool, device=dev)
    kappa = torch.tensor(kappa_mult, dtype=_F32, device=dev)
    for r in range(db.hb):
        d_app_fn, p_apps = per_row(r, bp)
        for j in range(db.wb):
            q = r * db.wb + j
            p_app = None if p_apps is None else p_apps[j:j + 1]
            _resolve_pixel(db, q, bp, s, coh, p_app, d_app_fn, kappa)
    return bp, s.to(torch.int32), coh.sum()


def _run_exact(db: LevelDB, kappa_mult: float):
    """The exact strategy: every pixel in raster order, its approximate
    match the full-DB fp32 argmin (a plain product, as the JAX package
    leaves it to XLA outside any Pallas kernel; TF32 stays off)."""
    exact = lambda qvec, _: _exact_d_app(db, qvec)
    return _pixel_scan(db, kappa_mult, lambda r, bp: (exact, None))


def _run_rowwise(db: LevelDB, kappa_mult: float):
    """The rowwise strategy: one approximate match per scan row over the
    rows-above metric (``make_approx_fn``), then the per-pixel pass, each
    pick re-scored in fp32 against the full DB row."""
    approx_fn = make_approx_fn(db)
    rescore = lambda qvec, p_app: _rescore_d_app(db, qvec, p_app)

    def per_row(r, bp):
        p_apps, _ = approx_fn(_row_queries(db, r, bp, db.rowsafe))
        return rescore, p_apps.long()

    return _pixel_scan(db, kappa_mult, per_row)


# ------------------------------------------------------------ batched scan


def make_approx_fn(db: LevelDB):
    """The batched and rowwise strategies' approximate match, queries (M,
    F) -> (idx (M,), d (M,) squared distance), against the rows-above DB
    (the JAX ``make_approx_fn`` without its ANN branch):

    - with the level's bf16 scan copy (built on the card):
      ``prepadded_argmin_queries`` — one bf16 pass with fp32 accumulation
      (``argmin_l2_bf16``), the kernel precision the JAX package gives
      these strategies.  ``d`` is that pass's score plus ||q||^2: the kappa
      rule sees the scan's own distance, with no fp32 re-score.
    - without it (the CPU): the exact fp32 scores of ``argmin_l2_plain``,
      what the JAX package computes off the TPU.

    A card level without the scan copy raises: the card never runs the
    fp32 form in place of the kernel."""
    if db.db_pad is not None:
        return lambda queries: prepadded_argmin_queries(queries, db.db_pad,
                                                        db.dbn_pad)
    if db.db_rowsafe.device.type != "cpu":
        raise ValueError(
            "the approximate match on the card scans the bf16 copy of the "
            "rows-above DB (pad mode 'bf16_uncentered'); this level has none")

    def approx_fn(queries):
        idx, score = argmin_l2_plain(queries, db.db_rowsafe,
                                     db.db_rowsafe_sqnorm)
        return idx, torch.clamp(score + (queries * queries).sum(dim=1),
                                min=0.0)

    return approx_fn


def _row_queries(db: LevelDB, r: int, bp: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(wb, F) queries of scan row ``r``; ``mask`` picks which causal
    offsets contribute B' values (rowsafe for batched and rowwise)."""
    nf = int(db.off.shape[0])
    rows = slice(r * db.wb, (r + 1) * db.wb)
    queries = db.static_q[rows].clone()
    queries[:, db.fine_start:db.fine_start + nf] = (
        bp[db.flat_idx[rows]] * db.written[rows] * mask[None, :]
        * db.fine_sqrtw[None, :])
    return queries


def _left_refine(db: LevelDB, queries, p, d_pick, d_app, kappa, row_fn):
    """One vectorized left-propagation pass over a resolved row: the
    same-row candidates {s(j-d) + (0, d)}, d = 1..radius, from the row's
    current picks ``p``, each kept only if it passes the kappa rule against
    ``d_app`` and beats the current pick's distance ``d_pick`` (+inf on
    approximate picks).  ``torch.roll`` wraps as ``jnp.roll`` does; the
    ``j >= d`` mask hides the wrapped columns.  Returns (p, d_pick)."""
    wb = queries.shape[0]
    wa = db.wa
    jcol = torch.arange(wb, device=queries.device)
    radius = int(round(int(db.off.shape[0]) ** 0.5)) // 2
    best_p, best_d = p, d_pick
    for d in range(1, radius + 1):
        pj = torch.roll(p, d)  # p[j - d] aligned at j
        si = pj // wa
        sj = pj % wa + d
        ok = (jcol >= d) & (sj < wa)
        cand = si * wa + sj.clamp(max=wa - 1)
        dc = ((row_fn(cand) - queries) ** 2).sum(dim=1)
        dc = dc.masked_fill(~ok, float("inf"))
        better = (dc <= d_app * kappa) & (dc < best_d)
        best_p = torch.where(better, cand, best_p)
        best_d = torch.where(better, dc, best_d)
    return best_p, best_d


def batched_scan_core(db: LevelDB, kappa_mult: float, approx_fn,
                      row_fn=None, afilt_fn=None):
    """The batched level scan given an approximate-match function (the JAX
    package's ``batched_scan_core``).  ``approx_fn(queries (wb, F)) ->
    (idx, d)`` is the pluggable match (``make_approx_fn``); ``row_fn`` /
    ``afilt_fn`` gather scoring-DB rows / A' values by index (default the
    rows-above DB and ``a_filt_flat``).

    Per scan row: the rows-above queries, the approximate match, the
    coherence candidates of the first ``n_rowsafe`` window offsets, the
    kappa rule, ``refine_passes`` left-propagation passes, then the row's
    (A' value, source index) written into the carry.  Returns (bp (Nb,)
    fp32, s (Nb,) int32, counts (2,) int64 = [coherence picks before the
    refinement, picks the refinement switched to a same-row candidate])."""
    nrs = db.n_rowsafe
    wb = db.wb
    dev = db.static_q.device
    if row_fn is None:
        row_fn = lambda i: db.db_rowsafe[i]
    if afilt_fn is None:
        afilt_fn = lambda i: db.a_filt_flat[i]
    nb = db.hb * wb
    bp = torch.zeros((nb,), dtype=_F32, device=dev)
    s = torch.zeros((nb,), dtype=torch.int64, device=dev)
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    kappa = torch.tensor(kappa_mult, dtype=_F32, device=dev)
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    for r in range(db.hb):
        rows = slice(r * wb, (r + 1) * wb)
        queries = _row_queries(db, r, bp, db.rowsafe)
        p_app, d_app = approx_fn(queries)
        # rows-above coherence candidates (positions known at row start)
        p_coh, d_coh, has_coh = _batched_coherence(
            db, queries, s[db.flat_idx[rows, :nrs]],
            db.valid[rows, :nrs] > 0, row_fn=row_fn)
        use_coh = has_coh & (d_coh <= d_app * kappa)
        p = torch.where(use_coh, p_coh, p_app.long())
        d_pick = torch.where(use_coh, d_coh, inf)
        for _ in range(db.refine_passes):
            p, d_pick = _left_refine(db, queries, p, d_pick, d_app, kappa,
                                     row_fn)
        bp[rows] = afilt_fn(p)
        s[rows] = p
        n_coh = use_coh.sum()
        counts += torch.stack([n_coh, (d_pick < inf).sum() - n_coh])
    return bp, s.to(torch.int32), counts


# ------------------------------------------------------------------ matcher


def resolve_match_mode(match_mode: str, a_rows: int) -> str:
    """Per-level anchor scan: "auto" packs at or above the crossover."""
    if match_mode == "auto":
        return ("exact_hi2_2p" if a_rows >= PACKED_CROSSOVER_ROWS
                else "exact_hi")
    return match_mode



class CudaMatcher(Matcher):
    """The port's matcher: every tensor on ``device`` (the card, or the CPU
    where every kernel runs its plain version).

    ``bf16_approx`` picks the form of the rowwise and batched approximate
    match: None runs the bf16 pass on the card and exact fp32 on the CPU
    (as the JAX package off a TPU); True runs the bf16 form on the CPU too
    (the kernel's plain version — the reference a card run is held
    against).  The card has no fp32 form: False there raises."""

    def __init__(self, params, device: torch.device,
                 bf16_approx: Optional[bool] = None):
        super().__init__(params)
        self.device = torch.device(device)
        if bf16_approx is False and self.device.type == "cuda":
            raise ValueError("the approximate match on the card is the bf16 "
                             "kernel; the fp32 form runs on the CPU only")
        self.bf16_approx = (self.device.type == "cuda" if bf16_approx is None
                            else bf16_approx)

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
        strategy = ("wavefront" if self.params.strategy == "auto"
                    else self.params.strategy)
        # JAX TpuMatcher.build_features steering: match_mode resolved per
        # level, then bf16_scoring switches the wavefront to scan_rescue
        # once the parity gate allows it on this device (a refused verdict
        # keeps the exact scan), then the pad mode of the resolved scan.
        # The other strategies score the rows-above DB (pad_full=False);
        # rowwise and batched scan its bf16 copy (``bf16_approx``).
        mode = resolve_match_mode(self.params.match_mode, ha * wa)
        rowsafe = None
        if strategy == "wavefront":
            if self.params.bf16_scoring and gate.bf16_gate_allows(
                    self.params, self.device):
                mode = "scan_rescue"
            pad_mode = PAD_MODES[mode]
        else:
            rowsafe = torch.from_numpy(rowsafe_mask(spec.fine_size)).to(
                self.device)
            pad_mode = ("bf16_uncentered" if strategy != "exact"
                        and self.bf16_approx else None)
        arrs = prepare_level_arrays(
            spec, self._t(job.a_src), self._t(job.a_filt),
            self._t(job.a_src_coarse), self._t(job.a_filt_coarse),
            self._t(job.b_src), self._t(job.b_src_coarse),
            self._t(job.b_filt_coarse), pad_mode=pad_mode, rowsafe=rowsafe,
            a_temporal=self._t(job.a_temporal),
            b_temporal=self._t(job.b_temporal))
        fsl = spec.fine_filt_slice
        level = dict(
            db=arrs["db"], static_q=arrs["static_q"],
            a_filt_flat=arrs["a_filt_flat"],
            fine_sqrtw=torch.from_numpy(spec.sqrt_weights()[fsl]).to(
                self.device),
            off=torch.from_numpy(
                window_offsets(spec.fine_size).astype(np.int64)).to(
                    self.device),
            db_pad=arrs["db_pad"], dbn_pad=arrs["dbn_pad"],
            feat_mean=arrs["feat_mean"], live_idx=arrs["live_idx"],
            db_live=arrs["db_live"], ha=ha, wa=wa, hb=hb, wb=wb,
            fine_start=fsl.start, match_mode=mode, db_pad2=arrs["db_pad2"],
            dbnh_pad=arrs["dbnh_pad"], strategy=strategy,
            db_sqnorm=arrs["db_sqnorm"])
        if strategy == "wavefront":
            diag = tuple(torch.from_numpy(sg.astype(np.int64)).to(self.device)
                         for sg in _diag_schedule_np(
                             hb, wb, spec.fine_size // 2 + 1))
            return LevelDB(
                diag=diag, scan_tile=(scan_tile_rows(arrs["db_pad"].shape[0])
                                      if pad_mode == "bf16" else 0),
                **level)
        flat_idx, valid, written = gather_maps_device(hb, wb, spec.fine_size,
                                                      self.device)
        return LevelDB(
            diag=(), db_rowsafe=arrs["db_rowsafe"],
            db_rowsafe_sqnorm=arrs["db_rowsafe_sqnorm"], flat_idx=flat_idx,
            valid=valid, written=written, rowsafe=rowsafe,
            n_rowsafe=(spec.fine_size // 2) * spec.fine_size,
            refine_passes=self.params.refine_passes, **level)

    def synthesize_level(self, db: LevelDB, job: LevelJob
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, Any]]:
        """Returns device-resident (bp (hb, wb), s (hb, wb)) plus stats;
        the coherence count stays a device scalar under "_n_coh" (and the
        batched strategy's refinement count under "_n_ref")."""
        t0 = time.perf_counter()
        hb, wb = job.b_shape
        stats: Dict[str, Any] = {
            "level": job.level,
            "db_rows": job.a_shape[0] * job.a_shape[1],
            "pixels": hb * wb,
            "backend": self.device.type,
            "strategy": db.strategy,
        }
        if db.strategy == "wavefront":
            bp, s, n_coh = wavefront_scan_core(
                db, job.kappa_mult, make_anchor_fn(db))
            stats["match_mode"] = db.match_mode
        elif db.strategy == "batched":
            bp, s, counts = batched_scan_core(db, job.kappa_mult,
                                              make_approx_fn(db))
            n_coh = counts[0]
            # picks the left-propagation refinement switched to a same-row
            # candidate, apart so coherence_ratio stays the oracle's stat
            stats["_n_ref"] = counts[1]
        else:
            run = _run_exact if db.strategy == "exact" else _run_rowwise
            bp, s, n_coh = run(db, job.kappa_mult)
        stats["_n_coh"] = n_coh
        # one wait per level (never inside the step loop): per-level ms is
        # the device's time, not the enqueue time
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        stats["ms"] = dt * 1e3
        stats["pixels_per_s"] = hb * wb / max(dt, 1e-9)
        return bp.reshape(hb, wb), s.reshape(hb, wb), stats

    def best_match(self, db: LevelDB, job: LevelJob, q: int,
                   bp_flat: np.ndarray, s_flat: np.ndarray
                   ) -> Tuple[int, float, bool]:
        """Single-pixel reference path (the JAX ``TpuMatcher.best_match``,
        a unit-test seam, not a fast path): the exact strategy's decision
        at pixel ``q`` given the B' values and source map so far.  Returns
        (source index, squared distance, coherence won)."""
        if db.flat_idx is None:
            # wavefront levels carry no gather maps (the scan computes its
            # window indices per step); this seam is per-pixel and cold
            flat_idx, valid, written = gather_maps_device(
                db.hb, db.wb, int(round(int(db.off.shape[0]) ** 0.5)),
                self.device)
            db = dataclasses.replace(db, flat_idx=flat_idx, valid=valid,
                                     written=written)
        bp = self._t(np.asarray(bp_flat, np.float32))
        s = torch.from_numpy(np.asarray(s_flat, np.int64)).to(self.device)
        qvec = _exact_qvec(db, q, bp)
        p_app, d_app = _exact_d_app(db, qvec)
        p_coh, d_coh, has_coh = _pixel_coherence(db, qvec, q, s)
        p_app, d_app = int(p_app), float(d_app)
        if bool(has_coh) and float(d_coh) <= d_app * job.kappa_mult:
            return int(p_coh), float(d_coh), True
        return p_app, d_app, False
