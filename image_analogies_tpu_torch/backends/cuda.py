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
  ``two_pass[_1p]``), each followed by an exact fp32 re-score; or, with
  ``ann_prefilter`` (``ann_rescue``), the two-stage matcher of
  ``ops/ann.py``: a PCA-projected prefilter over every row, then the exact
  fp32 re-score of its top-m slab;
- batched Ashikhmin coherence over the causal window (``_batched_coherence``);
- the kappa rule (Hertzmann §3.2 eq. 2);
- a scatter of (A' value, source index) into the carry.

**batched** (``batched_scan_core``): the causal window is cut to the rows
strictly above, for the queries, the DB (``db_rowsafe``) and the coherence
candidates, so a whole scan row resolves in one step: the approximate match
(``make_approx_fn``: one bf16 pass on the card, exact fp32 on the CPU,
or with ``ann_prefilter`` the two-stage matcher on both), rows-above
coherence, the kappa rule, then ``refine_passes`` vectorized
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

import contextlib
import dataclasses
import functools
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from image_analogies_tpu_torch.backends.base import LevelJob, Matcher
from image_analogies_tpu_torch.ops import _build
from image_analogies_tpu_torch.ops.features import (
    FeatureSpec,
    build_features_torch,
    causal_mask,
    window_offsets,
)
from image_analogies_tpu_torch.backends import gate
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.ops.ann import (
    ann_arrays,
    ann_project_db,
    ann_rescore_slab,
    ann_topm_candidates,
)
from image_analogies_tpu_torch.ops.match import (
    _lanes,
    _lex_lt,
    _packed2k_route,
    _packed3_route,
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
from image_analogies_tpu_torch.tune import buckets as tune_buckets
from image_analogies_tpu_torch.tune import geometry as tune_geometry
from image_analogies_tpu_torch.tune import resolve as tune_resolve
from image_analogies_tpu_torch.utils import devcache

_F32 = torch.float32

# match_mode="auto" switches to the packed scan at this many A rows.  The
# value is the JAX package's (backends/tpu.py _PACKED_CROSSOVER_ROWS),
# measured on a TPU; it decides which kernel runs and is due to be
# re-derived on the H100 (ROADMAP).  A constant, as in the JAX package:
# the launch geometry resolves through tune/resolve.py, the crossover
# does not.
PACKED_CROSSOVER_ROWS = 131072

# DB rows of the padded scan copies are a multiple of this
PAD_TILE = 256

# rescue breadth of the scan_rescue anchor: the exact fp32 re-score covers
# the top-T tile champions by scan score (the JAX package's _RESCUE_T)
_RESCUE_T = 8

# pad mode of the scan copy each resolved anchor mode reads (the modes a
# user selects; "ann_rescue", which ann_prefilter selects, reads none: the
# JAX package builds it the "f32" copy, which its anchor never reads)
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
    fields after ``scan_tile`` up to ``refine_passes`` serve the exact,
    rowwise and batched strategies; wavefront levels leave them at their
    defaults.
    ``lanes`` and ``lane_hb`` describe a lane run (``stack_lanes``)."""

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
    match_mode: str  # resolved per level (a key of PAD_MODES, or ann_rescue)
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
    # the number of lanes whose query side the fields above hold, and each
    # lane's real B height
    lanes: int = 1
    lane_hb: Tuple[int, ...] = ()
    # the level's launch geometry, resolved once (build_features); None:
    # resolved when the scan starts (``level_tune``)
    tune: Optional[tune_resolve.TuneConfig] = None
    # the two-stage ANN matcher's state (``ann_prefilter`` past its gate;
    # else None): the (F, Kp) PCA basis and the (F,) mean it centers on (a
    # sealed catalog artifact, or computed on the device), the projected
    # scoring DB (Npad, Kp) — the full DB for the wavefront, the rows-above
    # DB for batched, with a shape bucket's zero rows — and its (Npad,)
    # half squared norms
    ann_proj: Optional[torch.Tensor] = None
    ann_mean: Optional[torch.Tensor] = None
    ann_dbp: Optional[torch.Tensor] = None
    ann_dbnh: Optional[torch.Tensor] = None
    # a sharded level (``build_sharded_db``; ``db_shards`` or
    # ``data_shards`` > 1): the (data, db) mesh, and THIS rank's shard of
    # the scoring DB (R, Fp) fp32, its (R,) norms (+inf padding rows), A'
    # values and, packed, its (R, L+2) [live | dead norm | A'] rows; the
    # packed scan's K-wide weight shard rides ``db_pad`` and the global
    # centering shift ``feat_mean``.  ``db``, ``db_rowsafe``,
    # ``a_filt_flat`` and ``db_live`` are then 1-row placeholders
    # (``make_level_template``): no rank holds the whole DB.
    mesh: Any = None
    db_sharded: Optional[torch.Tensor] = None
    dbn_sharded: Optional[torch.Tensor] = None
    afilt_sharded: Optional[torch.Tensor] = None
    dblive_sharded: Optional[torch.Tensor] = None


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


def packed2k_scan(q1: torch.Tensor, q2: torch.Tensor, wk: torch.Tensor, *,
                  chunks_per_sm: int = tune_geometry.DEFAULT_CHUNKS_PER_SM,
                  ring_stages: int = tune_geometry.DEFAULT_RING_STAGES):
    """The exact_hi2_2p scan (``packed_best``'s packed2k form): the (M, Kp)
    bf16 query rows ``[q1|q1|1 1 1|q2|q1|0]`` against ``pack_wk``'s ``wk =
    [d1|d2|n1 n2 n3|d1|d3|0]``, so one dot gives q1.d1 + q1.d2 + q2.d1 +
    q1.d3 - ||d||^2/2, over the first ``k_used`` = 4L+3 rounded up to 16
    lanes.  ``q1``/``q2`` (M, L) bf16 are the bit-mask split of the
    centered live query dims.  Returns (idx (M,) int32, val (M,) fp32),
    the first maximum."""
    return packed_best(packed2k_query_rows(q1, q2, wk.shape[1]), wk,
                       _round_up(4 * q1.shape[1] + 3, 16),
                       chunks_per_sm=chunks_per_sm, ring_stages=ring_stages)


def packed2k_query_rows(q1: torch.Tensor, q2: torch.Tensor, kp: int
                        ) -> torch.Tensor:
    """(M, kp) bf16: the packed2k scan's query rows ``[q1|q1|1 1 1|q2|q1|0]``
    against ``pack_wk``'s ``[d1|d2|n1 n2 n3|d1|d3|0]``."""
    m, lw = q1.shape
    return torch.cat([
        q1, q1, torch.ones((m, 3), dtype=torch.bfloat16, device=q1.device),
        q2, q1,
        torch.zeros((m, kp - 4 * lw - 3), dtype=torch.bfloat16,
                    device=q1.device)], dim=1)


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
                        pad_tile: int = PAD_TILE, n_rows: int = 0):
    """The scan copy of the batched/rowwise approximate match on the card:
    the rows ``src`` (N, F) ROUNDED to bf16 (as JAX ``.astype``), not
    centered, lane-padded to (Npad, Fp) with Npad the first multiple of
    ``pad_tile`` at or past max(N, ``n_rows``), beside ``srcn`` — the exact
    fp32 norms of the UNROUNDED rows — with +inf on the padding rows.  (The
    "bf16" pad mode centers on the column mean first: rounding centered
    values gives other numbers.)  Returns (db_pad (Npad, Fp) bf16, dbn_pad
    (Npad,) fp32)."""
    n, f = src.shape
    fp = max(_round_up(f, 128), 128)
    npad = _round_up(max(n, n_rows), pad_tile)
    db_pad = torch.zeros((npad, fp), dtype=torch.bfloat16, device=src.device)
    db_pad[:n, :f] = src.to(torch.bfloat16)
    return db_pad, _inf_pad(srcn, npad)


def prepare_level_arrays(spec: FeatureSpec, a_src, a_filt, a_src_coarse,
                         a_filt_coarse, b_src, b_src_coarse, b_filt_coarse,
                         pad_mode: Optional[str] = "f32",
                         pad_tile: int = PAD_TILE,
                         rowsafe: Optional[torch.Tensor] = None,
                         a_temporal=None, b_temporal=None,
                         db_rows_pad: int = 0
                         ) -> Dict[str, Optional[torch.Tensor]]:
    """Torch counterpart of the JAX ``_prepare_level_arrays``.  With the
    spec's temporal block, ``a_temporal`` (A' at this level) fills it on
    the DB side and ``b_temporal`` (the previous output
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

    ``db_rows_pad`` (the DB-side shape bucket, ``tune/buckets.py``) grows
    the scan copy's padding rows to it: the copy has the first multiple of
    ``pad_tile`` at or past max(Na, ``db_rows_pad``) rows, every row past
    Na one that cannot win (+inf norms and half norms, ``_PAD_SCORE``
    norm lanes), at the end.  The fp32 DB, its norms and A' keep Na rows
    (the JAX function pads them too, for its jit programs; nothing here
    gathers past Na).  0 gives the unbucketed arrays, bit for bit.

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
    npad = _round_up(max(n, db_rows_pad), pad_tile)
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
        db_pad, dbn_pad = pad_bf16_uncentered(src, srcn, pad_tile,
                                              db_rows_pad)
        out.update(db_pad=db_pad, dbn_pad=dbn_pad)
    elif pad_mode == "f32":
        db_pad = torch.zeros((npad, fp), dtype=_F32, device=dev)
        db_pad[:n, :f] = src
        out.update(db_pad=db_pad, dbn_pad=_inf_pad(srcn, npad))
    return out


# ------------------------------------------------------- the sharded build


def packed_scan_eligible(match_mode: str, na_rows: int) -> bool:
    """THE steering predicate of the mesh's anchor scan (the JAX
    ``packed_scan_eligible``): "auto" packs at or above
    ``PACKED_CROSSOVER_ROWS``, an explicit exact_hi2_2p always packs, and
    every other mode (exact_hi2's three-pass set and the probe modes have
    no mesh scan) runs the fp32 argmin."""
    return (match_mode in ("auto", "exact_hi2_2p")
            and (match_mode != "auto" or na_rows >= PACKED_CROSSOVER_ROWS))


def build_sharded_db(spec: FeatureSpec, a_src, a_filt, a_src_coarse,
                     a_filt_coarse, a_temporal, rowsafe, mesh,
                     pad_full: bool, packed: bool = False):
    """THIS rank's shard of a level's scoring DB over the mesh's ``db``
    axis (the JAX ``build_sharded_db``), built from the full A planes
    (small) without building the full DB: shard r holds rows [r R, (r+1)
    R) of ``sharded_pad_geometry`` (R a multiple of ``PAD_TILE``, so every
    row keeps its single-card byte alignment), each bit-equal to its row
    of the single card's DB (``build_features_torch(rows=)``).  Batched
    (``pad_full`` False) masks the fine_filt block to the rows above.

    With ``packed`` (the wavefront's packed2k scan) also the K-wide weight
    shard ``pack_wk`` builds and the [live | dead norm | A'] rows.  Over
    two or more ``db`` shards the live-dim centering shift reduces over
    EVERY shard (one all_reduce of float64 column sums over the ``db``
    group), so scan scores are globally comparable and the all-reduce's
    ties go to the lowest global index; it may differ from the single
    card's fp32 ``mean`` by an ulp, which moves only near-tied packed
    scores.  One ``db`` shard (query-parallel, frame-sharded video) holds
    the whole DB and takes the single card's shift and half norms
    (``packed_shift_and_halfnorm``), so its scores are the single card's
    bits.

    Returns (dbp (R, Fp), dbnp (R,), afiltp (R,), wk, shift (Fp,), dbl);
    the last three None unless ``packed``."""
    from image_analogies_tpu_torch.parallel.mesh import all_reduce_sum
    from image_analogies_tpu_torch.parallel.sharded_match import \
        sharded_pad_geometry

    ha, wa = a_filt.shape[:2]
    na = ha * wa
    shards = mesh.shape["db"]
    npad, fp = sharded_pad_geometry(na, spec.total, shards, PAD_TILE)
    r_rows = npad // shards
    lo = mesh.rank_in("db") * r_rows
    rows = slice(min(lo, na), min(lo + r_rows, na))
    n = rows.stop - rows.start
    db = build_features_torch(spec, a_src, a_filt, a_src_coarse,
                              a_filt_coarse, temporal_fine=a_temporal,
                              rows=rows)
    if not pad_full:
        fsl = spec.fine_filt_slice
        db[:, fsl] = db[:, fsl] * rowsafe[None, :]
    dev = db.device
    f = spec.total
    af = a_filt.reshape(-1)[rows]
    dbp = torch.zeros((r_rows, fp), dtype=_F32, device=dev)
    dbp[:n, :f] = db
    afp = torch.zeros((r_rows,), dtype=_F32, device=dev)
    afp[:n] = af
    out = (dbp, _inf_pad((db * db).sum(dim=1), r_rows), afp)
    if not packed:
        return out + (None, None, None)
    live_np = np.nonzero(spec.query_live_mask())[0]
    dead_np = np.setdiff1d(np.arange(f), live_np)
    live = torch.from_numpy(live_np.astype(np.int64)).to(dev)
    dead = torch.from_numpy(dead_np.astype(np.int64)).to(dev)
    if mesh.group("db") is None:
        shift, half_norm = packed_shift_and_halfnorm(db, live)
    else:
        colsum = db[:, live].double().sum(dim=0)
        all_reduce_sum(colsum, mesh.group("db"))
        shift = torch.zeros((f,), dtype=_F32, device=dev)
        shift[live] = (colsum / na).float()
        srcc = db - shift[None, :]
        half_norm = 0.5 * (srcc * srcc).sum(dim=1)
    wk, _ = pack_wk(db, shift, half_norm, live, r_rows)
    dbl = torch.zeros((r_rows, live_np.size + 2), dtype=_F32, device=dev)
    dbl[:n] = torch.cat([db[:, live], (db[:, dead] ** 2).sum(dim=1)[:, None],
                         af[:, None]], dim=1)
    shiftp = torch.zeros((fp,), dtype=_F32, device=dev)
    shiftp[:f] = shift
    return out + (wk, shiftp, dbl)


def prepare_query_arrays(spec: FeatureSpec, b_src, b_src_coarse,
                         b_filt_coarse, b_temporal) -> torch.Tensor:
    """The query side of a level alone, (Nb, F) fp32: the sharded build
    makes its DB side in ``build_sharded_db`` and must not run
    ``prepare_level_arrays``, which builds the whole DB."""
    return build_features_torch(spec, b_src, None, b_src_coarse,
                                b_filt_coarse, temporal_fine=b_temporal)


def make_level_template(params, job: LevelJob, strategy: str,
                        match_mode: str, device) -> LevelDB:
    """The slim per-level LevelDB of the mesh step: the real query-side
    maps (the wavefront's anti-diagonal schedule, or batched's gather
    maps), weights and live columns, and a 1-row placeholder for every
    DB-sized field: the mesh step reads DB rows only through the sharded
    arrays, so no rank holds the whole DB.  The JAX function's, with the
    port's field set."""
    spec = job.spec
    hb, wb = job.b_shape
    ha, wa = job.a_shape
    p = spec.fine_size
    fsl = spec.fine_filt_slice
    z2 = torch.zeros((1, spec.total), dtype=_F32, device=device)
    z1 = torch.zeros((1,), dtype=_F32, device=device)
    level = dict(
        db=z2, static_q=z2, a_filt_flat=z1,
        fine_sqrtw=torch.from_numpy(spec.sqrt_weights()[fsl]).to(device),
        off=torch.from_numpy(window_offsets(p).astype(np.int64)).to(device),
        db_pad=None, dbn_pad=None, feat_mean=None,
        live_idx=torch.from_numpy(np.nonzero(spec.query_live_mask())[0]
                                  .astype(np.int64)).to(device),
        db_live=None, ha=ha, wa=wa, hb=hb, wb=wb, fine_start=fsl.start,
        match_mode=match_mode, strategy=strategy, db_sqnorm=z1)
    if strategy == "wavefront":
        return LevelDB(diag=tuple(
            torch.from_numpy(sg.astype(np.int64)).to(device)
            for sg in _diag_schedule_np(hb, wb, p // 2 + 1)), **level)
    flat_idx, valid, written = devcache.cached(
        ("gather_maps", hb, wb, p, str(device)),
        lambda: gather_maps_device(hb, wb, p, device), device)
    return LevelDB(
        diag=(), db_rowsafe=z2, db_rowsafe_sqnorm=z1, flat_idx=flat_idx,
        valid=valid, written=written,
        rowsafe=torch.from_numpy(rowsafe_mask(p)).to(device),
        n_rowsafe=(p // 2) * p, refine_passes=params.refine_passes, **level)


def slim_for_mesh(db: LevelDB) -> LevelDB:
    """The mesh step's template of a sharded level: the LevelDB without
    its query features and shard arrays, which the step takes as its own
    inputs (the JAX ``slim_for_mesh``; the DB-sized fields are already
    placeholders)."""
    z2 = torch.zeros((1, db.static_q.shape[1]), dtype=_F32,
                     device=db.static_q.device)
    return dataclasses.replace(
        db, static_q=z2, mesh=None, db_sharded=None, dbn_sharded=None,
        afilt_sharded=None, dblive_sharded=None, db_pad=None)


# -------------------------------------------------------------- the anchor


def scan_tile_rows(npad: int, cap_rows: int = 0) -> int:
    """Per-tile scan tile for a DB padded to ``npad`` rows
    (``tune/geometry.scan_tile_rows``): the largest power of two dividing
    npad, at most ``cap_rows`` (0: the resolved ``scan_tile_cap``,
    ``tune/resolve.py scan_tile``), then halved until there are >= 16
    tiles.  The tile is part of scan_rescue's result (it decides the
    rescue's candidates), so a bucketed DB (a larger npad) can change it."""
    if cap_rows:
        return tune_geometry.scan_tile_rows(npad, cap_rows)
    return tune_resolve.scan_tile(npad)


def level_tune(db: LevelDB) -> tune_resolve.TuneConfig:
    """The level's launch geometry: the config ``build_features`` resolved,
    or for a LevelDB built elsewhere (a test's) its key's resolution."""
    if db.tune is not None:
        return db.tune
    pad = PAD_MODES.get(db.match_mode) if db.strategy == "wavefront" else (
        "bf16_uncentered" if db.db_pad is not None else None)
    fp = int(db.db_pad.shape[1]) if db.db_pad is not None else int(
        db.static_q.shape[1])
    return tune_resolve.level_config(db.strategy, pad, fp, db.ha * db.wa)


def _lex_min(d: torch.Tensor, cand: torch.Tensor):
    """Per row, the lexicographic (distance, index) minimum over the
    columns of (d, cand) — order-free, so it equals the JAX package's
    column-by-column ``_lex_lt`` fold.  Returns (idx int64, d)."""
    bv = d.min(dim=1).values
    big = torch.iinfo(cand.dtype).max
    bi = torch.where(d == bv[:, None], cand,
                     torch.full_like(cand, big)).min(dim=1).values
    return bi, bv


def _two_stage_fn(db: LevelDB, scoring: torch.Tensor):
    """The two-stage ANN match against ``scoring`` (the full DB for the
    wavefront anchor, the rows-above DB for batched): queries (M, F) ->
    (idx (M,) int64, d (M,) the slab winner's exact fp32 distance)."""
    top_m = tune_resolve.ann_top_m()
    na = db.ha * db.wa

    def match(queries):
        cand = ann_topm_candidates(queries, db.ann_proj, db.ann_mean,
                                   db.ann_dbp, db.ann_dbnh, na, top_m)
        return ann_rescore_slab(queries, scoring, cand, na)

    return match


def make_anchor_fn(db: LevelDB):
    """The wavefront's full-DB anchor: queries (M, F) -> (p_app (M,) int64,
    d_app (M,) fp32 EXACT squared distance, or None).  In the JAX package's
    order (``backends/tpu.py make_anchor_fn``):

    - "ann_rescue": the two-stage matcher (``ops/ann.py``): the top
      ``ann_top_m`` rows by projected score, re-scored in exact fp32
      against the full DB, the lowest index winning a tie.  No kernel.

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
      [q1|q1|1 1 1|q2|q1|0] against wk so one ``packed2k_scan`` dot gives
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
    if mode == "ann_rescue" and db.ann_dbp is not None:
        return _two_stage_fn(db, db.db)

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
        if mode == "exact_hi2":
            live = db.live_idx
            shift = db.feat_mean[:f]

            def scan(qc):
                g1, g2, gr = bf16_split3(qc[:, live])
                p, _ = packed3_best(
                    g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                    gr.to(torch.bfloat16), db.db_pad, db.db_pad2,
                    db.dbnh_pad)
                return p

            def anchor(queries):
                p = scan(queries - shift[None, :])
                return torch.clamp(p.long(), max=na - 1), None
        else:
            scan = exact_scan_fn(db, True, db.db_pad)

            def anchor(queries):
                return torch.clamp(scan(queries)[0], max=na - 1), None

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

    scan = exact_scan_fn(db, False, db.db_pad, db.dbn_pad)

    def anchor(queries):
        p, _ = scan(queries)
        return p, ((db.db[p] - queries) ** 2).sum(dim=1)

    return anchor


def exact_scan_fn(db: LevelDB, packed: bool, scan_db: torch.Tensor,
                  scan_norm: Optional[torch.Tensor] = None):
    """The exact anchors' kernel pass over one scan copy of the DB: the
    level's own (``make_anchor_fn``) or a mesh rank's shard
    (``parallel/step.py``).  queries (M, F) -> (idx (M,) int64 into
    ``scan_db``, score (M,) fp32, the lower the better), the lowest index
    on ties; a padding row wins only in a copy that is all padding.

    - ``packed`` (exact_hi2_2p): the queries centered on ``feat_mean``'s
      live dims and split by bit mask into bf16 q1 + q2, then
      ``packed2k_scan`` over the K-wide ``scan_db``; the score is minus
      the scan value.
    - else (exact_hi): ``argmin_l2`` over the fp32 ``scan_db`` and its row
      norms ``scan_norm`` (+inf on padding rows)."""
    cfg = level_tune(db)  # the main path's two kernels' launch knobs
    if not packed:
        def scan(queries):
            p, score = argmin_l2(queries, scan_db, scan_norm,
                                 chunks_per_sm=cfg.chunks_per_sm)
            return p.long(), score

        return scan
    live = db.live_idx
    shift = db.feat_mean[:int(db.static_q.shape[1])]

    def scan(queries):
        g1, g2, _ = bf16_split3((queries - shift[None, :])[:, live])
        p, val = packed2k_scan(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                               scan_db, chunks_per_sm=cfg.chunks_per_sm,
                               ring_stages=cfg.ring_stages)
        return p.long(), -val

    return scan


# --------------------------------------------------------------- coherence


def _batched_coherence(db: LevelDB, queries, s_r, ok, p_app=None,
                       row_fn=None, gather=None, live_rows: bool = True):
    """Batched Ashikhmin candidates for M pixels (Hertzmann §3.2): for each
    query the candidates are {s(r) + (q - r)} over its first nc causal
    window positions r (``s_r`` (M, nc) source indices there, ``ok`` their
    base validity), scored in fp32 — against ``row_fn(cand)``, a gather of
    the scoring DB's rows (default the full DB; the rows-above DB for the
    batched strategy), or, with ``p_app`` (the anchor's deferred pick),
    with the pick appended as one more gathered column, so its exact
    re-score and A' value ride the same row gather: by the live/dead split
    d = sum_live (cf - q)^2 + dead norm over ``db_live`` rows.

    ``gather(cand, p_app) -> (rows (M, nc+1, C), p_app)`` replaces that
    gather (the mesh, ``parallel/step.py``: the rows of every shard and
    the anchor's global pick in one collective); its rows are ``db_live``
    rows, or with ``live_rows`` False full rows with their A' value as one
    more column (C = F + 1), each score summing a fresh contiguous copy of
    its rows as the single card's ``db.db[cand]`` gather does.

    Returns (p_coh, d_coh, has_coh), plus (d_app, af_coh, af_app, p_app)
    when ``p_app`` is given."""
    nc = s_r.shape[1]
    off_i = db.off[:nc, 0]
    off_j = db.off[:nc, 1]
    ha, wa = db.ha, db.wa
    ci = s_r // wa - off_i[None, :]
    cj = s_r % wa - off_j[None, :]
    ok = ok & (ci >= 0) & (ci < ha) & (cj >= 0) & (cj < wa)
    cand = ci.clamp(0, ha - 1) * wa + cj.clamp(0, wa - 1)
    if p_app is not None:
        if gather is None:
            cf = db.db_live[torch.cat([cand, p_app[:, None]], dim=1)]
        else:
            cf, p_app = gather(cand, p_app)
        if live_rows:
            q_live = queries[:, db.live_idx]
            lw = q_live.shape[1]
            dca = ((cf[..., :lw] - q_live[:, None, :]) ** 2).sum(dim=-1) \
                + cf[..., lw]  # (M, nc+1)
            dc, d_app = dca[:, :nc], dca[:, nc]
            af = cf[..., lw + 1]
        else:
            f = queries.shape[1]
            dc = ((cf[:, :nc, :f].contiguous() - queries[:, None, :]) ** 2
                  ).sum(dim=-1)
            d_app = ((cf[:, nc, :f].contiguous() - queries) ** 2).sum(dim=1)
            af = cf[..., f]
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
    return (p_coh, d_coh, has_coh, d_app, af.gather(1, k[:, None])[:, 0],
            af[:, nc], p_app)


# ------------------------------------------------------------ wavefront scan


def _per_lane(x: torch.Tensor, k: int,
              offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A segment's (T, M, ...) schedule tensor as (T, k M, ...): lane i's
    block of M rows is ``x`` (plus ``offsets[i]``)."""
    t, m = x.shape[:2]
    y = x[:, None].expand((t, k) + tuple(x.shape[1:]))
    if offsets is not None:
        y = y + offsets.view((1, k) + (1,) * (x.dim() - 1))
    return y.reshape((t, k * m) + tuple(x.shape[2:]))


def _gather_picks(p, use_coh, af, group):
    """The query-parallel step's reassembly: every data rank's slice of a
    diagonal's (pick, coherence flag, A' value), in rank order, by one
    all_gather of a (3, M/D) float64 tensor (exact for the fp32 values
    and the indices)."""
    from image_analogies_tpu_torch.parallel.mesh import all_gather_stack

    both = all_gather_stack(torch.stack([p.double(), use_coh.double(),
                                         af.double()]), group)
    both = both.permute(1, 0, 2).reshape(3, -1)
    return both[0].long(), both[1] > 0.5, both[2].float()


def wavefront_scan_core(db: LevelDB, kappa_mult: float, anchor_fn,
                        row_fn=None, afilt_fn=None, live_gather=None,
                        data_group=None, data_size: int = 1):
    """The oracle's raster-scan rule on the anti-diagonal schedule (see the
    module docstring; the dependency proof is in the JAX package's
    ``wavefront_scan_core``).

    Carry: B' values (fp32) and source indices (int64), each with
    ``M_max`` spare rows at the end — the schedule's padding lanes (-1)
    write to distinct spare rows ``nb + lane`` instead of being dropped, so
    the scatter needs no mask and no host sync.  The per-step window
    indices and masks depend only on the schedule, so each segment's are
    computed once, batched over its steps.

    Lanes (``db.lanes`` = k > 1, ``stack_lanes``): k targets of one shape
    share the schedule and lane 0's DB, and ``db.static_q`` holds the k
    lanes' query rows one lane after another.  Each step gathers the k
    lanes' M queries into one (k M, F) block: one anchor call, one
    coherence gather and one kappa rule serve every lane, and k = 1 is the
    singleton's step, op for op.  The carry holds a block of ``nb + M_max``
    rows per lane; the lane offsets go on the carry indices (window and
    write indices) only, so source-map values stay A indices.  M is a
    multiple of 8 (the schedule's padding), so each lane's block of every
    (k M, ...) step tensor starts at a multiple of 32 bytes and its rows
    keep the alignment they have in a singleton: the card's row sums round
    by a row's address.

    The mesh (``parallel/step.py``) reads DB rows only through its hooks,
    which replace the reads of the level's own arrays, each for an anchor
    that defers its re-score (d_app None) to the coherence gather
    (``_batched_coherence``): ``live_gather(cand, p_app)`` returns the
    ``db_live`` rows of the (M, nc) candidates and the pick, and the pick
    itself (the mesh resolves its global pick in the same collective);
    ``row_fn`` the same with [scoring row | A' value] rows (F + 1
    columns); ``afilt_fn(idx)`` gathers A' values where no gather carried
    them.
    With ``data_group`` (``data_size`` ranks, a power of two <= 8, so it
    divides every segment's 8-aligned width) the step is QUERY-PARALLEL:
    each data rank scores its M / D slice of every diagonal, then one
    all_gather reassembles the picks, so every rank's carry advances
    alike.  Per-query work reads no other query, so the picks are the
    unsplit step's.  With no hooks the step is what it was, op for op.

    Returns (bp (Nb,) fp32, s (Nb,) int32, n_coh () int64 device scalar);
    with k lanes (bp (k, Nb), s (k, Nb), n_coh (k,))."""
    k = db.lanes
    hb, wb = db.hb, db.wb
    nb = hb * wb
    max_rows = level_tune(db).wavefront_max_rows
    if db.ha * db.wa > max_rows:
        raise ValueError(
            f"the wavefront scan caps exemplars at {max_rows} A rows "
            f"(wavefront_max_rows, tune/resolve.py; the ceiling 2^24 is a "
            f"4096x4096 A); this A is {db.ha}x{db.wa}")
    if data_group is not None and (data_size & (data_size - 1)
                                   or data_size > 8 or k > 1):
        raise ValueError(
            f"query-parallel wavefront needs a power-of-two data axis "
            f"<= 8 (segment widths are 8-aligned) and one lane; got "
            f"{data_size} ranks, {k} lanes")
    dev = db.static_q.device
    nf = int(db.off.shape[0])
    nc = (nf - 1) // 2  # causal positions = the first nc raster offsets
    off_i = db.off[:nc, 0]
    off_j = db.off[:nc, 1]
    wsq_c = db.fine_sqrtw[:nc]
    fs = db.fine_start
    m_max = max(int(seg.shape[1]) for seg in db.diag)
    blk = nb + m_max  # a lane's carry rows
    bp = torch.zeros((k * blk,), dtype=_F32, device=dev)
    s = torch.zeros((k * blk,), dtype=torch.int64, device=dev)
    n_coh = torch.zeros((k,), dtype=torch.int64, device=dev)
    kappa = torch.tensor(kappa_mult, dtype=_F32, device=dev)
    lanes = torch.arange(m_max, dtype=torch.int64, device=dev)
    if k > 1:
        lane = torch.arange(k, dtype=torch.int64, device=dev)
        carry_off = lane * blk
        query_off = lane * (int(db.static_q.shape[0]) // k)
    if afilt_fn is None:
        afilt_fn = lambda i: db.a_filt_flat[i]
    gather = live_gather if row_fn is None else row_fn
    me = 0
    if data_group is not None:
        import torch.distributed as dist

        me = dist.get_rank(data_group)

    for seg in db.diag:
        n_steps, m = int(seg.shape[0]), int(seg.shape[1])
        # schedule-only quantities for every step of the segment
        lane_ok = seg >= 0  # (T, M)
        pixc = seg.clamp(min=0)
        if data_group is not None:  # this data rank's slice of each step
            mq = m // data_size
            pixc = pixc[:, me * mq:(me + 1) * mq]
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
        if k > 1:
            widx = _per_lane(widx, k, carry_off)
            wpix = _per_lane(wpix, k, carry_off)
            pixc = _per_lane(pixc, k, query_off)
            inb, wsq, lane_ok = (_per_lane(x, k) for x in (inb, wsq,
                                                           lane_ok))
        for t in range(n_steps):
            idx = widx[t]
            dyn = bp[idx] * wsq[t]
            s_r = s[idx]
            queries = db.static_q[pixc[t]]
            queries[:, fs:fs + nc] = dyn
            p_app, d_app = anchor_fn(queries)
            if d_app is None:  # the re-score rides the coherence gather
                p_coh, d_coh, has_coh, d_app, af_coh, af_app, p_app = \
                    _batched_coherence(db, queries, s_r, inb[t],
                                       p_app=p_app, gather=gather,
                                       live_rows=row_fn is None)
            else:
                p_coh, d_coh, has_coh = _batched_coherence(
                    db, queries, s_r, inb[t])
                af_coh = af_app = None
            use_coh = has_coh & (d_coh <= d_app * kappa)
            p = torch.where(use_coh, p_coh, p_app)
            af = (afilt_fn(p) if af_app is None
                  else torch.where(use_coh, af_coh, af_app))
            if data_group is not None:
                p, use_coh, af = _gather_picks(p, use_coh, af, data_group)
            bp.index_copy_(0, wpix[t], af)
            s.index_copy_(0, wpix[t], p)
            n_coh += (use_coh & lane_ok[t]).view(k, m).sum(dim=1)
    bp = bp.view(k, blk)[:, :nb]
    s = s.view(k, blk)[:, :nb].to(torch.int32)
    if k == 1:
        return bp[0], s[0], n_coh[0]
    return bp, s, n_coh


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
    (the JAX ``make_approx_fn``):

    - with the level's ANN state (batched with ``ann_prefilter``): the
      two-stage matcher (``ops/ann.py``) against ``db_rowsafe``, on the
      card and on the CPU alike; ``d`` is the slab winner's exact fp32
      distance.
    - with the level's bf16 scan copy (built on the card):
      ``prepadded_argmin_queries`` — one bf16 pass with fp32 accumulation
      (``argmin_l2_bf16``), the kernel precision the JAX package gives
      these strategies.  ``d`` is that pass's score plus ||q||^2: the kappa
      rule sees the scan's own distance, with no fp32 re-score.
    - without it (the CPU): the exact fp32 scores of ``argmin_l2_plain``,
      what the JAX package computes off the TPU.

    A card level without the scan copy raises: the card never runs the
    fp32 form in place of the kernel."""
    if db.ann_dbp is not None and db.strategy != "wavefront":
        return _two_stage_fn(db, db.db_rowsafe)
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


def lane_row_width(wb: int, lanes: int) -> int:
    """Columns a lane takes in a batched scan row: ``wb``, rounded up to a
    multiple of 8 when lanes share the row.  Each lane's block of a (k
    wbp, ...) row tensor then starts at a multiple of 32 bytes, so every
    row keeps the alignment it has in a singleton run (the card's row sums
    round by a row's address); the pad columns duplicate the lane's last
    column and write to carry rows nothing reads."""
    return wb if lanes == 1 else _round_up(wb, 8)


def _row_queries(db: LevelDB, r: int, bp: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(R, F) queries of scan row ``r``, R = wb (k lanes: k
    ``lane_row_width`` columns); ``mask`` picks which causal offsets
    contribute B' values (rowsafe for batched and rowwise)."""
    nf = int(db.off.shape[0])
    width = db.lanes * lane_row_width(db.wb, db.lanes)
    rows = slice(r * width, (r + 1) * width)
    queries = db.static_q[rows].clone()
    queries[:, db.fine_start:db.fine_start + nf] = (
        bp[db.flat_idx[rows]] * db.written[rows] * mask[None, :]
        * db.fine_sqrtw[None, :])
    return queries


def _left_refine(db: LevelDB, queries, p, d_pick, d_app, kappa, row_fn,
                 jcol: Optional[torch.Tensor] = None):
    """One vectorized left-propagation pass over a resolved row: the
    same-row candidates {s(j-d) + (0, d)}, d = 1..radius, from the row's
    current picks ``p``, each kept only if it passes the kappa rule against
    ``d_app`` and beats the current pick's distance ``d_pick`` (+inf on
    approximate picks).  ``torch.roll`` wraps as ``jnp.roll`` does; the
    ``j >= d`` mask hides the wrapped columns.  With k lanes in the row the
    roll moves each lane's last d columns into the next lane's first d, and
    ``jcol`` (each entry's column within its own lane; default ``arange``)
    masks exactly those.  Returns (p, d_pick)."""
    wa = db.wa
    if jcol is None:
        jcol = torch.arange(queries.shape[0], device=queries.device)
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
    package's ``batched_scan_core``).  ``approx_fn(queries (R, F)) ->
    (idx, d)`` is the pluggable match (``make_approx_fn``); ``row_fn`` /
    ``afilt_fn`` gather scoring-DB rows / A' values by index (default the
    rows-above DB and ``a_filt_flat``).

    Per scan row: the rows-above queries, the approximate match, the
    coherence candidates of the first ``n_rowsafe`` window offsets, the
    kappa rule, ``refine_passes`` left-propagation passes, then the row's
    (A' value, source index) written into the carry.  The row loop stops
    at ``db.hb``: rows past it (a query bucket's zero rows,
    ``CudaMatcher.build_features``) are never read.  Returns (bp (Nb,)
    fp32, s (Nb,) int32, counts (2,) int64 = [coherence picks before the
    refinement, picks the refinement switched to a same-row candidate]).

    Lanes (``db.lanes`` = k > 1, ``stack_lanes``): scan row r of every lane
    is one row of R = k ``lane_row_width`` entries — one approximate-match
    call and one refinement for all k — and k = 1 is the singleton's row,
    op for op.  The row loop runs to the tallest lane (``db.hb``); a
    shorter lane's rows past its own height read its zero rows and write
    carry rows that the crop drops, and ``counts`` leaves them out, as it
    leaves out the pad columns.  Returns the carry (hb R,) in row-major
    (row, lane, column) order and counts (k, 2)."""
    nrs = db.n_rowsafe
    k, wb = db.lanes, db.wb
    wbp = lane_row_width(wb, k)
    width = k * wbp
    dev = db.static_q.device
    if row_fn is None:
        row_fn = lambda i: db.db_rowsafe[i]
    if afilt_fn is None:
        afilt_fn = lambda i: db.a_filt_flat[i]
    n = db.hb * width
    bp = torch.zeros((n,), dtype=_F32, device=dev)
    s = torch.zeros((n,), dtype=torch.int64, device=dev)
    counts = torch.zeros((k, 2), dtype=torch.int64, device=dev)
    kappa = torch.tensor(kappa_mult, dtype=_F32, device=dev)
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    col = torch.arange(wbp, device=dev)
    jcol = col.repeat(k)
    live = None  # (hb, R) the entries the counts take: all without lanes
    hbs = db.lane_hb or (db.hb,)
    if wbp != wb or min(hbs) != db.hb:
        rows_of = torch.arange(db.hb, device=dev)[:, None, None]
        live = ((col < wb)[None, None, :]
                & (rows_of < torch.tensor(hbs, device=dev)[None, :, None])
                ).reshape(db.hb, width)
    for r in range(db.hb):
        rows = slice(r * width, (r + 1) * width)
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
                                     row_fn, jcol)
        bp[rows] = afilt_fn(p)
        s[rows] = p
        coh, picked = use_coh, d_pick < inf
        if live is not None:
            coh, picked = coh & live[r], picked & live[r]
        n_coh = coh.view(k, wbp).sum(dim=1)
        counts += torch.stack([n_coh, picked.view(k, wbp).sum(dim=1)
                               - n_coh], dim=1)
    s = s.to(torch.int32)
    if k == 1:
        return bp, s, counts[0]
    return bp, s, counts


def stack_lanes(dbs) -> LevelDB:
    """One LevelDB for a lane run of the members' level states ``dbs``:
    lane 0's DB — every member's A side is the same (the engine checks it)
    — with the query side of every lane (``lanes`` k, ``lane_hb`` each
    lane's real height).

    - wavefront: ``static_q`` is the lanes' query rows one lane after
      another (every lane has one shape);
    - batched: ``static_q``, ``flat_idx``, ``valid`` and ``written`` in
      scan-row order — row r holds each lane's ``lane_row_width`` columns
      in turn, for rows up to the tallest lane's height (a shorter lane's
      rows past its own come from its bucket's zero rows) — and
      ``flat_idx`` maps each lane's window to its carry rows in the same
      order (``batched_scan_core``)."""
    db0 = dbs[0]
    k = len(dbs)
    hbs = tuple(d.hb for d in dbs)
    if any(d.wb != db0.wb for d in dbs) or (
            db0.strategy == "wavefront" and len(set(hbs)) > 1):
        raise ValueError(f"lanes of shapes {[(d.hb, d.wb) for d in dbs]} "
                         "cannot share a scan")
    if db0.strategy == "wavefront":
        return dataclasses.replace(
            db0, static_q=torch.cat([d.static_q for d in dbs]), lanes=k,
            lane_hb=hbs)
    if db0.strategy != "batched":
        raise ValueError(f"strategy {db0.strategy!r} has no lanes")
    hb, wb = max(hbs), db0.wb
    wbp = lane_row_width(wb, k)
    if any(d.static_q.shape[0] < hb * wb for d in dbs):
        raise ValueError("lanes of different heights share a scan only "
                         "from one query bucket (shape_buckets)")
    dev = db0.static_q.device
    col = torch.arange(wbp, device=dev).clamp(max=wb - 1)
    src = (torch.arange(hb, device=dev)[:, None] * wb + col).view(-1)

    def rows(x):  # (hb wbp, C) lane rows -> interleaved with the others
        return torch.stack([t.view(hb, wbp, -1) for t in x],
                           dim=1).reshape(hb * k * wbp, -1)

    # a lane's pixel q = i wb + j sits at carry row i (k wbp) + lane wbp + j
    flat = [(d.flat_idx[src] // wb) * (k * wbp) + lane * wbp
            + d.flat_idx[src] % wb for lane, d in enumerate(dbs)]
    return dataclasses.replace(
        db0, hb=hb, lanes=k, lane_hb=hbs,
        static_q=rows([d.static_q[src] for d in dbs]), flat_idx=rows(flat),
        valid=rows([d.valid[src] for d in dbs]),
        written=rows([d.written[src] for d in dbs]))


# ------------------------------------------------------------------ matcher


def resolve_match_mode(match_mode: str, a_rows: int) -> str:
    """Per-level anchor scan: "auto" packs at or above the crossover."""
    if match_mode == "auto":
        return ("exact_hi2_2p" if a_rows >= PACKED_CROSSOVER_ROWS
                else "exact_hi")
    return match_mode


def _resolve_ann_projection(job: LevelJob):
    """This level's ANN basis through the catalog's sealed artifacts (the
    JAX ``_resolve_ann_projection``).  Returns one of:

    - ``("artifact", mean, proj)``: a sealed artifact loaded and verified;
    - ``("fresh",)``: no catalog root, or no artifact for this key: the
      basis is computed on the device (``ops/ann.py ann_arrays``);
    - ``("rebuild", root, key)``: an artifact existed but failed its seal
      and was quarantined (``.corrupt``): this level runs the exact matcher
      and the caller reseals the basis from the feature bytes, so the next
      request recovers the two-stage path.

    The key is the catalog's ``feature_key`` of the level's A side, the one
    ``ia catalog build`` seals under.  The chaos site ``match.prefilter``
    fires here; its ``corrupt`` directive flips one byte of the sealed
    artifact before the load (``catalog/ann.py damage_artifact``), so the
    quarantine, exact fallback and reseal run end to end."""
    from image_analogies_tpu_torch import chaos
    from image_analogies_tpu_torch.catalog import ann as catalog_ann
    from image_analogies_tpu_torch.catalog import tiers as catalog_tiers

    if not catalog_tiers.active():
        return ("fresh",)
    root_dir = catalog_tiers.root()
    key = catalog_tiers.feature_key(job.spec, job.a_src, job.a_filt,
                                    job.a_src_coarse, job.a_filt_coarse,
                                    job.a_temporal)
    path = catalog_ann.artifact_path(root_dir, key)
    directive = chaos.site("match.prefilter", level=job.level)
    if directive == "corrupt":
        catalog_ann.damage_artifact(path, seed=chaos.plan_seed() or 0)
    existed = os.path.exists(path)
    got = catalog_ann.load_artifact(root_dir, key)
    if got is not None:
        obs_metrics.inc("ann.artifact_hits")
        return ("artifact", got[0], got[1])
    if existed:
        return ("rebuild", root_dir, key)
    return ("fresh",)



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
        self._prefetch_stream: Optional[torch.cuda.Stream] = None

    def _t(self, x) -> Optional[torch.Tensor]:
        """A host plane (or a chained tensor) as fp32 on the matcher's
        device, through the content-keyed upload cache."""
        return devcache.device_put_cached(x, self.device)

    @property
    def _strategy(self) -> str:
        """The resolved strategy ("auto" is the wavefront)."""
        return ("wavefront" if self.params.strategy == "auto"
                else self.params.strategy)

    @property
    def _sharded(self) -> bool:
        """The JAX ``build_features``'s ``sharded`` predicate: the patch DB
        shards over ``db_shards``, and ``data_shards`` > 1 on one image is
        the query-parallel wavefront; both on the wavefront and batched
        strategies only."""
        strategy = self._strategy
        return ((self.params.db_shards > 1
                 or (self.params.data_shards > 1
                     and strategy == "wavefront"))
                and strategy in ("batched", "wavefront"))

    def _steer(self, job: LevelJob, sharded: Optional[bool] = None
               ) -> Tuple[str, str, Optional[bool]]:
        """(strategy, anchor mode, ann) of a level, the JAX
        ``TpuMatcher.build_features`` steering: match_mode resolved per
        level, then bf16_scoring switches the wavefront to scan_rescue once
        the parity gate allows it on this device (a refused verdict keeps
        the exact scan).  ``ann``: None without ``ann_prefilter``; True
        when the two-stage matcher's gate allows it for this (device,
        strategy), which then wins over bf16_scoring on the wavefront
        (``build_features`` still falls back for a quarantined artifact);
        False for a refused verdict or an unsupported strategy.  A sharded
        level (``_sharded``) scans with the packed2k kernel where
        ``packed_scan_eligible`` allows it and the fp32 argmin elsewhere,
        with neither gate consulted: ``ann`` is False where it was asked
        for.  ``sharded`` None: ``_sharded``."""
        strategy = self._strategy
        if self._sharded if sharded is None else sharded:
            packed = (strategy == "wavefront" and packed_scan_eligible(
                self.params.match_mode, job.a_shape[0] * job.a_shape[1]))
            return (strategy, "exact_hi2_2p" if packed else "exact_hi",
                    False if self.params.ann_prefilter else None)
        mode = resolve_match_mode(self.params.match_mode,
                                  job.a_shape[0] * job.a_shape[1])
        if (strategy == "wavefront" and self.params.bf16_scoring
                and gate.bf16_gate_allows(self.params, self.device)):
            mode = "scan_rescue"
        ann = None
        if self.params.ann_prefilter:
            ann = (strategy in ("wavefront", "batched")
                   and gate.ann_gate_allows(self.params, self.device,
                                            strategy))
        return strategy, mode, ann

    def _gather_maps(self, hb: int, wb: int, p: int):
        """``gather_maps_device`` memoized by shape in the upload cache
        (the JAX package's ``_gather_maps_device`` is cached the same
        way), so a prefetch can build a level's maps ahead of it."""
        return devcache.cached(("gather_maps", hb, wb, p, str(self.device)),
                               lambda: gather_maps_device(hb, wb, p,
                                                          self.device),
                               self.device)

    def kernel_libraries(self, job: LevelJob) -> Tuple[str, ...]:
        """The CUDA libraries (``ops/_build.py`` names) a level's scan
        launches on the card: its anchor mode's, or the approximate
        match's, by the kernels' own width rules.  A level the two-stage
        ANN matcher runs launches none (a level whose sealed basis turns
        out damaged runs exact and builds its library at first use)."""
        if self.device.type != "cuda":
            return ()
        strategy, mode, ann = self._steer(job)
        if ann:
            return ()
        if strategy != "wavefront":
            return ("argmin_bf16",) if (strategy != "exact"
                                         and self.bf16_approx) else ()
        lw = int(job.spec.query_live_mask().sum())
        if mode == "exact_hi2_2p":
            route = _packed2k_route(_round_up(4 * lw + 3, 16))
            return ("packed2k_best" if route == "packed_best" else route,)
        if mode == "exact_hi2":
            return (_packed3_route(_lanes(lw)),)
        return ({"exact_hi": "argmin_l2", "scan_rescue": "pertile_champions",
                 "scan_rescue_1p": "pertile_champions", "two_pass": "argmin2",
                 "two_pass_1p": "argmin2"}[mode],)

    def load_kernels(self, jobs) -> None:
        names = sorted({n for job in jobs for n in self.kernel_libraries(job)})
        if names:
            _build.preload(names)

    def prefetch_level(self, job: LevelJob) -> None:
        """Warm a FUTURE level's caches on a helper thread (the pipelined
        driver): its host planes into the upload cache, uploaded on a side
        stream of this matcher's (a hit from the main stream waits on the
        upload's event, ``utils/devcache.py``), and the wavefront's
        anti-diagonal schedule, or the other strategies' gather maps.
        ``build_features`` consults the same caches and recomputes on a
        miss, so a prefetch changes timing, never results.
        ``b_filt_coarse`` (the plane in flight) is never touched."""
        if self.device.type == "cuda":
            if self._prefetch_stream is None:
                self._prefetch_stream = torch.cuda.Stream(self.device)
            ctx = torch.cuda.stream(self._prefetch_stream)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            for plane in (job.a_src, job.a_filt, job.a_src_coarse,
                          job.a_filt_coarse, job.a_temporal, job.b_src,
                          job.b_src_coarse, job.b_temporal):
                if isinstance(plane, np.ndarray):
                    self._t(plane)
            hb, wb = job.b_shape
            p = job.spec.fine_size
            if self._strategy == "wavefront":
                _diag_schedule_np(hb, wb, p // 2 + 1)
            else:
                self._gather_maps(hb, wb, p)

    def build_features(self, job: LevelJob) -> LevelDB:
        """The level's state.  With shape buckets on (``tune/buckets.py``),
        the wavefront's and batched's scan copies pad their DB rows to
        ``bucket_rows(ha*wa)`` (``prepare_level_arrays db_rows_pad``) and
        batched pads its query side to ``bucket_rows(hb*wb)``.  The level's
        launch geometry resolves once here, after the upload (so a card
        run's key names the card), keyed by the strategy, the pad mode,
        the scan copy's width and the DB rows' bucket, and rides on the
        ``LevelDB``.

        Bucketing keeps every pick of the exact and packed anchors, whose
        pad rows cannot win.  scan_rescue's tile (``scan_tile_rows``)
        depends on the padded row count, so there bucketing can change the
        rescue's candidates: that mode's bucketed run is held to the JAX
        package's bucketed run, not to an unbucketed one.

        With ``ann_prefilter`` past its gate the level's basis resolves
        through the catalog (``_resolve_ann_projection``), the wavefront
        runs ``ann_rescue`` and batched the two-stage approximate match,
        neither with a scan copy (``_ann_state``); a quarantined artifact
        runs the level exact and reseals it (``ann.fallback_exact``,
        ``ann.artifacts_rebuilt``), and so does a refused or unsupported
        request (``ann.fallback_exact``)."""
        spec = job.spec
        ha, wa = job.a_shape
        hb, wb = job.b_shape
        # the pad mode of the resolved scan: the wavefront's anchor mode's;
        # the other strategies score the rows-above DB (pad_full=False),
        # rowwise and batched scan its bf16 copy (``bf16_approx``)
        strategy, mode, ann = self._steer(job)
        ann_plan = _resolve_ann_projection(job) if ann else None
        if ann is False or (ann_plan is not None
                            and ann_plan[0] == "rebuild"):
            obs_metrics.inc("ann.fallback_exact")
        if self._sharded:
            return self.build_mesh_level(job)
        use_ann = ann_plan is not None and ann_plan[0] != "rebuild"
        if use_ann and strategy == "wavefront":
            mode = "ann_rescue"
        rowsafe = None
        if strategy == "wavefront":
            pad_mode = None if mode == "ann_rescue" else PAD_MODES[mode]
        else:
            rowsafe = torch.from_numpy(rowsafe_mask(spec.fine_size)).to(
                self.device)
            pad_mode = ("bf16_uncentered" if strategy != "exact"
                        and self.bf16_approx and not use_ann else None)
        buckets = tune_buckets.buckets_enabled(self.params)
        # the DB-side bucket (the JAX package's db_rows_pad): wavefront and
        # batched only, as there
        db_rows_pad = (tune_buckets.bucket_rows(ha * wa) if buckets and
                       strategy in ("wavefront", "batched") else 0)
        arrs = prepare_level_arrays(
            spec, self._t(job.a_src), self._t(job.a_filt),
            self._t(job.a_src_coarse), self._t(job.a_filt_coarse),
            self._t(job.b_src), self._t(job.b_src_coarse),
            self._t(job.b_filt_coarse), pad_mode=pad_mode, rowsafe=rowsafe,
            a_temporal=self._t(job.a_temporal),
            b_temporal=self._t(job.b_temporal), db_rows_pad=db_rows_pad)
        db_pad = arrs["db_pad"]
        cfg = tune_resolve.level_config(
            strategy, pad_mode, int(db_pad.shape[1]) if db_pad is not None
            else int(arrs["static_q"].shape[1]), ha * wa)
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
            db_sqnorm=arrs["db_sqnorm"], tune=cfg)
        if ann_plan is not None:
            level.update(self._ann_state(
                job, strategy, ann_plan,
                arrs["db"] if strategy == "wavefront" else arrs["db_rowsafe"],
                db_rows_pad))
        if strategy == "wavefront":
            diag = tuple(torch.from_numpy(sg.astype(np.int64)).to(self.device)
                         for sg in _diag_schedule_np(
                             hb, wb, spec.fine_size // 2 + 1))
            return LevelDB(
                diag=diag, scan_tile=(
                    scan_tile_rows(int(db_pad.shape[0]), cfg.scan_tile_cap)
                    if pad_mode == "bf16" else 0),
                **level)
        flat_idx, valid, written = self._gather_maps(hb, wb, spec.fine_size)
        if strategy == "batched" and buckets:
            # the query-side bucket (the JAX package's q_rows_pad): zero
            # rows up to the bucket, which no real row reads (the row loop
            # stops at the real hb); fresh tensors, the cached maps stay
            grow = tune_buckets.bucket_rows(hb * wb) - hb * wb
            level["static_q"], flat_idx, valid, written = (
                torch.cat([x, x.new_zeros((grow,) + tuple(x.shape[1:]))])
                for x in (level["static_q"], flat_idx, valid, written))
        return LevelDB(
            diag=(), db_rowsafe=arrs["db_rowsafe"],
            db_rowsafe_sqnorm=arrs["db_rowsafe_sqnorm"], flat_idx=flat_idx,
            valid=valid, written=written, rowsafe=rowsafe,
            n_rowsafe=(spec.fine_size // 2) * spec.fine_size,
            refine_passes=self.params.refine_passes, **level)

    def build_mesh_level(self, job: LevelJob) -> LevelDB:
        """A sharded level (the JAX ``build_features``'s mesh branch, and
        each level of the frame-sharded video): the template
        (``make_level_template``), this rank's DB shard
        (``build_sharded_db``; packed where ``packed_scan_eligible``
        allows the packed2k scan) and the query side of ``job``
        (``prepare_query_arrays``).  Neither shape buckets nor the gates
        apply.  The level's launch geometry resolves on the shard's
        rows."""
        from image_analogies_tpu_torch.parallel.mesh import make_mesh

        spec = job.spec
        strategy, mode, _ = self._steer(job, sharded=True)
        mesh = make_mesh(db_shards=self.params.db_shards,
                         data_shards=self.params.data_shards)
        template = make_level_template(self.params, job, strategy, mode,
                                       self.device)
        packed = mode == "exact_hi2_2p"
        dbp, dbnp, afp, wk, shift, dbl = build_sharded_db(
            spec, self._t(job.a_src), self._t(job.a_filt),
            self._t(job.a_src_coarse), self._t(job.a_filt_coarse),
            self._t(job.a_temporal), template.rowsafe, mesh,
            strategy == "wavefront", packed=packed)
        static_q = prepare_query_arrays(
            spec, self._t(job.b_src), self._t(job.b_src_coarse),
            self._t(job.b_filt_coarse), self._t(job.b_temporal))
        pad = ("packed2" if packed else "f32" if strategy == "wavefront"
               else "bf16_uncentered" if self.bf16_approx else None)
        cfg = tune_resolve.level_config(
            strategy, pad, int((wk if packed else dbp).shape[1]),
            int(dbp.shape[0]))
        return dataclasses.replace(
            template, static_q=static_q, mesh=mesh, db_sharded=dbp,
            dbn_sharded=dbnp, afilt_sharded=afp, dblive_sharded=dbl,
            db_pad=wk, feat_mean=shift, tune=cfg)

    def _ann_state(self, job: LevelJob, strategy: str, plan, src,
                   db_rows_pad: int) -> Dict[str, torch.Tensor]:
        """The level's ANN fields from its resolved plan, over the scoring
        DB ``src`` grown with zero rows to ``db_rows_pad`` (a shape bucket,
        as the JAX package pads its fp32 DB; stage 1 masks them):

        - "artifact": ``src`` projected through the sealed basis;
        - "fresh": the basis computed on the device (``ann_arrays``,
          ``ann.projection_built``);
        - "rebuild": the basis rebuilt in float64 on the host from the
          feature bytes and resealed (``ann.artifacts_rebuilt``); the level
          runs exact, so no fields.

        Each two-stage level counts ``ann.prefilter_used``, sets the
        ``ann.top_m`` and ``ann.proj_dims`` gauges and emits one
        ``ann_prefilter`` record."""
        from image_analogies_tpu_torch.catalog import ann as catalog_ann

        grow = db_rows_pad - int(src.shape[0])
        if grow > 0:
            src = torch.cat([src, src.new_zeros((grow, src.shape[1]))])
        if plan[0] == "rebuild":
            mean_np, proj_np = catalog_ann.build_projection(
                src.cpu().numpy(), tune_resolve.ann_proj_dims())
            catalog_ann.save_artifact(plan[1], plan[2], mean_np, proj_np)
            obs_metrics.inc("ann.artifacts_rebuilt")
            return {}
        if plan[0] == "artifact":
            mean = torch.from_numpy(plan[1]).to(self.device)
            proj = torch.from_numpy(plan[2]).to(self.device)
            dbp, dbnh = ann_project_db(src, mean, proj)
        else:
            mean, proj, dbp, dbnh = ann_arrays(
                src, tune_resolve.ann_proj_dims())
            obs_metrics.inc("ann.projection_built")
        top_m = tune_resolve.ann_top_m()
        kp = int(proj.shape[1])
        obs_metrics.inc("ann.prefilter_used")
        obs_metrics.set_gauge("ann.top_m", top_m)
        obs_metrics.set_gauge("ann.proj_dims", kp)
        obs_trace.emit_record(
            {"event": "ann_prefilter", "level": job.level,
             "strategy": strategy, "source": plan[0], "top_m": top_m,
             "proj_dims": kp, "db_rows": int(src.shape[0])})
        return dict(ann_proj=proj, ann_mean=mean, ann_dbp=dbp,
                    ann_dbnh=dbnh)

    def _scan(self, db: LevelDB, kappa_mult: float):
        """The level's strategy on ``db`` (k = ``db.lanes``): (bp, s, n_coh
        (k,), n_ref (k,) or None, stats of every lane), with bp and s as
        the strategy's core returns them."""
        stats: Dict[str, Any] = {"backend": self.device.type,
                                 "strategy": db.strategy}
        n_ref = None
        if db.mesh is not None:
            from image_analogies_tpu_torch.parallel.step import \
                multichip_level_step

            bp, s, counts = multichip_level_step(
                db.mesh, db.static_q[None], db.db_sharded, db.dbn_sharded,
                db.afilt_sharded, slim_for_mesh(db), kappa_mult,
                wk_shard=db.db_pad, dbl_shard=db.dblive_sharded,
                bf16_approx=self.bf16_approx)
            bp, s, n_coh = bp[0], s[0], counts[:, 0]
            if db.strategy == "batched":
                n_ref = counts[:, 1]
            else:
                stats["match_mode"] = db.match_mode
            stats["mesh"] = dict(db.mesh.shape)
        elif db.strategy == "wavefront":
            bp, s, n_coh = wavefront_scan_core(db, kappa_mult,
                                               make_anchor_fn(db))
            stats["match_mode"] = db.match_mode
        elif db.strategy == "batched":
            bp, s, counts = batched_scan_core(db, kappa_mult,
                                              make_approx_fn(db))
            counts = counts.view(db.lanes, 2)
            # picks the left-propagation refinement switched to a same-row
            # candidate, apart so coherence_ratio stays the oracle's stat
            n_coh, n_ref = counts[:, 0], counts[:, 1]
        else:
            run = _run_exact if db.strategy == "exact" else _run_rowwise
            bp, s, n_coh = run(db, kappa_mult)
        return bp, s, n_coh.view(db.lanes), n_ref, stats

    def _timed(self, t0: float, stats_list) -> None:
        """Each lane's level wall from ``t0``: with ``level_sync`` (or
        retries) one wait for the device, then ``ms`` and ``pixels_per_s``
        (of the lane's own pixels); else the enqueue time, named for what
        it is."""
        if self.params.level_sync or self.params.level_retries > 0:
            # one wait per level (never inside the step loop): per-level
            # ms is the device's time, not the enqueue time; retries need
            # the wait too (a fault must surface inside the retry wrapper,
            # not at the final fetch)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            dt = time.perf_counter() - t0
            for stats in stats_list:
                stats["ms"] = dt * 1e3
                stats["pixels_per_s"] = stats["pixels"] / max(dt, 1e-9)
        else:
            # only enqueued: the level's device work overlaps the host
            # work of the next
            dt = time.perf_counter() - t0
            for stats in stats_list:
                stats["enqueue_ms"] = dt * 1e3

    def synthesize_level(self, db: LevelDB, job: LevelJob
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, Any]]:
        """Returns device-resident (bp (hb, wb), s (hb, wb)) plus stats;
        the coherence count stays a device scalar under "_n_coh" (and the
        batched strategy's refinement count under "_n_ref")."""
        t0 = time.perf_counter()
        hb, wb = job.b_shape
        bp, s, n_coh, n_ref, scan_stats = self._scan(db, job.kappa_mult)
        stats: Dict[str, Any] = {
            "level": job.level,
            "db_rows": job.a_shape[0] * job.a_shape[1],
            "pixels": hb * wb,
            **scan_stats,
        }
        if n_ref is not None:
            stats["_n_ref"] = n_ref[0]
        stats["_n_coh"] = n_coh[0]
        self._timed(t0, [stats])
        return bp.reshape(hb, wb), s.reshape(hb, wb), stats

    def synthesize_level_lanes(self, dbs, jobs):
        """The lane twin of ``synthesize_level`` (``batch/engine.py``; the
        JAX package's ``TpuMatcher.synthesize_level_lanes``): k members'
        level states ``dbs`` (from ``build_features``; the same A side, the
        engine checks it) and their LevelJobs run as ONE scan
        (``stack_lanes``), so each wavefront step or scan row makes one
        anchor or approximate-match launch for every lane.  Returns per
        lane (bp (hb, wb), s (hb, wb), stats), cropped to the member's real
        shape; each stats dict carries ``lanes`` (k), the run's wall as
        ``ms`` (or ``enqueue_ms`` with ``level_sync=False``) and the lane's
        ``_n_coh`` (and ``_n_ref``, batched) as device scalars.  The kernel
        wrappers count one launch a call, so a k-lane run counts what one
        singleton does.  On the CPU the plain versions take the k lanes'
        rows in one call too: their products round each row as at a
        singleton's M (``tests/test_torch_batch.py`` holds every lane to
        its singleton's bits there)."""
        if dbs[0].mesh is not None:
            raise ValueError("a sharded level (db_shards or data_shards > 1) "
                             "has no lane scan")
        t0 = time.perf_counter()
        k = len(dbs)
        db = stack_lanes(dbs)
        bp, s, n_coh, n_ref, scan_stats = self._scan(db, jobs[0].kappa_mult)
        if db.strategy == "wavefront":
            planes = lambda x, i, hb, wb: x[i].view(hb, wb)
        else:
            wbp = lane_row_width(db.wb, k)
            planes = lambda x, i, hb, wb: x.view(db.hb, k, wbp)[
                :hb, i, :wb].contiguous()
        outs = []
        for i, job in enumerate(jobs):
            hb, wb = job.b_shape
            stats: Dict[str, Any] = {
                "level": job.level,
                "db_rows": job.a_shape[0] * job.a_shape[1],
                "pixels": hb * wb,
                **scan_stats,
                "lanes": k,
                "_n_coh": n_coh[i],
            }
            if n_ref is not None:
                stats["_n_ref"] = n_ref[i]
            outs.append((planes(bp, i, hb, wb), planes(s, i, hb, wb),
                         stats))
        self._timed(t0, [st for _, _, st in outs])
        return outs

    def best_match(self, db: LevelDB, job: LevelJob, q: int,
                   bp_flat: np.ndarray, s_flat: np.ndarray
                   ) -> Tuple[int, float, bool]:
        """Single-pixel reference path (the JAX ``TpuMatcher.best_match``,
        a unit-test seam, not a fast path): the exact strategy's decision
        at pixel ``q`` given the B' values and source map so far.  Returns
        (source index, squared distance, coherence won)."""
        if db.mesh is not None:
            raise ValueError(
                "best_match reads the per-rank DB arrays, which are 1-row "
                "placeholders when the DB is sharded; use synthesize_level "
                "(the mesh step) or build with db_shards=1")
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
