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
  kernel (``exact_hi``) or the bf16 lane-packed tensor-core scan
  (``exact_hi2_2p``), each followed by an exact fp32 re-score;
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
from image_analogies_tpu_torch.ops.match import (
    add_norm_lanes,
    argmin_l2,
    bf16_split3,
    packed_best,
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
    db_pad: torch.Tensor
    dbn_pad: Optional[torch.Tensor]  # (Npad,) fp32 row norms, +inf pads
    feat_mean: Optional[torch.Tensor]  # (Fp,) live-dim shift (packed)
    live_idx: Optional[torch.Tensor]  # (L,) int64 query-live columns
    db_live: Optional[torch.Tensor]  # (Na, L+2) [live | dead norm | A']
    ha: int
    wa: int
    hb: int
    wb: int
    fine_start: int
    match_mode: str  # resolved per level: "exact_hi" | "exact_hi2_2p"


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
    srcc = src - shift[None, :]
    h1, h2, r2 = bf16_split3(srcc[:, live])
    d1, d2, d3 = (x.to(torch.bfloat16) for x in (h1, h2, r2))
    dbnh = torch.full((npad,), float("inf"), dtype=_F32, device=src.device)
    dbnh[:n] = half_norm
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
    wavefront (``pad_full=True``, no bucketing), pad modes "f32" and
    "packed2".  Inputs are fp32 tensors on the target device; the dict keys
    mirror the JAX function's (``dbn_pad`` / ``dbnh_pad`` are 1-D here)."""
    if pad_mode not in ("f32", "packed2"):
        raise NotImplementedError(
            f"pad_mode {pad_mode!r} is not ported (ROADMAP Queue 2)")
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
        "a_filt_flat": a_filt.reshape(-1), "db_pad": None, "dbn_pad": None,
        "dbnh_pad": None, "feat_mean": None, "live_idx": None,
        "db_live": None,
    }
    if pad_mode == "packed2":
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
        wk, dbnh = pack_wk(db, shift, half_norm, live, npad)
        feat_mean = torch.zeros((fp,), dtype=_F32, device=dev)
        feat_mean[:f] = shift
        out.update(db_pad=wk, dbnh_pad=dbnh, feat_mean=feat_mean,
                   live_idx=live)
    else:
        db_pad = torch.zeros((npad, fp), dtype=_F32, device=dev)
        db_pad[:n, :f] = db
        dbn_pad = torch.full((npad,), float("inf"), dtype=_F32, device=dev)
        dbn_pad[:n] = db_sqnorm
        out.update(db_pad=db_pad, dbn_pad=dbn_pad)
    return out


# -------------------------------------------------------------- the anchor


def make_anchor_fn(db: LevelDB):
    """The wavefront's full-DB anchor: queries (M, F) -> (p_app (M,) int64,
    d_app (M,) fp32 EXACT squared distance, or None).

    - "exact_hi": ``argmin_l2`` (exact fp32 scores), then the fp32 re-score
      against the full DB row.
    - "exact_hi2_2p": the queries are centered on the live dims, split into
      bf16 q1 + q2 by bit mask and laid out as [q1|q1|1 1 1|q2|q1|0]
      against wk, so one ``packed_best`` dot gives
      q1.d1 + q1.d2 + q2.d1 + q1.d3 - ||d||^2/2 (the four largest terms of
      the 3x3 split product set).  The pick is clamped to a real row; its
      fp32 re-score is deferred (d_app None): the step takes it from the
      coherence block's ``db_live`` row gather, which fetches the pick's
      row anyway.
    """
    na = db.ha * db.wa
    if db.match_mode == "exact_hi2_2p":
        live = db.live_idx
        lw = int(live.numel())
        o2 = 2 * lw + 3
        kp = int(db.db_pad.shape[1])
        k_used = _round_up(o2 + 2 * lw, 16)
        f = int(db.static_q.shape[1])
        shift = db.feat_mean[:f]
        dev = db.db.device

        def anchor(queries):
            m = queries.shape[0]
            qc = queries - shift[None, :]
            g1, g2, _ = bf16_split3(qc[:, live])
            q1 = g1.to(torch.bfloat16)
            q2 = g2.to(torch.bfloat16)
            qa = torch.cat([
                q1, q1, torch.ones((m, 3), dtype=torch.bfloat16, device=dev),
                q2, q1,
                torch.zeros((m, kp - o2 - 2 * lw), dtype=torch.bfloat16,
                            device=dev)], dim=1)
            p, _ = packed_best(qa, db.db_pad, k_used)
            return torch.clamp(p.long(), max=na - 1), None

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
        mode = resolve_match_mode(self.params.match_mode, ha * wa)
        pad_mode = "packed2" if mode == "exact_hi2_2p" else "f32"
        arrs = prepare_level_arrays(
            spec, self._t(job.a_src), self._t(job.a_filt),
            self._t(job.a_src_coarse), self._t(job.a_filt_coarse),
            self._t(job.b_src), self._t(job.b_src_coarse),
            self._t(job.b_filt_coarse), pad_mode=pad_mode)
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
            fine_start=fsl.start, match_mode=mode)

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
