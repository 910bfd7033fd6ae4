"""Tie-audit: mechanically explain source-map mismatches between two runs
(a copy of the JAX package's ``utils/parity.py``, rewired to the port's own
modules).

For every level (coarsest first) and every pixel q with s_x[q] != s_y[q]:

1. rebuild BOTH runs' exact decision context at q — the full query vector
   (static B features + that run's coarse-level B' windows + the causal
   window of that run's B' plane; every causal value is final at decision
   time, so the final planes reconstruct it) and the causal source-map
   window (which generates the Ashikhmin candidates);
2. if the contexts differ, the mismatch is `ctx_diverged`: the consequence
   of an earlier divergence;
3. if the contexts are identical, re-score both picks in float64:
   - `tie_exact`: bit-equal cost (duplicate patches);
   - `tie_fp`: cost gap within ``tol`` of the score magnitude
     (||q||^2 + ||db_pick||^2), the kernels' fp resolution band;
   - `kappa_boundary`: the picks sit on different branches of the kappa
     rule because d_coh lies within the resolution band of
     d_app * kappa_mult;
   - `unexplained`: anything else — a real disparity, target count 0.
4. at a level where run X's full-DB anchor was the packed2k scan
   (``packed_levels``), an unexplained mismatch is replayed with that
   scan's own arithmetic: `packed_pick` (a part of `unexplained`, not
   beside it) if run X's pick is the decision the packed scores make on
   the shared query — a row whose packed2k score (``backends/cuda.py
   packed2k_scan``'s operands, their products summed exactly) lies within
   ``tol`` of the best, measured against the magnitude of that scan's own
   centered terms, kept against the coherence candidates by the kappa
   rule, or the coherence pick where one such row loses to it
   (``packed_replay``: each replayed pixel's gap below the best).  The
   packed scheme's resolution (~1e-5 of the uncentered score, more where
   centering makes a dark window's terms large) is wider than ``tol``: its
   near-ties resolve apart past the band, as the JAX package's own packed
   scan does.

Beside the JAX module's fields, the port's audit names the first
divergence (``first_divergence``: its level, pixel, kind and the two picks'
float64 gap relative to the score magnitude, the quantity ``tol`` bounds),
it replays the packed levels' unexplained mismatches (``packed_pick``),
and it audits a video call: ``temporal_prev`` and ``remap_anchor`` are the
call's own (``models/video.py``), so the DB and both runs' static queries
carry the temporal block (A' on the DB side, the previous frame's pyramid
on the query side, the same plane for both runs) and A's planes are
remapped against the clip's anchor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_analogies_tpu_torch.ops.features import (
    build_features_np,
    fine_gather_maps,
    spec_for_level,
    window_offsets,
)
from image_analogies_tpu_torch.ops.pyramid import build_pyramid_np

# queries per float64 product in the kappa-boundary pass (an (N, 32)
# float64 block: 256 MiB at N = 2^20)
AUDIT_CHUNK = 32
# DB rows per float64 block of the packed replay's scores
PACKED_ROWS = 65536
# replayed pixels the audit describes one by one (``packed_replay``)
PACKED_REPLAY_SHOWN = 16


def _packed2k_band(db: np.ndarray, live: np.ndarray, tol: float):
    """The packed2k scan of one level's DB (``db`` (N, F) float32, the
    query-live dims ``live``) as the card runs it: ``pack_wk``'s operands
    and ``packed2k_query_rows``' query rows, every bf16 product summed
    exactly in float64.  Its terms are those of the centered rows and
    queries, so its fp resolution is ``tol`` of their magnitude
    (||q_c||^2 + ||d_c||^2), not of the uncentered one the audit's band
    reads.  Returns ``band(queries (M, F) float32, picks (M,)) -> [(rows,
    short)]``: for each query the rows whose score lies within that band of
    the best (twice the score gap, a distance gap, at most ``tol`` of the
    magnitude), and the pick's gap below the best in the same unit."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import (
        pack_wk, packed2k_query_rows, packed_shift_and_halfnorm)
    from image_analogies_tpu_torch.ops.match import bf16_split3

    src = torch.from_numpy(np.ascontiguousarray(db, np.float32))
    live_t = torch.from_numpy(np.asarray(live, np.int64))
    shift, half_norm = packed_shift_and_halfnorm(src, live_t)
    wk, _ = pack_wk(src, shift, half_norm, live_t, src.shape[0])
    k = 4 * live_t.numel() + 3
    d_c = 2.0 * half_norm.double().numpy()  # ||d_c||^2 of every row

    def band(queries, picks):
        q_c = (torch.from_numpy(queries) - shift[None, :])[:, live_t]
        g1, g2, _ = bf16_split3(q_c)
        qa = packed2k_query_rows(g1.to(torch.bfloat16),
                                 g2.to(torch.bfloat16),
                                 wk.shape[1])[:, :k].double()
        scores = torch.cat([qa @ wk[r0:r0 + PACKED_ROWS, :k].double().T
                            for r0 in range(0, wk.shape[0], PACKED_ROWS)],
                           dim=1).numpy()
        q_n = (q_c.double() ** 2).sum(dim=1).numpy()
        out = []
        for s_m, qn, x in zip(scores, q_n, picks):
            best = int(np.argmax(s_m))
            mag = qn + np.maximum(d_c, d_c[best])
            gap = 2.0 * (s_m[best] - s_m) / mag
            out.append((np.nonzero(gap <= tol)[0], float(gap[x])))
        return out

    return band


def audit_source_map_mismatches(
    a: np.ndarray,
    ap: np.ndarray,
    b: np.ndarray,
    params,
    levels_x: Sequence[Tuple[np.ndarray, np.ndarray]],
    levels_y: Sequence[Tuple[np.ndarray, np.ndarray]],
    tol: float = 2e-6,
    *,
    temporal_prev: Optional[np.ndarray] = None,
    remap_anchor: Optional[np.ndarray] = None,
    packed_levels: Sequence[int] = (),
) -> Dict:
    """Audit run X (e.g. the port) against run Y (e.g. the oracle).

    ``levels_*``: per-level (bp, s) planes, FINEST FIRST (the
    ``create_image_analogy(..., keep_levels=True)`` layout; the cached
    oracle npz stores them as bp_l{i}/s_l{i}).  Inputs a/ap/b and params
    must be exactly those of the two runs, and so must ``temporal_prev``
    and ``remap_anchor`` (a video call's; both None otherwise).
    ``packed_levels``: the levels at which run X's anchor was the packed2k
    scan (``match_mode`` "exact_hi2_2p" in its stats), whose unexplained
    mismatches are replayed (``packed_pick``).  Returns per-level records
    and aggregate fractions (see the module docstring)."""
    from image_analogies_tpu_torch.models.analogy import _prep_planes

    a_src, b_src, a_filt, _, _ = _prep_planes(a, ap, b, params,
                                              remap_anchor=remap_anchor)
    levels = len(levels_x)
    if len(levels_y) != levels:
        raise ValueError(f"level count mismatch: {levels} vs {len(levels_y)}")

    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    b_src_pyr = build_pyramid_np(b_src, levels)
    temporal = params.temporal_weight > 0 and temporal_prev is not None
    prev_pyr = (build_pyramid_np(np.asarray(temporal_prev, np.float32),
                                 levels) if temporal else None)
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]

    per_level: List[Dict] = []
    total = {"mismatches": 0, "ctx_diverged": 0, "tie_exact": 0,
             "tie_fp": 0, "kappa_boundary": 0, "unexplained": 0,
             "packed_pick": 0}
    first_divergence_is_tie = None  # set at the coarsest mismatching level
    first_divergence = None
    max_fp_band = 0.0  # worst observed relative score gap among fp ties
    packed_replay: List[Dict] = []

    for level in range(levels - 1, -1, -1):  # coarsest -> finest (scan order)
        bp_x, s_x = levels_x[level]
        bp_y, s_y = levels_y[level]
        sx = np.asarray(s_x, np.int64).reshape(-1)
        sy = np.asarray(s_y, np.int64).reshape(-1)
        bx = np.asarray(bp_x, np.float32).reshape(-1)
        by = np.asarray(bp_y, np.float32).reshape(-1)
        hb, wb = np.asarray(bp_x).shape
        mism = np.nonzero(sx != sy)[0]
        rec = {"level": level, "pixels": hb * wb,
               "mismatches": int(mism.size)}
        if mism.size == 0:
            rec.update(ctx_diverged=0, tie_exact=0, tie_fp=0,
                       kappa_boundary=0, unexplained=0)
            per_level.append(rec)
            continue

        spec = spec_for_level(params, level, levels, src_channels,
                              temporal=temporal)
        coarse = level + 1 < levels
        db = build_features_np(
            spec, a_src_pyr[level], a_filt_pyr[level],
            a_src_pyr[level + 1] if coarse else None,
            a_filt_pyr[level + 1] if coarse else None,
            temporal_fine=a_filt_pyr[level] if temporal else None)

        def static_q_for(levels_run):
            return build_features_np(
                spec, b_src_pyr[level], None,
                b_src_pyr[level + 1] if coarse else None,
                np.asarray(levels_run[level + 1][0], np.float32)
                if coarse else None,
                temporal_fine=prev_pyr[level] if temporal else None)

        stat_x = static_q_for(levels_x)
        stat_y = static_q_for(levels_y)
        flat_idx, valid, written = fine_gather_maps(hb, wb, spec.fine_size)
        fsl = spec.fine_filt_slice
        sqrtw = spec.sqrt_weights()[fsl]

        win = flat_idx[mism]  # (M, nf) clipped causal window positions
        wr = written[mism] * sqrtw[None, :]
        qx = stat_x[mism].copy()
        qx[:, fsl] = bx[win] * wr
        qy = stat_y[mism].copy()
        qy[:, fsl] = by[win] * wr

        v = valid[mism] > 0
        s_ctx_eq = np.all((sx[win] == sy[win]) | ~v, axis=1)
        q_eq = np.all(qx == qy, axis=1)
        clean = q_eq & s_ctx_eq

        db64 = db.astype(np.float64)
        dbn64 = np.sum(db64 * db64, axis=1)
        dx = np.sum((db64[sx[mism]] - qx.astype(np.float64)) ** 2, axis=1)
        dy = np.sum((db64[sy[mism]] - qy.astype(np.float64)) ** 2, axis=1)
        dd = np.abs(dx - dy)
        # the kernels' score resolution is relative to the big terms of
        # dbn - 2 q.db, not to the (small) distance
        qn = np.sum(qx.astype(np.float64) ** 2, axis=1)
        scale = qn + np.maximum(dbn64[sx[mism]], dbn64[sy[mism]])
        tie_exact = clean & (dd == 0.0)
        tie_fp = clean & (dd > 0.0) & (dd <= tol * np.maximum(scale, 1e-12))
        hard = np.nonzero(clean & ~tie_exact & ~tie_fp)[0]

        band = dd[tie_fp] / np.maximum(scale[tie_fp], 1e-12)
        if band.size:
            max_fp_band = max(max_fp_band, float(band.max()))

        # remaining clean mismatches: recompute the full float64 decision
        # from the shared context — a branch flip at the kappa boundary is
        # legal when d_coh sits within resolution of d_app * kappa_mult
        kappa_boundary = np.zeros(mism.size, bool)
        # the coherence minimum of each hard mismatch (inf: no candidate)
        # and whether run X's pick attains it
        d_coh_of = np.full(mism.size, np.inf)
        x_is_coh = np.zeros(mism.size, bool)
        kappa_mult = params.kappa_factor(level) ** 2
        ha, wa = a_filt_pyr[level].shape[:2]
        off = window_offsets(spec.fine_size)
        # d_app of every hard mismatch: one float64 product per chunk of
        # queries (a product per query rereads the whole DB each time)
        d_app_hard = np.empty(hard.size)
        for c0 in range(0, hard.size, AUDIT_CHUNK):
            ks = hard[c0:c0 + AUDIT_CHUNK]
            d_all = db64 @ qx[ks].astype(np.float64).T
            d_all *= -2.0
            d_all += dbn64[:, None]  # + ||q||^2, argmin-invariant
            d_app_hard[c0:c0 + ks.size] = d_all.min(axis=0) + qn[ks]
        for k, d_app in zip(hard, d_app_hard):
            qv = qx[k].astype(np.float64)
            d_app = float(d_app)
            vk = v[k]
            rf = win[k][vk]
            o = off[vk]
            si = sx[rf] // wa - o[:, 0]
            sj = sx[rf] % wa - o[:, 1]
            inb = (si >= 0) & (si < ha) & (sj >= 0) & (sj < wa)
            if not inb.any():
                continue
            cand = (si[inb] * wa + sj[inb]).astype(np.int64)
            d_cand = np.sum((db64[cand] - qv[None, :]) ** 2, axis=1)
            d_coh = float(np.min(d_cand))
            d_coh_of[k] = d_coh
            x_is_coh[k] = bool(np.any((cand == sx[mism[k]])
                                      & (d_cand <= d_coh + tol * scale[k])))
            if abs(d_coh - d_app * kappa_mult) <= tol * scale[k] * max(
                    kappa_mult, 1.0):
                kappa_boundary[k] = True
        unexplained = clean & ~tie_exact & ~tie_fp & ~kappa_boundary

        # the packed level's unexplained mismatches, replayed with the
        # packed2k scan's own scores: run X's pick is a packed-band row the
        # kappa rule keeps against the coherence minimum, or that minimum
        # where a packed-band row loses to it
        packed_pick = np.zeros(mism.size, bool)
        replay = np.nonzero(unexplained)[0] if level in packed_levels else ()
        if len(replay):
            band = _packed2k_band(db, np.nonzero(spec.query_live_mask())[0],
                                  tol)
            for c0 in range(0, len(replay), AUDIT_CHUNK):
                ks = replay[c0:c0 + AUDIT_CHUNK]
                for k, (rows, short) in zip(ks, band(qx[ks], sx[mism[ks]])):
                    qv = qx[k].astype(np.float64)
                    d_rows = np.sum((db64[rows] - qv[None, :]) ** 2, axis=1)
                    slack = tol * scale[k] * max(kappa_mult, 1.0)
                    x = sx[mism[k]]
                    app = (x in rows and d_coh_of[k] >= kappa_mult
                           * float(d_rows[rows == x][0]) - slack)
                    coh = x_is_coh[k] and bool(np.any(
                        d_coh_of[k] <= kappa_mult * d_rows + slack))
                    packed_pick[k] = app or coh
                    if len(packed_replay) < PACKED_REPLAY_SHOWN:
                        packed_replay.append(dict(
                            level=level, pixel=int(mism[k]),
                            packed_gap=short, band_rows=int(rows.size),
                            coherence=bool(x_is_coh[k]),
                            packed_pick=bool(app or coh)))

        if first_divergence_is_tie is None:
            # scan-order-first mismatch at the coarsest mismatching level:
            # nothing can have diverged before it
            k = int(np.argmin(mism))
            first_divergence_is_tie = bool(tie_exact[k] or tie_fp[k]
                                           or kappa_boundary[k])
            kinds = (("ctx_diverged", ~clean), ("tie_exact", tie_exact),
                     ("tie_fp", tie_fp), ("kappa_boundary", kappa_boundary),
                     ("unexplained", unexplained))
            first_divergence = {
                "level": level, "pixel": int(mism[k]),
                "kind": next(name for name, m in kinds if m[k]),
                "rel_gap": float(dd[k] / max(scale[k], 1e-12)),
                "packed_pick": bool(packed_pick[k])}

        rec.update(
            ctx_diverged=int((~clean).sum()),
            tie_exact=int(tie_exact.sum()),
            tie_fp=int(tie_fp.sum()),
            kappa_boundary=int(kappa_boundary.sum()),
            unexplained=int(unexplained.sum()),
        )
        per_level.append(rec)
        for k in rec.keys() & total.keys():
            total[k] += rec[k]
        total["packed_pick"] += int(packed_pick.sum())

    m = max(total["mismatches"], 1)
    clean_n = (total["tie_exact"] + total["tie_fp"]
               + total["kappa_boundary"] + total["unexplained"])
    return {
        "per_level": per_level,
        **total,
        "mismatch_explained_by_ties": round(1.0 - total["unexplained"] / m,
                                            6),
        "clean_ctx_tie_fraction": round(
            (clean_n - total["unexplained"]) / max(clean_n, 1), 6),
        "first_divergence_is_tie": first_divergence_is_tie,
        "first_divergence": first_divergence,
        "max_fp_band": max_fp_band,
        "packed_replay": packed_replay,
        "tol": tol,
    }
