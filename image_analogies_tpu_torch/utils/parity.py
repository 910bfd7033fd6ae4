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
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from image_analogies_tpu_torch.ops.features import (
    build_features_np,
    fine_gather_maps,
    spec_for_level,
    window_offsets,
)
from image_analogies_tpu_torch.ops.pyramid import build_pyramid_np


def audit_source_map_mismatches(
    a: np.ndarray,
    ap: np.ndarray,
    b: np.ndarray,
    params,
    levels_x: Sequence[Tuple[np.ndarray, np.ndarray]],
    levels_y: Sequence[Tuple[np.ndarray, np.ndarray]],
    tol: float = 2e-6,
) -> Dict:
    """Audit run X (e.g. the port) against run Y (e.g. the oracle).

    ``levels_*``: per-level (bp, s) planes, FINEST FIRST (the
    ``create_image_analogy(..., keep_levels=True)`` layout; the cached
    oracle npz stores them as bp_l{i}/s_l{i}).  Inputs a/ap/b and params
    must be exactly those of the two runs.  Returns per-level records and
    aggregate fractions (see the module docstring)."""
    from image_analogies_tpu_torch.models.analogy import _prep_planes

    a_src, b_src, a_filt, _, _ = _prep_planes(a, ap, b, params)
    levels = len(levels_x)
    if len(levels_y) != levels:
        raise ValueError(f"level count mismatch: {levels} vs {len(levels_y)}")

    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    b_src_pyr = build_pyramid_np(b_src, levels)
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]

    per_level: List[Dict] = []
    total = {"mismatches": 0, "ctx_diverged": 0, "tie_exact": 0,
             "tie_fp": 0, "kappa_boundary": 0, "unexplained": 0}
    first_divergence_is_tie = None  # set at the coarsest mismatching level
    max_fp_band = 0.0  # worst observed relative score gap among fp ties

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

        spec = spec_for_level(params, level, levels, src_channels)
        coarse = level + 1 < levels
        db = build_features_np(
            spec, a_src_pyr[level], a_filt_pyr[level],
            a_src_pyr[level + 1] if coarse else None,
            a_filt_pyr[level + 1] if coarse else None)

        def static_q_for(levels_run):
            return build_features_np(
                spec, b_src_pyr[level], None,
                b_src_pyr[level + 1] if coarse else None,
                np.asarray(levels_run[level + 1][0], np.float32)
                if coarse else None)

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
        kappa_mult = params.kappa_factor(level) ** 2
        ha, wa = a_filt_pyr[level].shape[:2]
        off = window_offsets(spec.fine_size)
        for k in hard:
            qv = qx[k].astype(np.float64)
            d_all = dbn64 - 2.0 * (db64 @ qv)  # + ||q||^2, argmin-invariant
            d_app = float(d_all.min() + qn[k])
            vk = v[k]
            rf = win[k][vk]
            o = off[vk]
            si = sx[rf] // wa - o[:, 0]
            sj = sx[rf] % wa - o[:, 1]
            inb = (si >= 0) & (si < ha) & (sj >= 0) & (sj < wa)
            if not inb.any():
                continue
            cand = (si[inb] * wa + sj[inb]).astype(np.int64)
            d_coh = float(np.min(np.sum(
                (db64[cand] - qv[None, :]) ** 2, axis=1)))
            if abs(d_coh - d_app * kappa_mult) <= tol * scale[k] * max(
                    kappa_mult, 1.0):
                kappa_boundary[k] = True
        unexplained = clean & ~tie_exact & ~tie_fp & ~kappa_boundary

        if first_divergence_is_tie is None:
            # scan-order-first mismatch at the coarsest mismatching level:
            # nothing can have diverged before it
            k = int(np.argmin(mism))
            first_divergence_is_tie = bool(tie_exact[k] or tie_fp[k]
                                           or kappa_boundary[k])

        rec.update(
            ctx_diverged=int((~clean).sum()),
            tie_exact=int(tie_exact.sum()),
            tie_fp=int(tie_fp.sum()),
            kappa_boundary=int(kappa_boundary.sum()),
            unexplained=int(unexplained.sum()),
        )
        per_level.append(rec)
        for k in total:
            total[k] += rec[k]

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
        "max_fp_band": max_fp_band,
        "tol": tol,
    }
