"""The two-stage ANN matcher (counterpart of the JAX package's
``ann_topm_candidates`` / ``ann_rescore_slab`` in ``ops/pallas_match.py``
and ``_ann_arrays_on_device`` / ``_ann_project_db`` in
``backends/tpu.py``).

Stage 1 scores every DB row in a Kp-dim PCA subspace (Kp << F) and keeps
the top-m candidates per query; stage 2 gathers that (M, m) slab and
re-scores it with the exact fp32 distance.  As in the JAX package both
stages are plain tensor ops, outside any hand-written kernel: one
projected matrix product and a top-k, then a gather and a reduction.
fp32 throughout, TF32 off (the package's import sets it off).
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_analogies_tpu_torch.obs import metrics as obs_metrics


def _top_k_lowest_index(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(M, k) int64: per row, the indices of the ``k`` largest scores, the
    set ``lax.top_k`` keeps — every index scoring above the k-th largest
    value, then the LOWEST indices among those equal to it.
    ``torch.topk`` orders no ties, and duplicate DB rows (flat regions)
    give exactly equal scores, so an m-th/(m+1)-th tie would decide which
    duplicate enters the slab.  ``torch.topk`` takes k + 1; only the rows
    whose (k+1)-th value equals the k-th (a tie across the boundary; one
    host sync a call finds them) are fixed up: their slots holding the
    threshold value are refilled with the lowest equal indices (counted in
    ``ann.tie_fixup_rows``).  Order inside a row is unspecified (stage 2
    takes a minimum)."""
    m, n = scores.shape
    if k >= n:
        return torch.arange(n, device=scores.device).expand(m, n)
    vals, idx = torch.topk(scores, k + 1, dim=1)
    thr = vals[:, k - 1]
    cand = idx[:, :k]
    # rows whose threshold is -inf hold only masked rows past it: the clamp
    # sends each of them to the same last valid row
    tie = (vals[:, k] == thr) & (thr > float("-inf"))
    rows = torch.nonzero(tie).squeeze(1)
    if rows.numel() == 0:
        return cand
    obs_metrics.inc("ann.tie_fixup_rows", int(rows.numel()))
    cand = cand.clone()
    iota = torch.arange(n, dtype=torch.int32, device=scores.device)
    slot = torch.arange(k, device=scores.device)
    chunk = max(1, (1 << 28) // max(n, 1))  # <= 1 GiB of int32 positions
    for lo in range(0, int(rows.numel()), chunk):
        r = rows[lo:lo + chunk]
        t = thr[r][:, None]
        n_gt = (vals[r, :k] > t).sum(dim=1, keepdim=True)
        pos = torch.where(scores[r] == t, iota, n)
        first_eq = torch.topk(pos, k, dim=1, largest=False).values.long()
        refill = first_eq.gather(1, (slot[None, :] - n_gt).clamp(min=0))
        cand[r] = torch.where(slot[None, :] < n_gt, cand[r], refill)
    return cand


def ann_topm_candidates(queries: torch.Tensor, proj: torch.Tensor,
                        mean: torch.Tensor, dbp: torch.Tensor,
                        dbp_halfnorm: torch.Tensor, n_valid: int,
                        top_m: int) -> torch.Tensor:
    """Stage 1: the top-``top_m`` candidate rows per query, by projected
    distance.

    ``proj`` is the (F, Kp) PCA basis, ``mean`` the (F,) feature mean it
    was centered on, ``dbp`` the pre-projected (Npad, Kp) DB and
    ``dbp_halfnorm`` its (Npad,) half squared norms.  One (M, Npad)
    product ranks every row by  qp.dbp_n - 0.5 ||dbp_n||^2  (bigger is
    closer; the query's own norm cannot change its order).  Rows at or
    past ``n_valid`` (shape-bucket padding, which projects to finite
    scores) are masked to -inf in place before the top-k.  Returns (M, m)
    int64 indices clamped into [0, n_valid), m = max(1, min(top_m,
    Npad))."""
    npad = int(dbp.shape[0])
    m_sel = max(1, min(int(top_m), npad))
    qp = (queries - mean[None, :queries.shape[1]]) @ proj
    scores = qp @ dbp.T
    scores.sub_(dbp_halfnorm[None, :])
    if n_valid < npad:
        scores[:, n_valid:] = float("-inf")
    return _top_k_lowest_index(scores, m_sel).clamp(max=n_valid - 1)


def ann_rescore_slab(queries: torch.Tensor, db: torch.Tensor,
                     cand: torch.Tensor, n_valid: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: exact fp32 re-score of the candidate slab.  Gathers
    ``db[cand]`` ((M, m, F)) and takes the squared distances in the
    difference form; among the candidates at the minimum, the LOWEST DB
    index wins (a min over indices masked to the tie set, which also
    collapses the duplicates the stage-1 clamp makes).  Returns (idx (M,)
    int64, d (M,) fp32)."""
    d = ((db[cand] - queries[:, None, :]) ** 2).sum(dim=-1)
    bv = d.min(dim=1).values
    bi = torch.where(d <= bv[:, None], cand,
                     torch.full_like(cand, n_valid)).min(dim=1).values
    return bi, bv


def ann_project_db(src: torch.Tensor, mean: torch.Tensor, proj: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sealed-basis path: the scoring DB ``src`` (N, F) projected
    through ``proj`` around ``mean``.  Returns (dbp (N, Kp), its half
    squared norms (N,))."""
    dbp = (src - mean[None, :]) @ proj
    return dbp, 0.5 * (dbp * dbp).sum(dim=1)


def ann_arrays(src: torch.Tensor, dims: int):
    """The fresh basis, on ``src``'s device in one place: the column mean,
    the fp32 covariance of the centered rows, ``torch.linalg.eigh``, its
    top-Kp eigenvectors (Kp = min(dims, F, N)) and the projected DB.  Any
    basis only steers the ranking (the re-score is exact either way), so
    it need not match a sealed artifact's float64 build bit for bit.
    Returns (mean (F,), proj (F, Kp), dbp (N, Kp), half norms (N,))."""
    n, f = src.shape
    kp = max(1, min(int(dims), f, n))
    mean = src.mean(dim=0)
    xc = src - mean[None, :]
    _, vecs = torch.linalg.eigh(xc.T @ xc)  # ascending eigenvalues
    proj = vecs.flip(1)[:, :kp].contiguous()
    return (mean, proj) + ann_project_db(src, mean, proj)
