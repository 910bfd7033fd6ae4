"""The CPU oracle matcher: NumPy and ``scipy.spatial.cKDTree`` (the port's
copy of the JAX package's ``backends/cpu.py``, ``backend="cpu"``).

This is the reference semantics on the host: the literal per-pixel raster
scan, the approximate match through a cKDTree (``use_ann``) or brute force
(``backends/native_match.py``), the Ashikhmin coherence candidate and the
κ rule.  It is not the port's ``device="cpu"``, which runs the card's
kernels' plain versions on the CPU.  Its planes stay NumPy arrays
throughout, so its results are the JAX package's CPU backend's bit for bit
on the same brute-force path.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch.backends.base import LevelJob, Matcher
from image_analogies_tpu_torch.ops.features import (
    build_features_np,
    fine_gather_maps,
    window_offsets,
)

try:
    from scipy.spatial import cKDTree
except Exception:  # pragma: no cover - scipy is a dependency of the port
    cKDTree = None


@dataclass
class CpuLevelDB:
    """Per-level database and precomputed query-side state."""

    db: np.ndarray  # (Na, F) weighted features over A/A'
    tree: Optional["cKDTree"]
    a_filt_flat: np.ndarray  # (Na,) A' luminance, flat
    wa: int  # A width (flat <-> 2-D index math)
    ha: int
    static_q: np.ndarray  # (Nb, F) query features, fine_filt block zero
    flat_idx: np.ndarray  # (Nb, n_fine) clipped gather map into B'
    valid: np.ndarray  # (Nb, n_fine) causal & in-bounds mask (coherence)
    written: np.ndarray  # (Nb, n_fine) causal & already-synthesized mask
    fine_sqrtw: np.ndarray  # (n_fine,) sqrt-weights of the fine_filt block
    offsets: np.ndarray  # (n_fine, 2) window offsets


def _a_side_key(spec, job: LevelJob, use_ann: bool) -> str:
    """Content digest of everything the A-side build consumes."""
    h = hashlib.sha1()
    h.update(repr((spec, job.a_shape, use_ann)).encode())
    for arr in (job.a_src, job.a_filt, job.a_src_coarse, job.a_filt_coarse,
                job.a_temporal):
        if arr is None:
            h.update(b"-")
        else:
            a = np.ascontiguousarray(np.asarray(arr))
            h.update(str((a.shape, a.dtype)).encode())
            h.update(a.tobytes())
    return h.hexdigest()


class CpuMatcher(Matcher):
    """The host oracle.  ``device`` is always the CPU (the driver's
    ``on_card`` reads it)."""

    # A-side memo: (db, tree, a_filt_flat) keyed by exemplar content, per
    # instance, so a fresh matcher per run is untouched; a serve batch
    # that shares one matcher across identical exemplars builds features
    # and the KD-tree once a level.  Bounded LRU; locked because serve
    # workers may share an instance across threads.
    _A_MEMO_CAP = 16

    def __init__(self, params, device=None):
        super().__init__(params)
        self.device = "cpu"
        self._a_memo: "OrderedDict[str, tuple]" = OrderedDict()
        self._a_memo_lock = threading.Lock()

    def _a_side(self, spec, job: LevelJob):
        use_ann = bool(self.params.use_ann and cKDTree is not None)
        # a catalog tier hit: the driver resolved this level's A-side
        # (catalog/tiers.py; the stored bytes ARE a build_features_np
        # output, the db a cold build would give); the KD-tree is consumer
        # scratch parked on the entry, so a resident hit skips it too
        ref = job.a_features
        if ref is not None and ref.entry is not None:
            ent = ref.entry
            tree = None
            if use_ann:
                tree = ent.state.get("tree")
                if tree is None:
                    tree = cKDTree(ent.db)
                    ent.state["tree"] = tree
            return ent.db, tree, ent.a_filt_flat
        key = _a_side_key(spec, job, use_ann)
        with self._a_memo_lock:
            hit = self._a_memo.get(key)
            if hit is not None:
                self._a_memo.move_to_end(key)
                return hit
        t0 = time.perf_counter()
        db = build_features_np(
            spec, job.a_src, job.a_filt, job.a_src_coarse, job.a_filt_coarse,
            temporal_fine=job.a_temporal,
        )
        tree = cKDTree(db) if use_ann else None
        a_filt_flat = np.asarray(job.a_filt, np.float32).reshape(-1)
        if ref is not None:
            # a cold build under an active catalog fills every tier (and
            # the sealed disk artifact), so the next request for this
            # style skips the build; the tree is parked on the entry
            ent = ref.record(db, a_filt_flat,
                             build_ms=(time.perf_counter() - t0) * 1e3)
            if tree is not None:
                ent.state["tree"] = tree
        entry = (db, tree, a_filt_flat)
        with self._a_memo_lock:
            self._a_memo[key] = entry
            while len(self._a_memo) > self._A_MEMO_CAP:
                self._a_memo.popitem(last=False)
        return entry

    def build_features(self, job: LevelJob) -> CpuLevelDB:
        spec = job.spec
        db, tree, a_filt_flat = self._a_side(spec, job)
        b_filt_coarse = job.b_filt_coarse
        if b_filt_coarse is not None and not isinstance(b_filt_coarse,
                                                        np.ndarray):
            b_filt_coarse = b_filt_coarse.cpu().numpy()  # a resumed plane
        static_q = build_features_np(
            spec, job.b_src, None, job.b_src_coarse, b_filt_coarse,
            temporal_fine=job.b_temporal,
        )
        hb, wb = job.b_shape
        ha, wa = job.a_shape
        flat_idx, valid, written = fine_gather_maps(hb, wb, spec.fine_size)
        return CpuLevelDB(
            db=db,
            tree=tree,
            a_filt_flat=a_filt_flat,
            wa=wa,
            ha=ha,
            static_q=static_q,
            flat_idx=flat_idx,
            valid=valid,
            written=written,
            fine_sqrtw=spec.sqrt_weights()[spec.fine_filt_slice].copy(),
            offsets=window_offsets(spec.fine_size),
        )

    # -- the three pieces of the matcher -----------------------------------

    def query_vector(self, db: CpuLevelDB, job: LevelJob, q: int,
                     bp_flat: np.ndarray) -> np.ndarray:
        """Full feature vector of query pixel q given B' so far: the static
        part (B and the coarse planes) plus the causal gather from the
        evolving B'."""
        vec = db.static_q[q].copy()
        vec[job.spec.fine_filt_slice] = (
            bp_flat[db.flat_idx[q]] * db.written[q] * db.fine_sqrtw)
        return vec

    def best_approximate_match(self, db: CpuLevelDB,
                               qvec: np.ndarray) -> Tuple[int, float]:
        """L2 nearest DB row: the cKDTree with ANN on, else brute force."""
        if db.tree is not None:
            d, p = db.tree.query(qvec)
            return int(p), float(d) ** 2
        from image_analogies_tpu_torch.backends import native_match

        return native_match.brute_argmin(db.db, qvec)

    def best_coherence_match(
        self, db: CpuLevelDB, job: LevelJob, q: int, qvec: np.ndarray,
        s_flat: np.ndarray,
    ) -> Tuple[int, float]:
        """Ashikhmin candidate: argmin over {s(r) + (q - r)} for causal r.

        Returns (-1, inf) when no candidate is valid (the first pixel)."""
        valid = db.valid[q] > 0
        if not valid.any():
            return -1, np.inf
        r_flat = db.flat_idx[q][valid]
        off = db.offsets[valid]
        # p_c = s(r) + (q - r) = s(r) - offset, in A's 2-D coordinates
        si = s_flat[r_flat] // db.wa - off[:, 0]
        sj = s_flat[r_flat] % db.wa - off[:, 1]
        inb = (si >= 0) & (si < db.ha) & (sj >= 0) & (sj < db.wa)
        if not inb.any():
            return -1, np.inf
        cand = (si[inb] * db.wa + sj[inb]).astype(np.int64)
        d = ((db.db[cand] - qvec[None, :]) ** 2).sum(axis=1)
        k = int(np.argmin(d))  # the first lowest wins ties
        return int(cand[k]), float(d[k])

    def best_match(self, db: CpuLevelDB, job: LevelJob, q: int,
                   bp_flat: np.ndarray, s_flat: np.ndarray
                   ) -> Tuple[int, float, bool]:
        qvec = self.query_vector(db, job, q, bp_flat)
        p_app, d_app = self.best_approximate_match(db, qvec)
        p_coh, d_coh = self.best_coherence_match(db, job, q, qvec, s_flat)
        # the κ rule (Hertzmann §3.2 eq. 2, on squared distances)
        if p_coh >= 0 and d_coh <= d_app * job.kappa_mult:
            return p_coh, d_coh, True
        return p_app, d_app, False

    # -- level scan ---------------------------------------------------------

    def synthesize_level(self, db: CpuLevelDB, job: LevelJob
                         ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        hb, wb = job.b_shape
        n = hb * wb
        bp = np.zeros(n, dtype=np.float32)
        s = np.zeros(n, dtype=np.int32)
        t0 = time.perf_counter()
        n_coh = 0
        for q in range(n):
            p, _, used_coh = self.best_match(db, job, q, bp, s)
            n_coh += used_coh
            bp[q] = db.a_filt_flat[p]
            s[q] = p
        dt = time.perf_counter() - t0
        stats = {
            "level": job.level,
            "db_rows": int(db.db.shape[0]),
            "pixels": n,
            "coherence_ratio": n_coh / max(n, 1),
            "ms": dt * 1e3,
            "backend": "cpu",
        }
        return bp.reshape(hb, wb), s.reshape(hb, wb), stats
