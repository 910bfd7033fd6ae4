"""Sealed ANN projection artifacts: the catalog-derived PCA bases (a copy
of the JAX package's ``catalog/ann.py``: the same bytes give the same
artifact, bit for bit, in both packages).

The two-stage matcher's prefilter (``ops/ann.py``) ranks DB rows in
a low-dimensional PCA subspace; the basis for one feature DB is DERIVED
state — recomputable from the stored feature bytes at any time — so it
lives beside the catalog entries under the same seal discipline
(store.py): checksum inside the npz, tmp + ``os.replace`` atomic writes,
damage quarantined as ``.corrupt`` (``ann.quarantined`` /
``ann_quarantined``) with the caller falling back to the bit-identical
exact path and rebuilding.

Layout is a flat ``<root>/_ann/<entry_key>.npz`` (no style directory:
the backend resolves projections from the feature content key alone,
and one feature DB has exactly one deterministic basis regardless of
which style produced it).  The ``_ann`` prefix keeps these out of
``store.list_styles``'s style enumeration.

NumPy-only on purpose — the catalog package must import (and build
artifacts) on hosts with no accelerator stack at all.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional, Tuple

import numpy as np

from image_analogies_tpu_torch.catalog.store import _quarantine
from image_analogies_tpu_torch.obs import metrics as obs_metrics

ANN_DIR = "_ann"


def artifact_path(root: str, key: str) -> str:
    return os.path.join(root, ANN_DIR, f"{key}.npz")


def build_projection(db: np.ndarray, dims: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic PCA basis for one (N, F) feature DB.

    Returns ``(mean (F,), proj (F, Kp))`` with Kp = min(dims, F, N): the
    top-Kp eigenvectors of the centered covariance, eigh-based (symmetric
    F x F — cheap: F is ~30-250) so the result is reproducible across
    runs, with each column sign-normalized (largest-|.|. component made
    positive) to kill the residual sign ambiguity.  float64 accumulation,
    float32 out — rebuilding from the same bytes reproduces the same
    artifact bit-for-bit."""
    x = np.asarray(db, np.float64)
    n, f = x.shape
    kp = max(1, min(int(dims), f, n))
    mean = x.mean(axis=0)
    xc = x - mean[None, :]
    cov = xc.T @ xc
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    proj = vecs[:, ::-1][:, :kp]
    flip = np.sign(proj[np.argmax(np.abs(proj), axis=0),
                        np.arange(kp)])
    flip = np.where(flip == 0, 1.0, flip)
    return (mean.astype(np.float32),
            (proj * flip[None, :]).astype(np.float32))


def _artifact_checksum(mean: np.ndarray, proj: np.ndarray,
                       key: str) -> str:
    """Same seal construction as store._entry_checksum: shape + dtype +
    bytes of both arrays AND the entry key, so rot on the stored key
    field reads as damage rather than as a different entry."""
    h = hashlib.sha256()
    for arr in (np.ascontiguousarray(mean), np.ascontiguousarray(proj)):
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    h.update(key.encode())
    return h.hexdigest()[:32]


def save_artifact(root: str, key: str, mean: np.ndarray,
                  proj: np.ndarray) -> str:
    mean = np.asarray(mean, np.float32)
    proj = np.asarray(proj, np.float32)
    path = artifact_path(root, key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, mean=mean, proj=proj, key=key,
             checksum=_artifact_checksum(mean, proj, key))
    os.replace(tmp, path)
    obs_metrics.inc("ann.artifact_write_bytes", os.path.getsize(path))
    return path


def load_artifact(root: str, key: str
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Returns (mean, proj) or None when missing or damaged.

    Damage (unreadable container, missing arrays, seal mismatch, stored
    key disagreeing with the filename's) quarantines the file as
    ``.corrupt`` (``ann.quarantined``) and returns None — the caller
    runs this request on the exact path (bit-identical by construction)
    and rebuilds the artifact from the feature bytes."""
    path = artifact_path(root, key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stored_key = str(z["key"])
            want = str(z["checksum"])
            got = _artifact_checksum(z["mean"], z["proj"], stored_key)
            if want != got:
                raise ValueError(
                    f"ann artifact checksum mismatch at {path}")
            if stored_key != key:
                raise ValueError(
                    f"ann artifact key mismatch at {path}: "
                    f"stored {stored_key!r}")
            mean = z["mean"].astype(np.float32)
            proj = z["proj"].astype(np.float32)
    except (zipfile.BadZipFile, OSError, ValueError, KeyError, EOFError):
        _quarantine(path, "ann.quarantined", "ann_quarantined")
        return None
    return mean, proj


def damage_artifact(path: str, seed: int = 0) -> None:
    """Damage helper (the ``match.prefilter`` site's corrupt directive,
    ``backends/cuda.py _resolve_ann_projection``): flip one byte of the sealed artifact in place, deterministically from
    ``seed``, so the next load fails its seal and quarantines."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if size == 0:
        return
    pos = int(np.random.RandomState(seed).randint(0, size))
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    obs_metrics.inc("ann.chaos_corruptions")
