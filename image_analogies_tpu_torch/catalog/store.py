"""Disk tier: sha256-sealed per-level feature artifacts (a copy of the JAX
package's ``catalog/store.py``; the seal and the npz fields are its, so
each package reads the other's store).

Layout: ``<root>/<style>/<entry_key>.npz`` where ``style`` is the serve
batcher's exemplar sha1 and ``entry_key`` is the feature-content digest
(``tiers.feature_key``).  One artifact holds one stored
``build_features_np`` output — the (Na, F) feature DB and the flat A'
luminance — sealed by the checkpoint discipline (``utils/checkpoint.py``):
the checksum lives INSIDE the npz, integrity is checked before anything
is trusted, writes are tmp + ``os.replace`` atomic, and damaged entries
are quarantined as ``<entry>.npz.corrupt`` (``catalog.quarantined`` /
``catalog_quarantined``) so a rotten artifact costs at most a rebuild.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.utils import checkpoint as ckpt


def _quarantine(path: str, counter: str, event: str) -> None:
    """``ckpt.quarantine`` with the record going to the active run's log
    (the JAX package's ``obs_trace.emit_record``)."""
    ctx = obs_trace._CURRENT
    ckpt.quarantine(path, counter=counter, event=event,
                    log_path=ctx.log_path if ctx is not None else None)


def style_dir(root: str, style: str) -> str:
    return os.path.join(root, style)


def entry_path(root: str, style: str, key: str) -> str:
    return os.path.join(root, style, f"{key}.npz")


def _entry_checksum(db: np.ndarray, a_filt_flat: np.ndarray,
                    key: str) -> str:
    """sha256 seal over both payload arrays (shape + dtype + bytes) AND
    the entry key: rot landing on the stored key field reads as damage,
    not as a different entry (same reasoning as checkpoint's seal)."""
    h = hashlib.sha256()
    for arr in (np.ascontiguousarray(db), np.ascontiguousarray(a_filt_flat)):
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    h.update(key.encode())
    return h.hexdigest()[:32]


def save_entry(root: str, style: str, key: str, db: np.ndarray,
               a_filt_flat: np.ndarray) -> str:
    path = entry_path(root, style, key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, db=db, a_filt_flat=a_filt_flat, key=key,
             checksum=_entry_checksum(db, a_filt_flat, key))
    os.replace(tmp, path)
    obs_metrics.inc("catalog.disk.write_bytes", os.path.getsize(path))
    return path


def load_entry(root: str, style: str, key: str
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Returns (db, a_filt_flat) or None when missing or damaged.

    Damage (unreadable container, missing arrays, seal mismatch, stored
    key disagreeing with the filename's) quarantines the file as
    ``.corrupt`` and returns None — the caller falls through to a full
    rebuild, which is bit-identical by construction."""
    path = entry_path(root, style, key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stored_key = str(z["key"])
            want = str(z["checksum"])
            got = _entry_checksum(z["db"], z["a_filt_flat"], stored_key)
            if want != got:
                raise ValueError(
                    f"catalog entry checksum mismatch at {path}")
            if stored_key != key:
                raise ValueError(
                    f"catalog entry key mismatch at {path}: "
                    f"stored {stored_key!r}")
            db = z["db"].astype(np.float32)
            a_filt_flat = z["a_filt_flat"].astype(np.float32)
    except (zipfile.BadZipFile, OSError, ValueError, KeyError, EOFError):
        _quarantine(path, "catalog.quarantined", "catalog_quarantined")
        return None
    return db, a_filt_flat


def list_styles(root: str) -> List[str]:
    """Style directories only: ``_``-prefixed siblings (the sealed ANN
    bases under ``_ann/``) are derived state, not styles."""
    if not root or not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d))
                  and not d.startswith("_"))


def list_entries(root: str, style: str) -> List[Tuple[str, int]]:
    """(entry_key, nbytes) pairs for one style, sorted by key."""
    d = style_dir(root, style)
    if not os.path.isdir(d):
        return []
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".npz") and not fn.endswith(".tmp.npz"):
            out.append((fn[:-4], os.path.getsize(os.path.join(d, fn))))
    return out


def stats(root: str) -> Dict[str, object]:
    """Catalog inventory for ``ia catalog inspect``."""
    styles = {}
    total_bytes = 0
    total_entries = 0
    corrupt = 0
    for style in list_styles(root):
        entries = list_entries(root, style)
        nbytes = sum(sz for _, sz in entries)
        d = style_dir(root, style)
        corrupt += sum(1 for fn in os.listdir(d) if fn.endswith(".corrupt"))
        styles[style] = {"entries": len(entries), "bytes": nbytes}
        total_bytes += nbytes
        total_entries += len(entries)
    return {"root": root, "styles": styles, "entries": total_entries,
            "bytes": total_bytes, "corrupt": corrupt}


def gc(root: str, *, keep: Optional[List[str]] = None,
       max_bytes: Optional[int] = None,
       purge_corrupt: bool = False) -> Dict[str, object]:
    """Prune the disk tier.

    ``keep`` exempts listed styles entirely; with ``max_bytes`` set the
    non-exempt entries are dropped oldest-mtime-first until the catalog
    fits.  Torn ``.tmp.npz`` leftovers always go; quarantined
    ``.corrupt`` files are evidence and only go with ``purge_corrupt``.
    """
    keep_set = set(keep or ())
    removed_entries = 0
    freed = 0
    candidates = []  # (mtime, path, size, style)
    for style in list_styles(root):
        d = style_dir(root, style)
        for fn in os.listdir(d):
            path = os.path.join(d, fn)
            if fn.endswith(".tmp.npz") or (
                    purge_corrupt and fn.endswith(".corrupt")):
                freed += os.path.getsize(path)
                os.remove(path)
                removed_entries += 1
            elif fn.endswith(".npz") and style not in keep_set:
                st = os.stat(path)
                candidates.append((st.st_mtime, path, st.st_size, style))
    if max_bytes is not None:
        total = sum(sz for _, _, sz, _ in candidates) + sum(
            sz for style in keep_set for _, sz in list_entries(root, style))
        for _, path, sz, _ in sorted(candidates):
            if total <= max_bytes:
                break
            os.remove(path)
            total -= sz
            freed += sz
            removed_entries += 1
    removed_styles = []
    for style in list_styles(root):
        d = style_dir(root, style)
        if not os.listdir(d):
            os.rmdir(d)
            removed_styles.append(style)
    obs_metrics.inc("catalog.gc_removed", removed_entries)
    return {"removed_entries": removed_entries,
            "removed_styles": removed_styles, "freed_bytes": freed}
