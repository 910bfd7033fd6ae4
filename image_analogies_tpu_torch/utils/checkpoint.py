"""Per-level checkpoint and resume (counterpart of the JAX package's
``utils/checkpoint.py``).

All cross-level state of the synthesis is the level's B' plane and its
source map, so a level's checkpoint is one small ``.npz``.  The driver
saves after each level and, with ``resume_from_level``, loads every
finished coarser level instead of recomputing it.  The npz fields
(``level``, ``bp``, ``s``, ``digest``, ``checksum``) and the seal are the
JAX package's, so a file written by either package loads in the other.
A damaged file is quarantined and counted (``ckpt.quarantined``).  The
chaos sites ``ckpt.save`` and ``ckpt.load`` stand where the JAX package
has them; a ``corrupt`` directive at ``ckpt.save`` damages the file after
its atomic rename, a write that looked whole.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional, Tuple

import numpy as np

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.chaos import faults as chaos_faults
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.utils import logging as ialog

# Fields that never change the bp/s planes, so a checkpoint written with
# other values of them stays resumable: the JAX package's list, as it is
# (its names the port lacks are harmless).  match_mode and strategy stay
# in the digest: their outputs differ.
_DIGEST_EXCLUDED = ("checkpoint_dir", "resume_from_level", "profile_dir",
                    "log_path", "db_shards", "data_shards", "level_retries",
                    "save_levels_dir", "level_sync", "metrics",
                    "dispatch_timeout_s", "catalog_dir",
                    "catalog_host_bytes")


def level_path(ckpt_dir: str, level: int) -> str:
    return os.path.join(ckpt_dir, f"level_{level:02d}.npz")


def run_digest(params, a_shape, b_shape) -> str:
    """Fingerprint of (the port's params, input shapes): a checkpoint
    written under another run configuration must not be resumed — its
    planes would be of the wrong shape or stale."""
    payload = repr((sorted(
        (k, v) for k, v in vars(params).items()
        if k not in _DIGEST_EXCLUDED), tuple(a_shape), tuple(b_shape)))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def clip_digest(params, a_shape, b_shape, n_frames: int, phase: str) -> str:
    """``run_digest`` extended with a clip's length and its two_phase phase
    tag (the stacked per-level checkpoints of a sharded clip: the two
    phases' planes must never resume into each other)."""
    base = run_digest(params, a_shape, b_shape)
    return hashlib.sha256(
        f"{base}:clip:{n_frames}:{phase}".encode()).hexdigest()[:16]


def _payload_checksum(bp: np.ndarray, s: np.ndarray,
                      digest: str = "") -> str:
    """sha256 over the two planes (shape, dtype, bytes) and the stored run
    digest: the seal stored inside the npz and checked on load.  The
    digest asks "the same run configuration?", the seal "did these bytes
    survive?"; the digest rides inside the seal, so damage to the digest
    field reads as damage, not as a stale file."""
    h = hashlib.sha256()
    for arr in (np.ascontiguousarray(bp), np.ascontiguousarray(s)):
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    h.update(digest.encode())
    return h.hexdigest()[:32]


def quarantine(path: str, *, event: str = "ckpt_quarantined",
               log_path: Optional[str] = None,
               counter: str = "ckpt.quarantined") -> str:
    """Move a damaged file aside as ``<path>.corrupt`` (never deleted: the
    bytes are evidence), emit an ``event`` record and count ``counter`` in
    the active metrics run (other stores pass their own:
    ``catalog.quarantined``, ``ann.quarantined``,
    ``serve.journal.quarantined``).  Returns the new path."""
    qpath = path + ".corrupt"
    os.replace(path, qpath)
    obs_metrics.inc(counter)
    ialog.emit({"event": event, "path": path}, log_path)
    return qpath


def save_level(ckpt_dir: str, level: int, bp: np.ndarray,
               s: np.ndarray, digest: str = "") -> str:
    """Write level ``level``'s (bp, s) with its digest and seal; the file
    appears whole or not at all (written aside, then renamed)."""
    # a raising fault fires before any byte moves; a corrupt directive
    # lands after the rename, a write that looked whole
    directive = chaos.site("ckpt.save", level=level)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = level_path(ckpt_dir, level)
    tmp = path + ".tmp.npz"
    np.savez(tmp, level=level, bp=bp, s=s, digest=digest,
             checksum=_payload_checksum(bp, s, digest))
    os.replace(tmp, path)
    if directive == "corrupt":
        chaos_faults.corrupt_file(path, chaos.plan_seed() or 0)
    return path


def load_level(ckpt_dir: str, level: int, digest: str = "",
               log_path: Optional[str] = None
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(bp float32, s int32), or None when the file is missing, stale or
    damaged.

    Stale (another digest) is a clean skip: the intact file belongs to
    another run configuration and stays.  Damaged (an unreadable container,
    a missing array, a failed seal) is quarantined as ``.corrupt`` so the
    next run does not trip on it, and the level is recomputed.  A file with
    no digest (written before the field existed) loads only when no digest
    is asked."""
    chaos.site("ckpt.load", level=level)
    path = level_path(ckpt_dir, level)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stored = str(z["digest"]) if "digest" in z.files else ""
            bp = z["bp"].astype(np.float32)
            s = z["s"].astype(np.int32)
            # the seal before the digest: a failed seal is damage whatever
            # field it hit (a stale file still carries a consistent seal)
            if "checksum" in z.files:
                want = str(z["checksum"])
                got = _payload_checksum(z["bp"], z["s"], stored)
                if want != got:
                    raise ValueError(
                        f"checkpoint payload checksum mismatch at {path}")
            if digest and stored != digest:
                return None
    except (zipfile.BadZipFile, OSError, ValueError, KeyError, EOFError):
        quarantine(path, log_path=log_path)
        return None
    return bp, s
