"""Persistent tune store: measured launch-geometry winners, keyed per device
(counterpart of the JAX package's ``tune/store.py``, with its schema).

One JSON file holds every tuned entry:

    {
      "version": 1,
      "entries": {
        "NVIDIA H100 80GB HBM3|wavefront|packed2|f256|b*": {
          "chunks_per_sm": 2,
          "ring_stages": 4,
          "source": "ia tune",            # free-form provenance
          "chunks_per_sm_ms": 0.30        # optional, informational
        },
        ...
      }
    }

Keys lead with the device kind, so one file can hold both packages'
entries (a TPU's beside a card's); a merge by either package keeps the
other's entries, and each validates only the knobs it owns and lets
unknown keys through.

Path precedence: explicit argument > ``IA_TUNE_STORE`` > the repo-local
``<repo>/.ia_tune.json`` (listed in ``.gitignore``).  Loading is cached on
(path, mtime, size); a corrupt or invalid store emits one
``tune_store_error`` warning record and resolves as empty: never a crash,
never partial entries.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

from image_analogies_tpu_torch.obs import trace as _trace
from image_analogies_tpu_torch.utils import logging as _logging

SCHEMA_VERSION = 1

# the integer knobs the port owns; each must be a positive int when present
_KNOBS = ("chunks_per_sm", "ring_stages", "scan_tile_cap",
          "wavefront_max_rows", "batch_pad_waste_pct", "ann_top_m",
          "ann_proj_dims")

_LOCK = threading.Lock()
# path -> ((mtime_ns, size), entries)
_CACHE: Dict[str, Tuple[Tuple[int, int], Dict[str, Dict[str, Any]]]] = {}
_WARNED: set = set()  # paths whose corruption was already reported


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def store_path(explicit: Optional[str] = None) -> str:
    if explicit:
        return explicit
    env = os.environ.get("IA_TUNE_STORE", "").strip()
    if env:
        return env
    return os.path.join(_repo_root(), ".ia_tune.json")


def invalidate_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _WARNED.clear()


def _warn(path: str, reason: str) -> None:
    """One ``tune_store_error`` warning per corrupt path a process, into
    the active run's log when there is one."""
    with _LOCK:
        if path in _WARNED:
            return
        _WARNED.add(path)
    _logging.logger.warning("tune store %s: %s (resolving as empty)", path,
                            reason)
    ctx = _trace._CURRENT
    _logging.emit({"event": "tune_store_error", "severity": "warning",
                   "path": path, "reason": reason},
                  ctx.log_path if ctx is not None else None)


def validate_entry(entry: Any) -> bool:
    if not isinstance(entry, dict):
        return False
    for k in _KNOBS:
        if k in entry:
            v = entry[k]
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                return False
    return True


def _parse(raw: Any, path: str) -> Dict[str, Dict[str, Any]]:
    if not isinstance(raw, dict):
        _warn(path, "store root is not an object")
        return {}
    if raw.get("version") != SCHEMA_VERSION:
        _warn(path, f"unsupported store version {raw.get('version')!r}")
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        _warn(path, "store has no entries object")
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    for key, entry in entries.items():
        if isinstance(key, str) and validate_entry(entry):
            out[key] = entry
        else:
            _warn(path, f"invalid entry for key {key!r}")
    return out


def load_entries(path: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Validated entries of the store at ``path`` (:func:`store_path`);
    ``{}`` for a missing or corrupt store."""
    path = store_path(path)
    try:
        st = os.stat(path)
    except OSError:
        return {}
    stamp = (st.st_mtime_ns, st.st_size)
    with _LOCK:
        cached = _CACHE.get(path)
        if cached is not None and cached[0] == stamp:
            return cached[1]
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        _warn(path, f"unreadable store: {e}")
        return {}
    entries = _parse(raw, path)
    with _LOCK:
        _CACHE[path] = (stamp, entries)
    return entries


def save_entries(entries: Dict[str, Dict[str, Any]],
                 path: Optional[str] = None) -> str:
    """Atomically write ``entries`` (replacing the whole store)."""
    path = store_path(path)
    for key, entry in entries.items():
        if not (isinstance(key, str) and validate_entry(entry)):
            raise ValueError(f"invalid tune entry for key {key!r}")
    blob = json.dumps({"version": SCHEMA_VERSION, "entries": entries},
                      indent=2, sort_keys=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(blob + "\n")
    os.replace(tmp, path)
    invalidate_cache()
    return path


def merge_entries(new: Dict[str, Dict[str, Any]],
                  path: Optional[str] = None) -> str:
    """Merge ``new`` into the store at ``path`` (new keys win; every other
    entry, the other package's included, stays)."""
    merged = dict(load_entries(path))
    merged.update(new)
    return save_entries(merged, path)
