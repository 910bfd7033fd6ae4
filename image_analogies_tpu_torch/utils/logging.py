"""Structured per-level records (counterpart of the JAX package's
``utils/logging.py``).

Each synthesized level emits one record (level, db_rows, pixels,
coherence_ratio, ms, backend, ts), mirrored to the standard ``logging``
module and appended as a JSON line when a log path is given.  Driver
events (``resume_level``, ``level_retry``, ``retry_exhausted``,
``watchdog_timeout``, ``ckpt_quarantined``) go the same way.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, TextIO

logger = logging.getLogger("image_analogies_tpu_torch")

# Optional per-record stamper: the observability layer (obs/trace.py)
# registers one to add run_id/seq while a run is active.  A hook, so this
# module imports nothing of obs.
_STAMPER: Optional[Callable[[Dict[str, Any]], None]] = None


def set_record_stamper(fn: Optional[Callable[[Dict[str, Any]], None]]
                       ) -> None:
    global _STAMPER
    _STAMPER = fn


# Per-path append handles, held only between begin_handle_cache and
# end_handle_cache (a run scope brackets a run with them, so a level loop
# streaming a record per level opens each file once).  Outside a scope
# every record opens, appends and closes.
_HANDLE_LOCK = threading.Lock()
_HANDLES: Dict[str, TextIO] = {}
_CACHING = 0  # nesting count of open scopes


def begin_handle_cache() -> None:
    global _CACHING
    with _HANDLE_LOCK:
        _CACHING += 1


def end_handle_cache() -> None:
    """Flush and close every held handle when the outermost scope ends."""
    global _CACHING
    with _HANDLE_LOCK:
        _CACHING = max(_CACHING - 1, 0)
        if _CACHING:
            return
        for f in _HANDLES.values():
            try:
                f.flush()
                f.close()
            except OSError:
                pass
        _HANDLES.clear()


def _write_line(path: str, line: str) -> None:
    if _CACHING:
        with _HANDLE_LOCK:
            if _CACHING:  # again under the lock
                f = _HANDLES.get(path)
                if f is None:
                    os.makedirs(os.path.dirname(os.path.abspath(path)),
                                exist_ok=True)
                    f = _HANDLES[path] = open(path, "a")
                f.write(line + "\n")
                return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def emit(record: Dict[str, Any], path: Optional[str] = None) -> None:
    """Log ``record`` (a copy, stamped with ``ts``) and append it to
    ``path`` as one JSON line when a path is given."""
    record = dict(record)
    record.setdefault("ts", time.time())
    if _STAMPER is not None:
        _STAMPER(record)
    line = json.dumps(record, sort_keys=True)
    logger.info("%s", line)
    if path:
        _write_line(path, line)
