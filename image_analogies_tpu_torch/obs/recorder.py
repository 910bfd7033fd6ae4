"""Flight recorder: a bounded ring of recent records per ObsScope, and
its sealed black-box dumps (the port's copy of the JAX package's
``obs/recorder.py``; :func:`render_dump` is ``ia blackbox``'s renderer).

Every record stamped while a run is active (anything flowing through
``utils.logging.emit``) is also appended to the current scope's ring, so
a scope carries its last-N-records history.  On a death path (the serve
breaker tripping open, a worker's process-death fault) the ring is dumped
as a sealed JSON file (a sha256 over the payload rides inside the file
and is checked on load, so a torn write reads as damage) into the scope's
``dump_dir``.

Imports of obs.metrics and obs.trace stay inside functions (metrics
imports this module at module scope).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CAPACITY = 256

_DUMP_SEQ = itertools.count(1)  # tells apart dumps of one millisecond


class FlightRecorder:
    """Thread-safe bounded ring of record dicts (newest last).

    ``record`` keeps a reference, not a copy: callers (obs.trace._stamp)
    hand over the per-emit private dict that utils.logging already copied,
    so the ring costs one append.  Evictions are counted in ``dropped``.
    """

    __slots__ = ("capacity", "_ring", "_lock", "dropped")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> Tuple[List[Dict[str, Any]], int]:
        """(records oldest->newest, dropped count) — shallow copies."""
        with self._lock:
            return [dict(r) for r in self._ring], self.dropped


# --- sealed dumps -----------------------------------------------------------

def _payload_checksum(payload: Dict[str, Any]) -> str:
    """sha256 over the canonical-JSON payload: the seal stored inside the
    dump and checked on load."""
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def dump(recorder: FlightRecorder, dump_dir: str, reason: str, *,
         scope_id: str = "", extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the ring as a sealed ``blackbox-*.json`` into ``dump_dir``
    (temporary file, then rename).  Returns the dump's path."""
    records, dropped = recorder.snapshot()
    payload: Dict[str, Any] = {
        "version": 1,
        "reason": str(reason),
        "scope": scope_id,
        "wall_ts": round(time.time(), 3),
        "dropped": dropped,
        "records": records,
    }
    if extra:
        payload["extra"] = extra
    doc = dict(payload)
    doc["checksum"] = _payload_checksum(payload)
    os.makedirs(dump_dir, exist_ok=True)
    fname = (f"blackbox-{int(time.time() * 1e3):013d}"
             f"-{next(_DUMP_SEQ):04d}-{_safe(reason)}.json")
    path = os.path.join(dump_dir, fname)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True, default=str)
    os.replace(tmp, path)
    return path


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in name)[:40]


def dump_current(reason: str,
                 extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump the current scope's ring (resolved on the calling thread).

    Never raises (a failing dump must not turn a contained fault into a
    crash), and does nothing when no scope is active, the scope has no
    recorder or no ``dump_dir``.  A dump counts ``obs.blackbox.dumps``
    and a per-reason counter, a failure ``obs.blackbox.dump_errors``.
    The thread's ambient request attrs are folded into the dump's
    ``extra`` (explicit keys win)."""
    from image_analogies_tpu_torch.obs import metrics as _metrics

    try:
        scope = _metrics.current_scope()
        if scope is None or scope.recorder is None or not scope.dump_dir:
            return None
        from image_analogies_tpu_torch.obs import trace as _trace

        ambient = _trace.context_attrs()
        if ambient:
            merged = dict(ambient)
            merged.update(extra or {})
            extra = merged
        path = dump(scope.recorder, scope.dump_dir, reason,
                    scope_id=scope.scope_id, extra=extra)
        _metrics.inc("obs.blackbox.dumps")
        _metrics.inc(f"obs.blackbox.dumps.{_safe(reason)}")
        _trace.emit_record({"event": "blackbox_dump", "reason": reason,
                            "scope": scope.scope_id,
                            "file": os.path.basename(path)})
        return path
    except Exception:  # noqa: BLE001 - a dump never raises
        try:
            _metrics.inc("obs.blackbox.dump_errors")
        except Exception:  # noqa: BLE001
            pass
        return None


def list_dumps(dump_dir: str) -> List[str]:
    """Sorted ``blackbox-*.json`` paths under ``dump_dir`` (name order is
    time order: the name leads with the epoch-ms stamp)."""
    try:
        names = sorted(n for n in os.listdir(dump_dir)
                       if n.startswith("blackbox-") and n.endswith(".json"))
    except OSError:
        return []
    return [os.path.join(dump_dir, n) for n in names]


def load_dump(path: str) -> Dict[str, Any]:
    """Parse and seal-check one dump.  Raises ``ValueError`` on a missing
    or failed seal: a damaged black box is reported as damaged."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "checksum" not in doc:
        raise ValueError(f"blackbox dump {path}: no integrity seal")
    want = doc.pop("checksum")
    got = _payload_checksum(doc)
    if want != got:
        raise ValueError(f"blackbox dump {path}: seal mismatch "
                         f"(want {want}, got {got})")
    return doc


def render_dump(doc: Dict[str, Any], *, last: int = 0) -> str:
    """Human-readable flight log: one line per record, timestamped
    relative to the final record (the moment of death).  ``last`` trims
    to the N newest records (0 = all)."""
    records = list(doc.get("records") or [])
    if last > 0:
        records = records[-last:]
    end_ts = None
    for rec in reversed(records):
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            end_ts = float(ts)
            break
    lines = [
        f"blackbox: reason={doc.get('reason', '?')} "
        f"scope={doc.get('scope') or '(unscoped)'} "
        f"records={len(doc.get('records') or [])} "
        f"dropped={doc.get('dropped', 0)}"
    ]
    for rec in records:
        ts = rec.get("ts")
        if end_ts is not None and isinstance(ts, (int, float)):
            stamp = f"{float(ts) - end_ts:+9.3f}s"
        else:
            stamp = " " * 10
        ev = rec.get("event") or rec.get("name") or "record"
        detail = {k: v for k, v in sorted(rec.items())
                  if k not in ("ts", "event") and not isinstance(v, dict)}
        body = " ".join(f"{k}={v}" for k, v in detail.items())
        lines.append(f"  {stamp} {ev} {body}".rstrip())
    return "\n".join(lines) + "\n"
