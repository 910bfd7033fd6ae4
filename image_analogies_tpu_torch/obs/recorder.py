"""Flight recorder: a bounded ring of recent records per ObsScope (the
port's copy of the JAX package's ``obs/recorder.py`` ring; its sealed
black-box dumps and ``ia blackbox`` wait for the port's serve layer).

Every record stamped while a run is active (anything flowing through
``utils.logging.emit``) is also appended to the current scope's ring, so
a scope carries its last-N-records history.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Tuple

DEFAULT_CAPACITY = 256


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
