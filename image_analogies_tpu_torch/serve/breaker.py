"""Dispatch circuit breaker: fail fast when the engine is failing hard.

A wedged or broken backend turns every dispatch into a slow failure —
each one burns a worker for the full retry budget while the queue backs
up behind it.  The breaker converts that into fast, honest rejection:

- **closed** (normal): dispatches flow; each failure bumps a consecutive
  counter, any success resets it.
- **open**: after ``threshold`` consecutive failures the breaker trips.
  Requests fail immediately with ``Rejected("circuit_open")`` — no
  dispatch, no retry burn — for ``cooldown_s`` seconds.
- **half_open**: after the cooldown, exactly ONE probe dispatch is let
  through.  Success closes the breaker; failure re-opens it for another
  cooldown.

The admission layer consults :meth:`admission_open` — a non-claiming
read that is True only while the breaker is open with the cooldown
unelapsed — so ``submit()`` can shed with ``Rejected("breaker_open")``
one hop before the queue without stealing the half-open probe slot.
State is exported live as the gauge ``serve.breaker.state.<backend>``
(closed=0, half_open=1, open=2) for the /metrics exposition.

``threshold=0`` disables the breaker entirely (every ``allow()`` is
True, ``admission_open()`` is False, nothing is counted).  The clock is
injectable so tests drive the state machine without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import recorder as obs_recorder
from image_analogies_tpu_torch.obs import trace as obs_trace


_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 backend: str = "default"):
        self._threshold = int(threshold)
        self._cooldown_s = float(cooldown_s)
        self._clock = clock
        self.backend = str(backend)
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False  # half_open: one probe slot, taken or not

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def export_state(self) -> None:
        """Publish the per-backend state gauge (closed=0, half_open=1,
        open=2).  Called on every transition and once at pool start so
        the gauge exists from the first scrape."""
        with self._lock:
            self._export_locked()

    def _export_locked(self) -> None:
        obs_metrics.set_gauge(f"serve.breaker.state.{self.backend}",
                              _STATE_CODE[self._state])

    def admission_open(self) -> bool:
        """Non-claiming read for the admission layer: True only while the
        breaker is open AND the cooldown has not elapsed.  Once the
        cooldown expires this returns False even before a probe runs, so
        the half-open probe request can flow through ``submit()``."""
        if self._threshold <= 0:
            return False
        with self._lock:
            return (self._state == "open"
                    and self._clock() - self._opened_at < self._cooldown_s)

    def allow(self) -> bool:
        """May a dispatch proceed right now?  In half_open this CLAIMS the
        single probe slot, so exactly one caller gets True per cooldown —
        the caller must follow up with record_success/record_failure."""
        if self._threshold <= 0:
            return True
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at < self._cooldown_s:
                    obs_metrics.inc("serve.breaker.fast_fails")
                    return False
                self._state = "half_open"
                self._probing = False
                self._export_locked()
                obs_trace.emit_record({"event": "breaker_half_open"})
            # half_open: hand out the one probe slot
            if self._probing:
                obs_metrics.inc("serve.breaker.fast_fails")
                return False
            self._probing = True
            obs_metrics.inc("serve.breaker.probes")
            return True

    def record_success(self) -> None:
        if self._threshold <= 0:
            return
        with self._lock:
            if self._state != "closed":
                obs_trace.emit_record({"event": "breaker_closed"})
            self._state = "closed"
            self._consecutive = 0
            self._probing = False
            self._export_locked()

    def record_failure(self) -> None:
        if self._threshold <= 0:
            return
        with self._lock:
            if self._state == "half_open":
                # probe failed: straight back to open, fresh cooldown
                self._trip()
                return
            self._consecutive += 1
            if self._state == "closed" and self._consecutive >= self._threshold:
                self._trip()

    def _trip(self) -> None:
        # lock held by callers
        self._state = "open"
        self._opened_at = self._clock()
        self._consecutive = 0
        self._probing = False
        self._export_locked()
        obs_metrics.inc("serve.breaker.trips")
        obs_trace.emit_record({"event": "breaker_open",
                               "cooldown_s": self._cooldown_s})
        # A trip means the last `threshold` dispatches all failed — dump
        # the flight ring while the evidence is still in it (no-op when
        # the current scope has no dump dir; never raises).
        obs_recorder.dump_current("breaker_open",
                                  extra={"backend": self.backend,
                                         "cooldown_s": self._cooldown_s})
