"""SLO attainment + burn-rate tracking over deadline outcomes (the port's
copy of the JAX package's ``obs/slo.py``).

A :class:`SloTracker` watches the stream of *deadlined* request outcomes
(met / missed) and maintains the two standard SRE views:

- **attainment** — fraction of deadlined requests that met their
  deadline over the rolling slow window; compared against a configurable
  target (default 99%).
- **burn rate** — observed violation rate divided by the error budget
  (``1 - target``), over a fast window (paging signal: "we are burning
  budget 14x too fast") and a slow window (ticket signal).  Burn 1.0
  means exactly on budget; >1 means the budget will be exhausted early.

Everything is exported as gauges through the ordinary obs metrics
helpers (``slo.target``, ``slo.attainment``, ``slo.burn_rate.fast``,
``slo.burn_rate.slow``) plus counters ``slo.deadlined`` /
``slo.violations``, so the live /metrics exposition, ``ia report``'s
``slo`` section, and /healthz all read the same numbers.  The helpers
resolve thread-ambiently (obs/metrics.py): a fleet worker's tracker
writes into that worker's own :class:`~.metrics.ObsScope` (which also
carries the tracker as ``scope.slo``), so per-worker ``/metrics`` show
per-worker burn while the fleet roll-up takes the MAX across workers
(``slo.`` is a max-gauge family in obs/fleet.py — averaging away one
worker's page-worthy burn rate would defeat the signal).

Contract (shared with the rest of obs/): no torch import and near-zero
cost when observability is disabled — the
gauge/counter helpers are one-branch no-ops without an active run, and
the tracker itself is plain-Python deque arithmetic.  The clock is
injectable for deterministic tests.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from image_analogies_tpu_torch.obs import metrics as _metrics


class SloTracker:
    """Rolling-window SLO bookkeeping over deadline outcomes.

    Thread-safe: ``record`` is called from every serve worker thread.
    """

    def __init__(self,
                 target: float = 0.99,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not 0.0 < target < 1.0:
            raise ValueError(f"slo target must be in (0, 1), got {target}")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                "slo windows must satisfy 0 < fast <= slow, got "
                f"fast={fast_window_s} slow={slow_window_s}")
        self.target = float(target)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque()  # (t, met: bool), pruned vs slow window
        self._total = 0
        self._violations = 0

    # -- recording ----------------------------------------------------------

    def record(self, met: bool, now: Optional[float] = None) -> None:
        """Record one deadlined request outcome and refresh the gauges."""
        t = self._clock() if now is None else now
        with self._lock:
            self._events.append((t, bool(met)))
            self._prune(t)
            self._total += 1
            if not met:
                self._violations += 1
            fast = self._burn(t, self.fast_window_s)
            slow = self._burn(t, self.slow_window_s)
            attain = self._attainment(t)
        _metrics.inc("slo.deadlined")
        if not met:
            _metrics.inc("slo.violations")
        # (Re)set target on every record: the run scope may open after the
        # tracker is constructed, and gauges set before it are dropped.
        _metrics.set_gauge("slo.target", self.target)
        _metrics.set_gauge("slo.attainment", attain)
        _metrics.set_gauge("slo.burn_rate.fast", fast)
        _metrics.set_gauge("slo.burn_rate.slow", slow)

    # -- reading ------------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Point-in-time SLO view for /healthz and tests."""
        t = self._clock() if now is None else now
        with self._lock:
            self._prune(t)
            return {
                "target": self.target,
                "deadlined": self._total,
                "violations": self._violations,
                "attainment": self._attainment(t),
                "burn_rate_fast": self._burn(t, self.fast_window_s),
                "burn_rate_slow": self._burn(t, self.slow_window_s),
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
            }

    # -- internals (lock held) ---------------------------------------------

    def _prune(self, now: float) -> None:
        horizon = now - self.slow_window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def _window_counts(self, now: float, window_s: float):
        horizon = now - window_s
        n = bad = 0
        for t, met in self._events:
            if t >= horizon:
                n += 1
                if not met:
                    bad += 1
        return n, bad

    def _burn(self, now: float, window_s: float) -> float:
        n, bad = self._window_counts(now, window_s)
        if n == 0:
            return 0.0
        budget = 1.0 - self.target
        return (bad / n) / budget

    def _attainment(self, now: float) -> float:
        n, bad = self._window_counts(now, self.slow_window_s)
        if n == 0:
            return 1.0
        return (n - bad) / n
