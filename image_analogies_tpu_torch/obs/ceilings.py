"""Resource-ceiling trend watchdogs: catch the leak before the OOM.

A soak does not fail at the moment the leak starts; it fails hours
later when RSS crosses the cgroup limit or the journal fills the disk.
This module watches the slow-moving resource series — process RSS,
devcache bytes, journal segment bytes, archive disk usage — and raises
``obs.ceiling.*`` alarms while the trend is still a trend.

Mechanics:

- :func:`read_proc_vitals` reads RSS / open fds / thread count from
  ``/proc`` (no new deps) with a graceful fallback off-Linux
  (``resource.getrusage`` for RSS, ``threading.active_count`` for
  threads, fds unknown).  ``/healthz`` and the watchdog share this one
  source.
- :class:`TrendWatchdog` keeps a bounded window of (t, value) points
  per series and estimates slope with THEIL-SEN (median of pairwise
  slopes) — robust to the sawtooth a GC or compaction puts on top of a
  real leak, where least squares would chase every spike.
- An alarm fires when the robust slope exceeds the series' threshold
  over a full window: counters ``obs.ceiling.alarms`` +
  ``obs.ceiling.<series>`` through the ambient scope, a trace record,
  a ``decision`` record through obs/ledger.emit_decision (so `ia why`
  can attribute a later shed to the detected leak), and an ``anomaly``
  record into the telemetry archive.  Re-alarms are rate-limited per
  series (``cooldown_s``).

The port's copy of the JAX package's ``obs/ceilings.py``; stdlib only.
The ``journal.bytes`` series is read from the gauge a write-ahead
journal keeps of its segments' bytes (serve/journal.py), as
``devcache.bytes`` is; the telemetry archive's own disk use is
``archive.bytes``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import trace as _trace

DEFAULT_WINDOW = 32        # points per series
DEFAULT_MIN_POINTS = 8     # alarm needs at least a window's worth
DEFAULT_COOLDOWN_S = 60.0  # one alarm per series per cooldown
# Default slope thresholds, bytes/second sustained.  Conservative: a
# steady +1 MiB/s RSS climb exhausts a 16 GiB box in ~4.5 hours — well
# inside soak territory but far above sampling noise.
DEFAULT_THRESHOLDS = {
    "proc.rss_bytes": 1 << 20,
    "devcache.bytes": 1 << 20,
    "journal.bytes": 256 << 10,
    "archive.bytes": 256 << 10,
}


def read_proc_vitals() -> Dict[str, Any]:
    """Process vitals from ``/proc`` (Linux) or best-effort fallbacks.
    Always returns the full key set; unknown values are None."""
    vitals: Dict[str, Any] = {"pid": os.getpid(), "rss_bytes": None,
                              "open_fds": None, "threads": None}
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        vitals["rss_bytes"] = int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        try:  # non-Linux fallback: peak, not current — better than None
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # linux reports KiB, macOS bytes; off-/proc we assume KiB
            vitals["rss_bytes"] = int(ru) * 1024
        except Exception:
            pass
    try:
        vitals["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    vitals["threads"] = int(line.split()[1])
                    break
    except (OSError, IndexError, ValueError):
        pass
    if vitals["threads"] is None:
        vitals["threads"] = threading.active_count()
    return vitals


def theil_sen_slope(points: List[Tuple[float, float]]) -> float:
    """Median of all pairwise slopes — the robust trend estimate.
    O(n^2) pairs on a <=32-point window is trivial."""
    slopes: List[float] = []
    n = len(points)
    for i in range(n):
        t0, v0 = points[i]
        for j in range(i + 1, n):
            t1, v1 = points[j]
            if t1 != t0:
                slopes.append((v1 - v0) / (t1 - t0))
    if not slopes:
        return 0.0
    slopes.sort()
    m = len(slopes)
    mid = m // 2
    return slopes[mid] if m % 2 else 0.5 * (slopes[mid - 1] + slopes[mid])


class TrendWatchdog:
    """One watched series: bounded window + Theil-Sen slope + alarm
    hysteresis."""

    __slots__ = ("series", "threshold", "min_points", "cooldown_s",
                 "points", "last_alarm", "alarms")

    def __init__(self, series: str, threshold: float,
                 window: int = DEFAULT_WINDOW,
                 min_points: int = DEFAULT_MIN_POINTS,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        self.series = series
        self.threshold = float(threshold)
        self.min_points = int(min_points)
        self.cooldown_s = float(cooldown_s)
        self.points: deque = deque(maxlen=int(window))
        self.last_alarm: Optional[float] = None
        self.alarms = 0

    def observe(self, t: float, v: float) -> None:
        self.points.append((float(t), float(v)))

    def evaluate(self, now: float, mutate: bool = True) -> Dict[str, Any]:
        """Verdict for the current window.  ``mutate=False`` (the
        ``report`` path) never consumes the cooldown, so a read-only
        peek cannot swallow the alarm the next sample tick owes."""
        pts = list(self.points)
        slope = theil_sen_slope(pts)
        verdict: Dict[str, Any] = {
            "series": self.series, "n": len(pts),
            "slope_per_s": round(slope, 3),
            "threshold_per_s": self.threshold,
            "value": pts[-1][1] if pts else None,
            "alarms": self.alarms, "alarm": False,
        }
        if len(pts) < self.min_points or slope <= self.threshold:
            return verdict
        if self.last_alarm is not None \
                and now - self.last_alarm < self.cooldown_s:
            verdict["suppressed"] = True
            return verdict
        if mutate:
            self.last_alarm = now
            self.alarms += 1
            verdict["alarms"] = self.alarms
        verdict["alarm"] = True
        return verdict


class CeilingMonitor:
    """The watchdog pack: feeds every configured series per tick and
    funnels alarms into counters / traces / decisions / the archive."""

    def __init__(self, thresholds: Optional[Dict[str, float]] = None,
                 window: int = DEFAULT_WINDOW,
                 min_points: int = DEFAULT_MIN_POINTS,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock: Callable[[], float] = time.monotonic,
                 decision_log: Any = None):
        self._lock = threading.Lock()
        self._clock = clock
        self.decision_log = decision_log  # fleet DecisionLog, optional
        self._dogs: Dict[str, TrendWatchdog] = {}
        for series, thr in (thresholds or DEFAULT_THRESHOLDS).items():
            self._dogs[series] = TrendWatchdog(
                series, thr, window=window, min_points=min_points,
                cooldown_s=cooldown_s)

    def sample(self, extra: Optional[Dict[str, float]] = None,
               now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One tick: gather vitals + ambient gauges + ``extra`` series
        values, evaluate every watchdog, emit alarms.  Returns the
        alarms raised this tick."""
        from image_analogies_tpu_torch.obs import archive as _archive
        from image_analogies_tpu_torch.obs import ledger as _ledger

        if now is None:
            now = self._clock()
        values: Dict[str, float] = {}
        vitals = read_proc_vitals()
        if vitals.get("rss_bytes") is not None:
            values["proc.rss_bytes"] = float(vitals["rss_bytes"])
            _metrics.set_gauge("proc.rss_bytes", float(vitals["rss_bytes"]))
        if vitals.get("open_fds") is not None:
            _metrics.set_gauge("proc.open_fds", float(vitals["open_fds"]))
        if vitals.get("threads") is not None:
            _metrics.set_gauge("proc.threads", float(vitals["threads"]))
        reg = _metrics.registry()
        if reg is not None:
            gauges = reg.snapshot().get("gauges") or {}
            for series in ("devcache.bytes", "journal.bytes"):
                if series in gauges:
                    values[series] = float(gauges[series])
        ar = _archive.current()
        if ar is not None:
            values["archive.bytes"] = float(ar.stats().get("bytes") or 0)
        for k, v in (extra or {}).items():
            if v is not None:
                values[k] = float(v)
        alarms: List[Dict[str, Any]] = []
        with self._lock:
            for series, v in values.items():
                dog = self._dogs.get(series)
                if dog is None:
                    continue
                dog.observe(now, v)
                verdict = dog.evaluate(now)
                if verdict["alarm"]:
                    alarms.append(verdict)
        for verdict in alarms:
            series = verdict["series"]
            _metrics.inc("obs.ceiling.alarms")
            _metrics.inc(f"obs.ceiling.{series}")
            _trace.emit_record({"event": "ceiling_alarm", **{
                k: verdict[k] for k in ("series", "slope_per_s",
                                        "threshold_per_s", "value")}})
            _ledger.emit_decision(
                "ceilings", "alarm", cause=f"{series}_trend",
                slope_per_s=verdict["slope_per_s"],
                threshold_per_s=verdict["threshold_per_s"])
            if self.decision_log is not None:
                try:
                    self.decision_log.record(
                        None, "ceilings", "alarm",
                        cause=f"{series}_trend",
                        slope_per_s=verdict["slope_per_s"])
                except Exception:
                    pass
            _archive.record("anomaly", {"series": series,
                                        "kind": "ceiling",
                                        "slope_per_s":
                                        verdict["slope_per_s"]})
        return alarms

    def report(self) -> Dict[str, Any]:
        """The ``ceilings`` section for ``ia report`` / ``/healthz``."""
        with self._lock:
            now = self._clock()
            out = {}
            for series, dog in self._dogs.items():
                v = dog.evaluate(now, mutate=False)
                v.pop("suppressed", None)
                out[series] = v
        return out


# --- module-level armed plane ------------------------------------------------

_ARMED = False
_ARM_LOCK = threading.Lock()
_ARM_COUNT = 0
_MONITOR: Optional[CeilingMonitor] = None


def arm(monitor: Optional[CeilingMonitor] = None,
        **kwargs: Any) -> CeilingMonitor:
    """Install (or join) the process ceilings monitor.  Arming registers
    a timeline-sampler feeder so a standalone ``ia serve --http``
    samples vitals without extra wiring; the fleet health loop calls
    :func:`sample` itself (with journal bytes in ``extra``)."""
    from image_analogies_tpu_torch.obs import timeline as _timeline

    global _ARMED, _ARM_COUNT, _MONITOR
    with _ARM_LOCK:
        if _MONITOR is None:
            _MONITOR = monitor if monitor is not None \
                else CeilingMonitor(**kwargs)
        _ARM_COUNT += 1
        _ARMED = True
        _timeline.register_feeder(_feed)
        return _MONITOR


def disarm() -> None:
    from image_analogies_tpu_torch.obs import timeline as _timeline

    global _ARMED, _ARM_COUNT, _MONITOR
    with _ARM_LOCK:
        _ARM_COUNT = max(_ARM_COUNT - 1, 0)
        if _ARM_COUNT == 0:
            _MONITOR = None
            _ARMED = False
            _timeline.unregister_feeder(_feed)


def current() -> Optional[CeilingMonitor]:
    return _MONITOR if _ARMED else None


def sample(extra: Optional[Dict[str, float]] = None) -> None:
    """Producer fast path: one bool check when disarmed."""
    if not _ARMED:
        return
    mon = _MONITOR
    if mon is not None:
        mon.sample(extra=extra)


def _feed() -> None:
    sample()


def report_doc() -> Optional[Dict[str, Any]]:
    mon = _MONITOR if _ARMED else None
    return None if mon is None else mon.report()


def selftest(seed: int = 11, n: int = 24,
             slope_bytes_per_s: float = 4 << 20) -> Dict[str, Any]:
    """Seeded leak-detection drill, scaled down for tier-1: a synthetic
    monotonic RSS trend (slope well over threshold, with noise) must
    alarm within the window budget (``min_points`` ticks); a flat noisy
    series must not.  Deterministic: injected clock, seeded noise."""
    import random

    rng = random.Random(seed)
    dog = TrendWatchdog("proc.rss_bytes",
                        DEFAULT_THRESHOLDS["proc.rss_bytes"],
                        cooldown_s=0.0)
    flat = TrendWatchdog("proc.rss_bytes",
                         DEFAULT_THRESHOLDS["proc.rss_bytes"],
                         cooldown_s=0.0)
    base = 512 << 20
    first_alarm: Optional[int] = None
    flat_alarms = 0
    for i in range(n):
        t = float(i)
        noise = rng.uniform(-64 << 10, 64 << 10)
        dog.observe(t, base + slope_bytes_per_s * i + noise)
        flat.observe(t, base + noise)
        if dog.evaluate(t)["alarm"] and first_alarm is None:
            first_alarm = i
        if flat.evaluate(t)["alarm"]:
            flat_alarms += 1
    return {"seed": seed, "n": n,
            "first_alarm_tick": first_alarm,
            "budget_ticks": DEFAULT_MIN_POINTS,
            "flat_alarms": flat_alarms,
            "ok": first_alarm is not None
            and first_alarm <= DEFAULT_MIN_POINTS
            and flat_alarms == 0}
