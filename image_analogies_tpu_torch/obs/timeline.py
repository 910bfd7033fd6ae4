"""Windowed time-series over the scoped metrics plane.

The cumulative registries (obs/metrics.py) answer "what happened over
this run"; this module answers "what is happening NOW and how did it
change over the last minute".  A :class:`Timeline` is a fixed-memory
ring store of per-window aggregates over named series:

- **counter** series hold the delta of a cumulative counter per window
  (a worker replacement resets its registry; a sample smaller than the
  previous one is treated as a fresh generation, not a negative delta);
- **gauge** series hold the last sampled value of the window;
- **hist** series hold a mergeable :class:`~image_analogies_tpu_torch.obs.
  metrics.Histogram` of the window's new samples (the cumulative
  summary diff), so p50/p95 are per-window, not lifetime.

Windows cascade through downsampling tiers (1s -> 10s -> 60s by
default): when a tier-i window closes it is folded — counters add,
gauges keep the last value, histograms :meth:`Histogram.merge` — into
the tier-i+1 window covering its start, and each tier is a bounded
deque, so total memory is fixed regardless of uptime.

An EWMA/MAD z-score detector runs over closed tier-0 latency and
queue-depth windows; outliers bump ``obs.anomaly.*`` counters through
the ambient scope and surface as an :func:`advisory` hint the degrade
ladder (or an operator watching ``ia top``) may consume.

Producers feed a timeline explicitly: the fleet health daemon samples
each worker's registry snapshot per poll (worker-labeled series, e.g.
``w0:serve.completed``), and :meth:`Timeline.start_sampler` runs a
background thread for single-server deployments.  Consumers read
:meth:`range` / :meth:`to_json` (the ``/timeline`` HTTP endpoint) and
the pure :func:`cockpit_rows` / :func:`render_cockpit` renderers that
``ia top`` draws.

The module-level plane is DISARMED by default and zero-cost while so:
:func:`sample_ambient` / :func:`sample_snapshot` read one module bool
and return — no allocation, no lock — the same contract (and the same
tracemalloc lock in tests) as the disabled metrics registry.  The clock
is injectable for deterministic tests.

No torch / numpy imports here: the timeline must be importable from any
layer without forcing device init.  The port's copy of the JAX package's
``obs/timeline.py``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import quantiles as _quantiles

# (window_seconds, ring_capacity) per tier, coarsening left to right:
# 2 minutes of 1s, 15 minutes of 10s, 1 hour of 60s — fixed memory.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 120), (10.0, 90), (60.0, 60))

# EWMA/MAD z-score detector defaults (tier-0 closed windows).
Z_THRESHOLD = 4.0
EWMA_ALPHA = 0.3
WARMUP_WINDOWS = 8
MAX_HINTS = 64
_MAD_SCALE = 1.4826  # MAD -> sigma under normality


def _anomaly_series(name: str) -> bool:
    return name.endswith("latency_ms") or name.endswith("queue_depth")


class _Window:
    """One aggregation window: ``series`` maps name -> float (counter
    delta / gauge last-value) or Histogram (windowed samples)."""

    __slots__ = ("start", "series", "closed")

    def __init__(self, start: float):
        self.start = start
        self.series: Dict[str, Any] = {}
        self.closed = False  # folded into the next tier already


class _Tier:
    __slots__ = ("window_s", "windows")

    def __init__(self, window_s: float, capacity: int):
        self.window_s = window_s
        self.windows: deque = deque(maxlen=capacity)

    def window_at(self, start: float) -> _Window:
        """The window whose start is ``start``, appended if absent.
        Folds arrive in closing order, so the target is always the
        newest window or a brand-new one."""
        if self.windows and self.windows[-1].start == start:
            return self.windows[-1]
        w = _Window(start)
        self.windows.append(w)
        return w


class Timeline:
    """Fixed-memory windowed store with downsampling tiers and an
    anomaly detector.  Thread-safe; the clock is injectable."""

    def __init__(self, tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS,
                 clock: Callable[[], float] = time.monotonic,
                 z_threshold: float = Z_THRESHOLD,
                 warmup: int = WARMUP_WINDOWS,
                 alpha: float = EWMA_ALPHA):
        if not tiers:
            raise ValueError("timeline needs at least one tier")
        self._lock = threading.Lock()
        self._tiers = [_Tier(ws, cap) for ws, cap in tiers]
        self._clock = clock
        self._z = float(z_threshold)
        self._warmup = int(warmup)
        self._alpha = float(alpha)
        # Per-series cumulative baselines (counter last value / histogram
        # last summary / sketch last summary) so each sample contributes
        # only its delta.
        self._cum: Dict[str, float] = {}
        self._cum_h: Dict[str, Dict] = {}
        self._cum_q: Dict[str, Dict] = {}
        self._kinds: Dict[str, str] = {}
        # Last sample wall time per series key, so baselines from dead
        # worker generations can be pruned instead of pinned forever.
        self._last_seen: Dict[str, float] = {}
        self._next_prune = 0.0
        self.series_pruned = 0
        # EWMA state per anomaly-watched series: [mean, mad, n_windows].
        self._ewma: Dict[str, List[float]] = {}
        self._hints: deque = deque(maxlen=MAX_HINTS)
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop = threading.Event()

    # --- ingest --------------------------------------------------------------

    def sample_snapshot(self, snap: Dict[str, dict],
                        worker: Optional[str] = None,
                        now: Optional[float] = None) -> None:
        """Fold one registry snapshot (``MetricsRegistry.snapshot()``
        shape) into the current tier-0 window.  ``worker`` labels every
        series ``worker:name`` so N isolated registries coexist in one
        timeline; fleet-level snapshots pass no worker."""
        if now is None:
            now = self._clock()
        prefix = f"{worker}:" if worker else ""
        with self._lock:
            self._advance_locked(now)
            t0 = self._tiers[0]
            win = t0.window_at(math.floor(now / t0.window_s) * t0.window_s)
            for name, v in (snap.get("counters") or {}).items():
                key = prefix + name
                prev = self._cum.get(key, 0.0)
                # v < prev: the source registry restarted (worker
                # replacement) — the whole value is this window's delta.
                delta = v - prev if v >= prev else v
                self._cum[key] = v
                self._kinds[key] = "counter"
                if delta:
                    win.series[key] = win.series.get(key, 0.0) + delta
            for name, v in (snap.get("gauges") or {}).items():
                key = prefix + name
                self._kinds[key] = "gauge"
                win.series[key] = v
            for name, summ in (snap.get("histograms") or {}).items():
                key = prefix + name
                self._kinds[key] = "hist"
                delta_h = self._hist_delta_locked(key, summ)
                if delta_h.count:
                    cur = win.series.get(key)
                    if cur is None:
                        win.series[key] = delta_h
                    else:
                        cur.merge(delta_h)
            for name, summ in (snap.get("sketches") or {}).items():
                # distinct key: the same registry name also carries the
                # base-2 histogram; ".q" keeps the kinds from colliding.
                key = prefix + name + ".q"
                self._kinds[key] = "sketch"
                prev = self._cum_q.get(key)
                delta = _quantiles.delta_summary(summ, prev)
                if delta is None:  # count regressed: fresh generation
                    delta = dict(summ)
                self._cum_q[key] = summ
                if int(delta.get("count", 0)) > 0:
                    cur = win.series.get(key)
                    win.series[key] = delta if cur is None else \
                        _quantiles.merge_summaries([cur, delta])
            stamp = now
            for name in (snap.get("counters") or {}):
                self._last_seen[prefix + name] = stamp
            for name in (snap.get("gauges") or {}):
                self._last_seen[prefix + name] = stamp
            for name in (snap.get("histograms") or {}):
                self._last_seen[prefix + name] = stamp
            for name in (snap.get("sketches") or {}):
                self._last_seen[prefix + name + ".q"] = stamp
            self._prune_locked(stamp)

    def _hist_delta_locked(self, key: str, summ: Dict) -> _metrics.Histogram:
        """New samples since the last snapshot of ``key``, as a
        mergeable histogram.  Window min/max are approximated by the
        cumulative extremes (the summary does not carry per-sample
        order); a count regression means a fresh source generation."""
        prev = self._cum_h.get(key)
        self._cum_h[key] = summ
        cur_n = int(summ.get("count", 0) or 0)
        if prev is None or cur_n < int(prev.get("count", 0) or 0):
            return _metrics.Histogram.from_summary(summ)
        h = _metrics.Histogram()
        n = cur_n - int(prev.get("count", 0) or 0)
        if n <= 0:
            return h
        h.count = n
        h.total = float(summ.get("sum", 0.0)) - float(prev.get("sum", 0.0))
        h.min = float(summ.get("min", 0.0))
        h.max = float(summ.get("max", 0.0))
        pb = prev.get("buckets") or {}
        for k, v in (summ.get("buckets") or {}).items():
            d = int(v) - int(pb.get(k, 0))
            if d > 0:
                h.buckets[int(k)] = d
        return h

    def _prune_locked(self, now: float) -> None:
        """Drop per-series baselines (cum / cum_h / cum_q / kinds /
        ewma) idle for more than two full tier-0 retentions.  A SIGKILLed
        worker's ``w<N>:`` series stop arriving the moment its scrape
        dies; without this, every generation's baselines stay pinned for
        the life of the fleet.  Ring windows age the *values* out on
        their own; this reclaims the dictionaries."""
        t0 = self._tiers[0]
        retention = t0.window_s * (t0.windows.maxlen or 1)
        if now < self._next_prune:
            return
        self._next_prune = now + retention
        horizon = now - 2.0 * retention
        stale = [k for k, ts in self._last_seen.items() if ts < horizon]
        for k in stale:
            self._last_seen.pop(k, None)
            self._cum.pop(k, None)
            self._cum_h.pop(k, None)
            self._cum_q.pop(k, None)
            self._kinds.pop(k, None)
            self._ewma.pop(k, None)
        if stale:
            self.series_pruned += len(stale)
            _metrics.inc("timeline.series_pruned", len(stale))

    # --- window lifecycle ----------------------------------------------------

    def _advance_locked(self, now: float) -> None:
        """Close every window whose span has passed, folding it into
        the next tier.  Ascending tier order: a tier-0 closure may land
        in a tier-1 window that this same advance is about to close."""
        for i, tier in enumerate(self._tiers):
            cur_start = math.floor(now / tier.window_s) * tier.window_s
            nxt = self._tiers[i + 1] if i + 1 < len(self._tiers) else None
            for w in tier.windows:
                if w.start >= cur_start:
                    break
                if w.closed:
                    continue
                # deque entries older than cur_start and not yet folded
                self._close_locked(i, w, nxt)

    def _close_locked(self, tier_i: int, w: _Window,
                      nxt: Optional[_Tier]) -> None:
        w.closed = True
        if tier_i == 0:
            self._detect_locked(w)
        if nxt is None:
            return
        target = nxt.window_at(
            math.floor(w.start / nxt.window_s) * nxt.window_s)
        for key, v in w.series.items():
            kind = self._kinds.get(key, "gauge")
            if kind == "counter":
                target.series[key] = target.series.get(key, 0.0) + v
            elif kind == "hist":
                cur = target.series.get(key)
                if cur is None:
                    h = _metrics.Histogram()
                    h.merge(v)
                    target.series[key] = h
                else:
                    cur.merge(v)
            elif kind == "sketch":
                cur = target.series.get(key)
                target.series[key] = dict(v) if cur is None else \
                    _quantiles.merge_summaries([cur, v])
            else:  # gauge: last value wins (windows close in time order)
                target.series[key] = v

    # --- anomaly detection ---------------------------------------------------

    def _detect_locked(self, w: _Window) -> None:
        for key, v in w.series.items():
            if not _anomaly_series(key):
                continue
            x = v.total / v.count if isinstance(v, _metrics.Histogram) \
                else float(v)
            state = self._ewma.get(key)
            if state is None:
                self._ewma[key] = [x, 0.0, 1.0]
                continue
            mean, mad, n = state
            dev = abs(x - mean)
            sigma = mad * _MAD_SCALE
            if n >= self._warmup and sigma > 1e-9:
                z = dev / sigma
                if z > self._z:
                    self._hints.append({
                        "series": key, "window_start": w.start,
                        "value": round(x, 3), "baseline": round(mean, 3),
                        "z": round(z, 2)})
                    _metrics.inc("obs.anomaly.total")
                    _metrics.inc(f"obs.anomaly.{key}")
                    # An outlier must not drag the baseline toward
                    # itself — skip the EWMA update for this window.
                    continue
            a = self._alpha
            state[0] = (1 - a) * mean + a * x
            state[1] = (1 - a) * mad + a * dev
            state[2] = n + 1

    # --- queries -------------------------------------------------------------

    def _tier_for(self, window_s: Optional[float]) -> _Tier:
        if window_s is None:
            return self._tiers[0]
        for tier in self._tiers:
            if tier.window_s == float(window_s):
                return tier
        raise KeyError(f"no timeline tier with window_s={window_s}; "
                       f"have {[t.window_s for t in self._tiers]}")

    @staticmethod
    def _point_value(v: Any) -> Any:
        if isinstance(v, _metrics.Histogram):
            return {"count": v.count, "sum": round(v.total, 3),
                    "mean": round(v.total / v.count, 3) if v.count else 0.0,
                    "p50": round(v.percentile(50), 3),
                    "p95": round(v.percentile(95), 3),
                    "max": round(v.max, 3) if v.count else 0.0}
        if isinstance(v, dict) and "bins" in v and "alpha" in v:
            sk = _quantiles.QuantileSketch.from_summary(v)
            out = {"count": sk.count,
                   "max": round(sk.max, 3) if sk.count else 0.0}
            out.update(sk.quantiles_doc())
            return out
        return v

    def range(self, series: str, window_s: Optional[float] = None
              ) -> List[Tuple[float, Any]]:
        """``[(window_start, value), ...]`` ascending for one series at
        one tier (default: the finest).  Histogram values come back as
        summary dicts with per-window p50/p95."""
        tier = self._tier_for(window_s)
        with self._lock:
            self._advance_locked(self._clock())
            return [(w.start, self._point_value(w.series[series]))
                    for w in tier.windows if series in w.series]

    def to_json(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """The ``/timeline`` document: every series at one tier, plus
        tier geometry and recent anomaly hints."""
        tier = self._tier_for(window_s)
        with self._lock:
            now = self._clock()
            self._advance_locked(now)
            series: Dict[str, Any] = {}
            for w in tier.windows:
                for key, v in w.series.items():
                    ent = series.setdefault(
                        key, {"kind": self._kinds.get(key, "gauge"),
                              "points": []})
                    ent["points"].append([w.start, self._point_value(v)])
            return {
                "armed": True,
                "now": round(now, 3),
                "window_s": tier.window_s,
                "tiers": [{"window_s": t.window_s,
                           "capacity": t.windows.maxlen,
                           "windows": len(t.windows)}
                          for t in self._tiers],
                "series": series,
                "anomalies": list(self._hints),
            }

    def advisory(self) -> Optional[Dict[str, Any]]:
        """The newest anomaly hint within the last two tier-0 windows —
        the degrade ladder's one-line view — or None when healthy."""
        with self._lock:
            if not self._hints:
                return None
            hint = self._hints[-1]
            horizon = self._clock() - 2 * self._tiers[0].window_s
            if hint["window_start"] < horizon:
                return None
            return dict(hint, degrade_hint=True)

    # --- background sampler --------------------------------------------------

    def start_sampler(self, interval_s: float = 1.0,
                      snap_fn: Optional[Callable[[], Dict]] = None,
                      worker: Optional[str] = None) -> None:
        """Background thread sampling ``snap_fn()`` (default: the
        ambient scope's snapshot) every ``interval_s``.  Single-server
        deployments use this; the fleet health daemon samples each
        worker itself."""
        if self._sampler is not None:
            return
        fn = snap_fn or _metrics.snapshot
        self._sampler_stop.clear()

        def _loop():
            while not self._sampler_stop.wait(interval_s):
                try:
                    self.sample_snapshot(fn(), worker=worker)
                except Exception:
                    _metrics.inc("obs.timeline.sampler_errors")
                for feeder in list(_FEEDERS):
                    try:
                        feeder()
                    except Exception:
                        _metrics.inc("obs.timeline.sampler_errors")

        self._sampler = threading.Thread(
            target=_loop, name="ia-timeline-sampler", daemon=True)
        self._sampler.start()

    def stop_sampler(self) -> None:
        if self._sampler is None:
            return
        self._sampler_stop.set()
        self._sampler.join(timeout=5.0)
        self._sampler = None


# --- sampler feeders ---------------------------------------------------------
#
# Other armed planes (obs/ledger.py's per-tenant series) register a
# zero-arg feeder here; a running sampler calls each after its own
# sample, so tenant-labeled series ride whichever sampler exists
# (standalone `ia serve --http` — the fleet health loop feeds directly).

_FEEDERS: List[Callable[[], None]] = []


def register_feeder(fn: Callable[[], None]) -> None:
    if fn not in _FEEDERS:
        _FEEDERS.append(fn)


def unregister_feeder(fn: Callable[[], None]) -> None:
    try:
        _FEEDERS.remove(fn)
    except ValueError:
        pass


# --- module-level armed plane ------------------------------------------------
#
# Mirrors the metrics registry's module fast path: _ARMED is one bool,
# and every producer-side helper checks it FIRST and returns — the
# disarmed path allocates nothing (tracemalloc-locked in tests).

_ARMED = False
_ARM_LOCK = threading.Lock()
_ARM_COUNT = 0
_TIMELINE: Optional[Timeline] = None


def arm(timeline: Optional[Timeline] = None, **kwargs: Any) -> Timeline:
    """Install (or join) the process timeline.  Re-arming nests: the
    fleet arms for its lifetime while `ia serve --http` arms for the
    server's; the plane disarms when the last owner leaves."""
    global _ARMED, _ARM_COUNT, _TIMELINE
    with _ARM_LOCK:
        if _TIMELINE is None:
            _TIMELINE = timeline if timeline is not None \
                else Timeline(**kwargs)
        _ARM_COUNT += 1
        _ARMED = True
        return _TIMELINE


def disarm() -> None:
    global _ARMED, _ARM_COUNT, _TIMELINE
    with _ARM_LOCK:
        _ARM_COUNT = max(_ARM_COUNT - 1, 0)
        if _ARM_COUNT == 0:
            t = _TIMELINE
            _TIMELINE = None
            _ARMED = False
            if t is not None:
                t.stop_sampler()


def current() -> Optional[Timeline]:
    return _TIMELINE if _ARMED else None


def sample_snapshot(snap: Dict[str, dict],
                    worker: Optional[str] = None) -> None:
    """Producer fast path: one bool check when disarmed."""
    if not _ARMED:
        return
    t = _TIMELINE
    if t is not None:
        t.sample_snapshot(snap, worker=worker)


def sample_ambient() -> None:
    """Sample the ambient scope's registry into the armed timeline;
    zero-cost when disarmed or no scope is active."""
    if not _ARMED:
        return
    t = _TIMELINE
    if t is not None:
        reg = _metrics.registry()
        if reg is not None:
            t.sample_snapshot(reg.snapshot())


def snapshot_json(window_s: Optional[float] = None) -> Dict[str, Any]:
    t = _TIMELINE if _ARMED else None
    if t is None:
        return {"armed": False, "series": {}, "anomalies": []}
    return t.to_json(window_s)


def advisory() -> Optional[Dict[str, Any]]:
    if not _ARMED:
        return None
    t = _TIMELINE
    return t.advisory() if t is not None else None


# --- cockpit rendering (pure; `ia top` and tests share it) -------------------

_BREAKER_NAMES = {0: "closed", 1: "half", 2: "OPEN"}


def _last_point(ent: Optional[Dict]) -> Optional[Tuple[float, Any]]:
    if not ent or not ent["points"]:
        return None
    start, v = ent["points"][-1]
    return start, v


def cockpit_rows(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Digest a ``/timeline`` document into one row per worker label
    (plus a fleet-level '-' row when unlabeled series exist): QPS from
    the completed-counter delta, p50/p95 from the windowed latency
    histogram, queue depth / breaker / HBM peak from gauges, anomaly
    count from the hints that name the worker."""
    window_s = float(doc.get("window_s") or 1.0)
    series = doc.get("series") or {}
    workers: Dict[str, Dict[str, Any]] = {}

    def row(worker: str) -> Dict[str, Any]:
        return workers.setdefault(worker, {
            "worker": worker, "qps": 0.0, "p50": None, "p95": None,
            "p999": None, "queue": None, "breaker": "", "hbm": None,
            "anomalies": 0})

    for key, ent in series.items():
        worker, _, name = key.rpartition(":")
        worker = worker or "-"
        last = _last_point(ent)
        if last is None:
            continue
        _, v = last
        if name == "serve.completed":
            row(worker)["qps"] = round(float(v) / window_s, 2)
        elif name == "serve.latency_ms" and isinstance(v, dict):
            row(worker)["p50"] = v.get("p50")
            row(worker)["p95"] = v.get("p95")
        elif name == "serve.latency_ms.q" and isinstance(v, dict):
            row(worker)["p999"] = v.get("p999")
        elif name == "serve.queue_depth":
            row(worker)["queue"] = v
        elif name.startswith("serve.breaker.state."):
            state = _BREAKER_NAMES.get(int(v), str(v))
            r = row(worker)
            r["breaker"] = state if not r["breaker"] \
                else f"{r['breaker']},{state}"
        elif name.startswith("hbm.peak_bytes"):
            r = row(worker)
            r["hbm"] = max(float(v), r["hbm"] or 0.0)
    for hint in doc.get("anomalies") or []:
        worker, _, _ = str(hint.get("series", "")).rpartition(":")
        worker = worker or "-"
        if worker in workers:
            workers[worker]["anomalies"] += 1
    return [workers[k] for k in sorted(workers)]


def render_cockpit(doc: Dict[str, Any]) -> str:
    """One terminal frame of the ``ia top`` cockpit."""
    rows = cockpit_rows(doc)
    hdr = (f"{'WORKER':<10} {'QPS':>8} {'P50ms':>8} {'P95ms':>8} "
           f"{'P999ms':>8} {'QUEUE':>6} {'BREAKER':>12} {'HBM':>10} "
           f"{'ANOM':>5}")
    lines = [f"ia top — window {doc.get('window_s', '?')}s, "
             f"{len(doc.get('series') or {})} series"
             + ("" if doc.get("armed", True) else "  [timeline disarmed]"),
             hdr, "-" * len(hdr)]

    def fmt(v, spec="{:.1f}"):
        return "-" if v is None else spec.format(v)

    def fmt_hbm(v):
        if v is None:
            return "-"
        return f"{v / (1 << 20):.1f}M" if v >= 1 << 20 else f"{v:.0f}"

    for r in rows:
        lines.append(
            f"{r['worker']:<10} {r['qps']:>8.2f} {fmt(r['p50']):>8} "
            f"{fmt(r['p95']):>8} {fmt(r.get('p999')):>8} "
            f"{fmt(r['queue'], '{:.0f}'):>6} "
            f"{(r['breaker'] or '-'):>12} {fmt_hbm(r['hbm']):>10} "
            f"{r['anomalies']:>5d}")
    if not rows:
        lines.append("(no series yet)")
    for hint in (doc.get("anomalies") or [])[-3:]:
        lines.append(f"! anomaly {hint.get('series')}: "
                     f"value {hint.get('value')} vs baseline "
                     f"{hint.get('baseline')} (z={hint.get('z')})")
    return "\n".join(lines)
