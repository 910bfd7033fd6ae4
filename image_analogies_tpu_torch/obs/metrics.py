"""Scoped, thread-safe metrics registries (the port's copy of the JAX
package's ``obs/metrics.py``: the same names, the same snapshot).

A :class:`MetricsRegistry` holds counters, gauges, and histograms keyed
by name.  Registries travel inside an :class:`ObsScope` — the unit of
observability identity (registry + flight recorder + SLO tracker +
dump dir) — and scopes resolve THREAD-AMBIENTLY, the same pattern as
``obs.trace.request_context``: a per-thread scope stack first, then the
process-default scope installed by ``obs.trace.run_scope``, then None.
Instrumentation sites everywhere call the module-level helpers
(:func:`inc`, :func:`add_gauge`, :func:`set_gauge`, :func:`observe`),
which check a single module bool before resolving — with no scope
active anywhere the cost is one attribute load + branch per call site,
so bench numbers do not move when observability is off.

A scope may chain to a ``parent``: writes land in the scope's own
registry AND every ancestor's.  That is how fleet workers get isolated
per-worker registries (each worker thread pushes its scope) while the
enclosing run's registry still sees the whole-fleet totals that drills
and ``run_end`` snapshots assert on.  Reads (``registry()``,
``snapshot()``) never chain — they see exactly the resolved scope.

No torch / numpy imports here: the registry must be importable from
any layer (ops, backends, utils) without creating cycles or forcing
device init.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Dict, List, Optional

from image_analogies_tpu_torch.obs import quantiles as _quantiles
from image_analogies_tpu_torch.obs import recorder as _recorder


class Histogram:
    """Fixed power-of-two bucket histogram (base-2 exponential).

    Tracks count / sum / min / max plus counts per bucket
    ``[2^k, 2^(k+1))``.  Good enough for ms and byte distributions
    without requiring a quantile sketch dependency.
    """

    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        k = max(0, math.frexp(value)[1]) if value > 0 else 0
        self.buckets[k] = self.buckets.get(k, 0) + 1

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile from the base-2 buckets: the upper
        edge of the bucket holding that rank, clamped to the observed
        max.  Coarse by construction (buckets are octaves) but monotone
        and dependency-free — good enough for serving-latency p50/p95."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for k in sorted(self.buckets):
            cum += self.buckets[k]
            if cum >= rank:
                edge = float(2 ** k) if k > 0 else 0.0
                return min(edge, self.max)
        return self.max

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        # buckets ride along (run_end snapshots feed `ia report`'s
        # batch-size histogram); the empty-histogram summary keeps its
        # legacy shape.
        return {"count": self.count, "sum": self.total, "min": self.min,
                "max": self.max, "mean": self.total / self.count,
                "buckets": {str(k): v
                            for k, v in sorted(self.buckets.items())}}

    def merge(self, other: "Histogram") -> None:
        """Fold ``other`` into this histogram: the result equals one
        histogram fed both sample sets (count, sum, min, max and every
        bucket add exactly, so the percentile estimates agree too).  An
        empty ``other`` is a no-op (its inf/-inf sentinels would poison a
        non-empty target's extremes)."""
        if not other.count:
            return
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        self.count += other.count
        self.total += other.total
        for k, v in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + v

    @classmethod
    def from_summary(cls, summ: Dict) -> "Histogram":
        """Rebuild a mergeable histogram from a :meth:`summary` dict (the
        timeline's downsampler merges window aggregates kept as plain
        dicts).  An empty summary has no ``buckets`` key."""
        h = cls()
        count = int(summ.get("count", 0) or 0)
        if not count:
            return h
        h.count = count
        h.total = float(summ.get("sum", 0.0))
        h.min = float(summ.get("min", 0.0))
        h.max = float(summ.get("max", 0.0))
        h.buckets = {int(k): int(v)
                     for k, v in (summ.get("buckets") or {}).items()}
        return h


# Series (by name suffix) that also feed a relative-error quantile
# sketch next to their base-2 histogram — the honest-tail rider for
# p99.9/p99.99.  Latency is the tail that matters; everything else
# keeps the cheap histogram only.
SKETCH_SUFFIXES = ("latency_ms",)


class MetricsRegistry:
    """Thread-safe named counters / gauges / histograms, plus a
    DDSketch-style quantile sketch riding beside the histogram on
    latency series (see :data:`SKETCH_SUFFIXES`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sketches: Dict[str, "_quantiles.QuantileSketch"] = {}

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def add_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = self._gauges.get(name, 0) + value

    def max_gauge(self, name: str, value: float) -> None:
        """Peak watermark: keep the maximum ever observed (HBM peaks)."""
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(value)
            if name.endswith(SKETCH_SUFFIXES):
                sk = self._sketches.get(name)
                if sk is None:
                    sk = self._sketches[name] = _quantiles.QuantileSketch()
                sk.observe(value)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict dump, safe to json-serialize into a run record.
        The ``sketches`` key appears only once a latency series exists,
        so pre-sketch snapshot shapes (golden tests, archived run logs)
        stay byte-stable."""
        with self._lock:
            snap = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
            }
            if self._sketches:
                snap["sketches"] = {k: sk.summary()
                                    for k, sk in self._sketches.items()}
            return snap


# --- scoped observability contexts ------------------------------------------

_SCOPE_IDS = itertools.count(1)


class ObsScope:
    """One observability identity: a registry plus the trace sink
    (flight-recorder ring) and slots for the SLO tracker and black-box
    dump directory that travel with it.

    ``parent`` chains writes upward (worker scope -> fleet/run scope):
    metric WRITES through this scope land in every registry on the
    chain, so isolation (reads see only this worker) and aggregate
    invariants (the run's registry sums all workers) hold at once.
    Reads never chain.
    """

    __slots__ = ("scope_id", "registry", "parent", "recorder", "slo",
                 "dump_dir")

    def __init__(self, scope_id: Optional[str] = None,
                 parent: Optional["ObsScope"] = None,
                 recorder_capacity: int = _recorder.DEFAULT_CAPACITY):
        self.scope_id = scope_id or f"scope{next(_SCOPE_IDS)}"
        self.registry = MetricsRegistry()
        self.parent = parent
        self.recorder = _recorder.FlightRecorder(recorder_capacity)
        self.slo = None  # obs.slo.SloTracker, attached by the owner
        self.dump_dir: Optional[str] = None  # black-box dump target

    def inc(self, name: str, value: float = 1) -> None:
        s: Optional[ObsScope] = self
        while s is not None:
            s.registry.inc(name, value)
            s = s.parent

    def set_gauge(self, name: str, value: float) -> None:
        s: Optional[ObsScope] = self
        while s is not None:
            s.registry.set_gauge(name, value)
            s = s.parent

    def add_gauge(self, name: str, value: float) -> None:
        s: Optional[ObsScope] = self
        while s is not None:
            s.registry.add_gauge(name, value)
            s = s.parent

    def max_gauge(self, name: str, value: float) -> None:
        s: Optional[ObsScope] = self
        while s is not None:
            s.registry.max_gauge(name, value)
            s = s.parent

    def observe(self, name: str, value: float) -> None:
        s: Optional[ObsScope] = self
        while s is not None:
            s.registry.observe(name, value)
            s = s.parent


# --- module-level fast path + scope resolution ------------------------------
#
# _ACTIVE is true while ANY scope is installed anywhere (process default
# or any thread's stack).  Hot-path call sites read one module global
# and branch; resolution walks thread-local -> process default only when
# some run asked for metrics.

_ACTIVE = False
_ACTIVE_COUNT = 0
_ACTIVE_LOCK = threading.Lock()
_PROCESS: List[ObsScope] = []  # process-default stack (run_scope installs)
_TLS = threading.local()  # per-thread scope stack (fleet worker threads)


def _activate() -> None:
    global _ACTIVE, _ACTIVE_COUNT
    with _ACTIVE_LOCK:
        _ACTIVE_COUNT += 1
        _ACTIVE = True


def _deactivate() -> None:
    global _ACTIVE, _ACTIVE_COUNT
    with _ACTIVE_LOCK:
        _ACTIVE_COUNT = max(_ACTIVE_COUNT - 1, 0)
        _ACTIVE = _ACTIVE_COUNT > 0


def current_scope() -> Optional[ObsScope]:
    """Thread-ambient scope resolution: this thread's innermost pushed
    scope, else the process-default scope, else None.  The disabled path
    is one module-global read + branch — no allocation."""
    if not _ACTIVE:
        return None
    stack = getattr(_TLS, "stack", None)
    if stack:
        return stack[-1]
    return _PROCESS[-1] if _PROCESS else None


def push_scope(scope: ObsScope) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(scope)
    _activate()


def pop_scope(scope: ObsScope) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is scope:
                del stack[i]
                break
    _deactivate()


@contextlib.contextmanager
def scope_active(scope: Optional[ObsScope]):
    """Make ``scope`` the current thread's ambient scope for the block.
    ``scope_active(None)`` is a transparent no-op, so call sites that
    may or may not own a scope (standalone Server vs fleet worker)
    never branch."""
    if scope is None:
        yield None
        return
    push_scope(scope)
    try:
        yield scope
    finally:
        pop_scope(scope)


def install_process_scope(scope: ObsScope) -> None:
    """Install the process-default scope (obs.trace.run_scope does this
    once per top-level run) — the fallback every thread without its own
    pushed scope resolves to."""
    _PROCESS.append(scope)
    _activate()


def uninstall_process_scope(scope: ObsScope) -> None:
    for i in range(len(_PROCESS) - 1, -1, -1):
        if _PROCESS[i] is scope:
            del _PROCESS[i]
            break
    _deactivate()


def inc(name: str, value: float = 1) -> None:
    if _ACTIVE:
        s = current_scope()
        if s is not None:
            s.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    if _ACTIVE:
        s = current_scope()
        if s is not None:
            s.set_gauge(name, value)


def add_gauge(name: str, value: float) -> None:
    if _ACTIVE:
        s = current_scope()
        if s is not None:
            s.add_gauge(name, value)


def max_gauge(name: str, value: float) -> None:
    if _ACTIVE:
        s = current_scope()
        if s is not None:
            s.max_gauge(name, value)


def observe(name: str, value: float) -> None:
    if _ACTIVE:
        s = current_scope()
        if s is not None:
            s.observe(name, value)


def snapshot() -> Dict[str, dict]:
    s = current_scope() if _ACTIVE else None
    return s.registry.snapshot() if s is not None else {
        "counters": {}, "gauges": {}, "histograms": {}}


def registry() -> Optional[MetricsRegistry]:
    """The current scope's registry, or None with no run active."""
    if not _ACTIVE:
        return None
    s = current_scope()
    return s.registry if s is not None else None
