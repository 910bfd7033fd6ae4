"""Tenant-scoped metering plane: per-request cost vectors + decisions.

The port's copy of the JAX package's ``obs/ledger.py``.  Three planes in
one module, all host-side and torch-free:

**Cost ledger.**  serve/worker.py assembles one *cost vector* per
completed dispatch — queue wait, device/dispatch ms, batch lanes shared,
degrade steps, retries, ANN/catalog engagement, wire bytes — stamped
with the tenant key (the batcher exemplar sha1: style == tenant) and the
trace id.  Vectors land in a bounded in-memory deque (:class:`Ledger`)
and, when a request journal is armed, as sealed ``cost`` records beside
the request's own transitions (serve/journal.py), so `ia why` can read
them back offline.

**Heavy hitters.**  Each vector feeds the fixed-memory
:class:`~image_analogies_tpu_torch.obs.tenants.TenantTracker` (space-saving
top-K), whose document is the ``/tenants`` endpoint contract::

    {"armed": true, "capacity": N, "recorded": n, "uptime_s": s,
     "k": K, "tracked": t, "offered": n,
     "tenants": [{"tenant", "count", "count_error", "requests",
                  "degraded", "retries", "errors", "lanes",
                  "wire_bytes", "dispatch_ms", "queue_ms",
                  "cost_share", "p50_ms", "p95_ms", "qps",
                  "latency": <histogram summary>}, ...]}

:func:`sample_timeline` mirrors the tracked tenants into the
timeline store as ``tenant:<sha1[:8]>``-labeled series (cumulative
counters + latency histograms, so the timeline's delta logic and
per-worker anomaly detector fire per-tenant with no changes).

**Decision attribution.**  :func:`emit_decision` is the single funnel
for control-plane verdicts (degrade, shed, spill, poison, dedupe,
handoff re-chain, ...): it bumps ``serve.decision.<verdict>`` and emits
a ``serve_decision`` trace record carrying cause + site + trace id.
Journal-side persistence is the caller's job (journal.record_decision /
DecisionLog) so this module stays import-light on the request path.

Armed/disarmed module plane mirrors obs/timeline.py: one bool check
when disarmed, zero allocations (tracemalloc-locked in tests), arm()
nests across owners.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import timeline as _timeline
from image_analogies_tpu_torch.obs import trace as _trace
from image_analogies_tpu_torch.obs.tenants import TenantTracker


class Ledger:
    """Bounded in-memory cost-vector store + tenant tracker."""

    def __init__(self, capacity: int = 512, tenant_k: int = 16):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._vecs: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._recorded = 0
        self._t0 = time.monotonic()
        self.tenants = TenantTracker(tenant_k)

    def record(self, vec: Dict[str, Any]) -> None:
        with self._lock:
            self._vecs.append(vec)
            self._recorded += 1
        tenant = vec.get("tenant")
        if tenant:
            self.tenants.observe(
                str(tenant),
                latency_ms=float(vec.get("total_ms") or 0.0),
                queue_ms=float(vec.get("queue_ms") or 0.0),
                dispatch_ms=float(vec.get("dispatch_ms") or 0.0),
                lanes=int(vec.get("lanes") or 1),
                degraded=bool(vec.get("degrade_levels")),
                retries=int(vec.get("retries") or 0),
                wire_bytes=int(vec.get("wire_bytes") or 0),
                error=vec.get("status") not in (None, "ok"))

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            vecs = list(self._vecs)
        return vecs if n is None else vecs[-n:]

    def tenants_doc(self) -> Dict[str, Any]:
        doc = self.tenants.snapshot()
        uptime = max(time.monotonic() - self._t0, 1e-9)
        for row in doc["tenants"]:
            row["qps"] = round(row["requests"] / uptime, 4)
        with self._lock:
            recorded = self._recorded
        doc.update(armed=True, capacity=self.capacity,
                   recorded=recorded, uptime_s=round(uptime, 3))
        return doc


# --- module-level armed plane ------------------------------------------------
#
# Mirrors obs/timeline.py: _ARMED is one bool, every producer helper
# checks it FIRST — the disarmed path allocates nothing (tracemalloc-
# locked in tests/test_ledger.py).  arm() nests across owners.

_ARMED = False
_ARM_LOCK = threading.Lock()
_ARM_COUNT = 0
_LEDGER: Optional[Ledger] = None


def arm(ledger: Optional[Ledger] = None, **kwargs: Any) -> Ledger:
    """Install (or join) the process ledger; registers the timeline
    feeder so a running sampler mirrors per-tenant series."""
    global _ARMED, _ARM_COUNT, _LEDGER
    with _ARM_LOCK:
        if _LEDGER is None:
            _LEDGER = ledger if ledger is not None else Ledger(**kwargs)
            _timeline.register_feeder(sample_timeline)
        _ARM_COUNT += 1
        _ARMED = True
        return _LEDGER


def disarm() -> None:
    global _ARMED, _ARM_COUNT, _LEDGER
    with _ARM_LOCK:
        _ARM_COUNT = max(_ARM_COUNT - 1, 0)
        if _ARM_COUNT == 0:
            _LEDGER = None
            _ARMED = False
            _timeline.unregister_feeder(sample_timeline)


def armed() -> bool:
    return _ARMED


def current() -> Optional[Ledger]:
    return _LEDGER if _ARMED else None


def record(vec: Dict[str, Any]) -> None:
    """Producer fast path: one bool check when disarmed."""
    if not _ARMED:
        return
    led = _LEDGER
    if led is not None:
        led.record(vec)


def tenants_doc() -> Dict[str, Any]:
    led = _LEDGER if _ARMED else None
    if led is None:
        return {"armed": False, "k": 0, "tracked": 0, "offered": 0,
                "recorded": 0, "tenants": []}
    return led.tenants_doc()


def record_throttle(tenant: str) -> None:
    """Producer fast path for a quota refusal: one bool check when
    disarmed, else a sketch offer + per-tenant THROTTLE increment."""
    if not _ARMED:
        return
    led = _LEDGER
    if led is not None and tenant:
        led.tenants.throttle(str(tenant))


def sample_timeline() -> None:
    """Mirror tracked tenants into the armed timeline store as
    ``tenant:<sha1[:8]>``-labeled series.  Counters/histograms are
    cumulative; the timeline's delta + generation-reset logic windows
    them exactly like ``w<N>:`` worker series, so `ia top` and the
    anomaly detector get a per-tenant view for free."""
    if not _ARMED:
        return
    led = _LEDGER
    tl = _timeline.current()
    if led is None or tl is None:
        return
    for row in led.tenants.snapshot()["tenants"]:
        label = f"tenant:{str(row['tenant'])[:8]}"
        snap = {
            "counters": {
                "serve.completed": row["requests"],
                "serve.errors": row["errors"],
                "serve.degraded": row["degraded"],
            },
            "gauges": {},
            "histograms": {"serve.latency_ms": row["latency"]},
        }
        tl.sample_snapshot(snap, worker=label)


def emit_decision(site: str, verdict: str, cause: Optional[str] = None,
                  idem: Optional[str] = None, **extra: Any) -> None:
    """The decision-attribution funnel: every control-plane verdict that
    shapes a request's fate goes through here (counter + trace record).
    Callers with a journal additionally persist a sealed ``decision``
    line (journal.record_decision / DecisionLog.record) for `ia why`."""
    _metrics.inc(f"serve.decision.{verdict}")
    rec = {"event": "serve_decision", "site": site, "verdict": verdict}
    if cause is not None:
        rec["cause"] = cause
    if idem is not None:
        rec["idem"] = idem
    if extra:
        rec.update(extra)
    _trace.emit_record(rec)
    from image_analogies_tpu_torch.obs import archive as _archive
    _archive.record("decision", rec)


# --- rendering (`ia top --tenants` and tests share it) -----------------------

def render_tenants(doc: Dict[str, Any], title: str = "tenants") -> str:
    """Pure text rendering of a ``/tenants`` document."""
    doc = doc or {}
    lines = []
    armed = bool(doc.get("armed", False))
    header = (f"ia top — {title}  "
              f"[k={doc.get('k', 0)} tracked={doc.get('tracked', 0)} "
              f"offered={doc.get('offered', 0)} "
              f"recorded={doc.get('recorded', 0)}]")
    lines.append(header)
    if not armed and not doc.get("tenants"):
        lines.append("  (ledger disarmed — start serving with the "
                     "metering plane on)")
        return "\n".join(lines) + "\n"
    lines.append(f"  {'TENANT':<14}{'REQS':>7}{'QPS':>10}{'P95MS':>9}"
                 f"{'COST%':>7}{'DEGR':>6}{'RETRY':>6}{'THROT':>6}"
                 f"{'ERR':>5}{'±ERR':>6}")
    for row in doc.get("tenants", []):
        lines.append(
            f"  {str(row.get('tenant', '?'))[:12]:<14}"
            f"{row.get('requests', 0):>7}"
            f"{row.get('qps', 0.0):>10.2f}"
            f"{row.get('p95_ms', 0.0):>9.1f}"
            f"{100.0 * (row.get('cost_share') or 0.0):>6.1f}%"
            f"{row.get('degraded', 0):>6}"
            f"{row.get('retries', 0):>6}"
            f"{row.get('throttled', 0):>6}"
            f"{row.get('errors', 0):>5}"
            f"{row.get('count_error', 0.0):>6.0f}")
    if not doc.get("tenants"):
        lines.append("  (no tenants observed yet)")
    return "\n".join(lines) + "\n"
