"""Fixed-memory per-tenant accounting: space-saving heavy hitters (the
port's copy of the JAX package's ``obs/tenants.py``).

A *tenant* in the serving plane is a style — the batcher's exemplar
digest (``sha1(a, ap)[:12]``), already the routing key every request
carries.  Per-tenant QoS ("one viral style must degrade itself, not the
server") needs per-tenant rates and costs, but the tenant
cardinality is unbounded: a pod-scale frontend can present millions of
distinct styles.  Exact per-key dicts would grow without bound, so this
module implements the space-saving sketch (Metwally, Agrawal, El Abbadi
2005): top-K frequency tracking in O(K) memory regardless of stream
cardinality, with a per-key overcount bound (``error``) that makes every
reported count an honest interval ``[count - error, count]``.

:class:`TenantTracker` pairs the sketch with bounded per-tenant
aggregates (requests, dispatch/queue ms, degrades, retries, a latency
histogram) for the currently-tracked keys only — eviction from the
sketch drops the aggregates too, so memory stays O(K) by construction
(the JAX package's tests lock it under a 10k-style synthetic load).

Sketches are mergeable (:func:`merge_docs`): worker-local documents
federate into one top-K whose counts stay within the union's error
bounds.

Host-side bookkeeping on the request path: stdlib only.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from image_analogies_tpu_torch.obs.metrics import Histogram


class SpaceSaving:
    """Top-K counts over an unbounded key stream in O(K) memory.

    ``offer(key)`` either increments a tracked key, fills a free slot,
    or evicts the minimum-count key and inherits its count as the new
    key's ``error`` (the classic space-saving replacement rule).  Any
    key with true frequency > N/K is guaranteed to be tracked."""

    def __init__(self, k: int):
        self.k = max(1, int(k))
        self.offered = 0
        self._counts: Dict[str, float] = {}
        self._errors: Dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._counts)

    def offer(self, key: str, weight: float = 1.0) -> Optional[str]:
        """Count one occurrence of *key*; returns the evicted key when
        tracking *key* displaced another, else None."""
        self.offered += 1
        counts = self._counts
        if key in counts:
            counts[key] += weight
            return None
        if len(counts) < self.k:
            counts[key] = weight
            self._errors[key] = 0.0
            return None
        victim = min(counts, key=counts.get)
        floor = counts.pop(victim)
        self._errors.pop(victim, None)
        counts[key] = floor + weight
        self._errors[key] = floor
        return victim

    def items(self) -> List[Tuple[str, float, float]]:
        """``(key, count, error)`` sorted by count desc.  True frequency
        of each key lies in ``[count - error, count]``."""
        return sorted(
            ((k, c, self._errors.get(k, 0.0))
             for k, c in self._counts.items()),
            key=lambda t: (-t[1], t[0]))

    def merge(self, other: "SpaceSaving") -> None:
        """Fold *other* into this sketch.  Shared keys sum counts and
        errors; foreign keys enter with their remote error plus this
        sketch's current floor (they may have been evicted here), then
        the union is re-trimmed to K — the standard mergeable-summary
        construction, so the federated top-K stays an honest interval."""
        if not len(other):
            self.offered += other.offered
            return
        floor = (min(self._counts.values())
                 if len(self._counts) >= self.k else 0.0)
        for key, count, err in other.items():
            if key in self._counts:
                self._counts[key] += count
                self._errors[key] = self._errors.get(key, 0.0) + err
            else:
                self._counts[key] = floor + count
                self._errors[key] = floor + err
        self.offered += other.offered
        while len(self._counts) > self.k:
            victim = min(self._counts, key=self._counts.get)
            self._counts.pop(victim)
            self._errors.pop(victim, None)


def _blank_stats() -> Dict[str, Any]:
    return {"requests": 0, "errors": 0, "degraded": 0, "retries": 0,
            "throttled": 0, "dispatch_ms": 0.0, "queue_ms": 0.0,
            "lanes": 0, "wire_bytes": 0, "latency": Histogram()}


class TenantTracker:
    """Space-saving sketch + bounded per-tenant aggregates.

    Thread-safe; every structure is bounded by K, so arming this on the
    hot path costs a dict probe and a few float adds per request."""

    def __init__(self, k: int = 16):
        self.k = max(1, int(k))
        self._lock = threading.Lock()
        self._ss = SpaceSaving(self.k)
        self._stats: Dict[str, Dict[str, Any]] = {}

    def observe(self, tenant: str, *, latency_ms: float = 0.0,
                queue_ms: float = 0.0, dispatch_ms: float = 0.0,
                lanes: int = 1, degraded: bool = False, retries: int = 0,
                wire_bytes: int = 0, error: bool = False) -> None:
        with self._lock:
            evicted = self._ss.offer(tenant)
            if evicted is not None:
                self._stats.pop(evicted, None)
            st = self._stats.get(tenant)
            if st is None:
                st = self._stats[tenant] = _blank_stats()
            st["requests"] += 1
            st["errors"] += 1 if error else 0
            st["degraded"] += 1 if degraded else 0
            st["retries"] += retries
            st["dispatch_ms"] += dispatch_ms
            st["queue_ms"] += queue_ms
            st["lanes"] += lanes
            st["wire_bytes"] += wire_bytes
            st["latency"].observe(latency_ms)

    def throttle(self, tenant: str) -> None:
        """Record one quota refusal for *tenant*.  A throttle is NOT a
        request observation (no latency, no cost) — but it does count
        toward the sketch, so a tenant seen only through refusals still
        shows up in the top-K with its THROTTLE tally."""
        with self._lock:
            evicted = self._ss.offer(tenant)
            if evicted is not None:
                self._stats.pop(evicted, None)
            st = self._stats.get(tenant)
            if st is None:
                st = self._stats[tenant] = _blank_stats()
            st["throttled"] += 1

    def merge(self, other: "TenantTracker") -> None:
        with other._lock:
            ss_copy, stats_copy = _copy_locked(other)
        with self._lock:
            self._ss.merge(ss_copy)
            tracked = set(self._ss._counts)
            for tenant, st in stats_copy.items():
                if tenant not in tracked:
                    continue
                mine = self._stats.get(tenant)
                if mine is None:
                    self._stats[tenant] = st
                    continue
                for f in ("requests", "errors", "degraded", "retries",
                          "throttled", "lanes", "wire_bytes"):
                    mine[f] += st.get(f, 0)
                for f in ("dispatch_ms", "queue_ms"):
                    mine[f] += st[f]
                mine["latency"].merge(st["latency"])
            for tenant in list(self._stats):
                if tenant not in tracked:
                    self._stats.pop(tenant)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe document: the ``tenants`` list of the ``/tenants``
        contract (see obs/ledger.py for the full envelope)."""
        with self._lock:
            items = self._ss.items()
            total_cost = sum(st["dispatch_ms"]
                             for st in self._stats.values()) or 0.0
            rows = []
            for tenant, count, err in items:
                st = self._stats.get(tenant) or _blank_stats()
                hist = st["latency"]
                rows.append({
                    "tenant": tenant,
                    "count": count,
                    "count_error": err,
                    "requests": st["requests"],
                    "errors": st["errors"],
                    "degraded": st["degraded"],
                    "retries": st["retries"],
                    "throttled": st.get("throttled", 0),
                    "lanes": st["lanes"],
                    "wire_bytes": st["wire_bytes"],
                    "dispatch_ms": round(st["dispatch_ms"], 3),
                    "queue_ms": round(st["queue_ms"], 3),
                    "cost_share": round(st["dispatch_ms"] / total_cost, 4)
                    if total_cost else 0.0,
                    "p50_ms": round(hist.percentile(50), 3),
                    "p95_ms": round(hist.percentile(95), 3),
                    "latency": hist.summary(),
                })
            return {"k": self.k, "tracked": len(items),
                    "offered": self._ss.offered, "tenants": rows}


def _copy_locked(t: TenantTracker):
    """Deep-enough copies of *t*'s sketch + stats (caller holds t._lock)."""
    ss = SpaceSaving(t._ss.k)
    ss.offered = t._ss.offered
    ss._counts = dict(t._ss._counts)
    ss._errors = dict(t._ss._errors)
    stats = {}
    for tenant, st in t._stats.items():
        cp = {f: st[f] for f in st if f != "latency"}
        h = Histogram()
        h.merge(st["latency"])
        cp["latency"] = h
        stats[tenant] = cp
    return ss, stats


def merge_docs(docs: List[Dict[str, Any]],
               k: Optional[int] = None) -> Dict[str, Any]:
    """Federate per-worker ``snapshot()`` documents into one fleet-level
    top-K (the obs/fleet.py path).  Counts for shared tenants are summed;
    the merged list is re-trimmed to K by count."""
    docs = [d for d in docs if d and d.get("tenants") is not None]
    if not docs:
        return {"k": k or 0, "tracked": 0, "offered": 0, "tenants": []}
    kk = int(k or max(int(d.get("k") or 1) for d in docs))
    merged: Dict[str, Dict[str, Any]] = {}
    offered = 0
    for doc in docs:
        offered += int(doc.get("offered") or 0)
        for row in doc.get("tenants", []):
            t = row.get("tenant")
            cur = merged.get(t)
            if cur is None:
                cur = merged[t] = {**row,
                                   "latency": dict(row.get("latency")
                                                   or {})}
                continue
            for f in ("count", "count_error", "requests", "errors",
                      "degraded", "retries", "throttled", "lanes",
                      "wire_bytes", "dispatch_ms", "queue_ms"):
                cur[f] = (cur.get(f) or 0) + (row.get(f) or 0)
            h = Histogram.from_summary(cur.get("latency") or {})
            h.merge(Histogram.from_summary(row.get("latency") or {}))
            cur["latency"] = h.summary()
            cur["p50_ms"] = round(h.percentile(50), 3)
            cur["p95_ms"] = round(h.percentile(95), 3)
    rows = sorted(merged.values(),
                  key=lambda r: (-(r.get("count") or 0),
                                 r.get("tenant") or ""))[:kk]
    total_cost = sum(r.get("dispatch_ms") or 0.0 for r in rows) or 0.0
    for r in rows:
        r["cost_share"] = (round((r.get("dispatch_ms") or 0.0)
                                 / total_cost, 4) if total_cost else 0.0)
        r["dispatch_ms"] = round(r.get("dispatch_ms") or 0.0, 3)
        r["queue_ms"] = round(r.get("queue_ms") or 0.0, 3)
    return {"k": kk, "tracked": len(rows), "offered": offered,
            "tenants": rows}
