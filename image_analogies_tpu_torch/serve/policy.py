"""Declarative control-plane policy: autoscaling targets + per-tenant
QoS, as plain JSON (the port's copy of the JAX package's
``serve/policy.py``).

Two documents live here:

- :class:`ControlPolicy` — what the elastic fleet should look like
  (min/max workers, queue-depth / p95 / SLO-burn targets, hysteresis
  windows, cooldowns).  serve/control.py's reconcile loop reads ONLY
  this policy plus observed signals; it never invents thresholds.
- :class:`QosPolicy` — how one tenant's traffic may degrade itself
  rather than the server: per-style token-bucket admission quotas (fed
  by the tenants sketch's observed cost shares), weighted-fair queue pop
  across tenants, and priority-class weights.

Both round-trip to plain JSON (``to_json`` / ``from_json``; the control
policy also ``load``s a file), and a file written by either package loads
in the other.  :class:`TenantQuota` is the runtime half of the quota
story: a bounded dict of token buckets with an injectable clock,
throttled by observed cost share (a tenant consuming more than
``share_cap`` of the dispatch cost has its refill scaled down in
proportion).

Host-side only: nothing here touches the card.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, Optional

# Priority classes: Request.priority holds one of these weights.  The
# weight is the tenant's stride-scheduling share in the weighted-fair
# queue — interactive traffic advances 4x for every background step.
PRIORITY_BACKGROUND = 1
PRIORITY_STANDARD = 2
PRIORITY_INTERACTIVE = 4

PRIORITY_CLASSES: Dict[str, int] = {
    "background": PRIORITY_BACKGROUND,
    "standard": PRIORITY_STANDARD,
    "interactive": PRIORITY_INTERACTIVE,
}


@dataclasses.dataclass(frozen=True)
class QosPolicy:
    """Per-tenant QoS knobs for one worker's admission path.

    ``quota_rps``       per-tenant token refill rate (tokens/sec); 0
                        disables admission quotas entirely.
    ``quota_burst``     bucket capacity (burst allowance).
    ``share_cap``       observed-cost-share ceiling: a tenant whose
                        ledger ``cost_share`` exceeds this fraction has
                        its refill scaled by ``share_cap / share`` — the
                        viral style throttles harder as it gets hotter.
    ``share_refresh_s`` how often the bucket re-reads the tenants
                        sketch.
    ``weighted_fair``   stride-scheduled leader pick across tenants in
                        ``pop_batch`` (anti-starvation aging still
                        applies on top).
    ``max_tenants``     bound on tracked buckets (oldest evicted).
    """

    quota_rps: float = 0.0
    quota_burst: float = 8.0
    share_cap: float = 0.5
    share_refresh_s: float = 0.5
    weighted_fair: bool = True
    max_tenants: int = 64

    def __post_init__(self):
        if self.quota_rps < 0:
            raise ValueError("quota_rps must be >= 0")
        if self.quota_burst < 1:
            raise ValueError("quota_burst must be >= 1")
        if not 0.0 < self.share_cap <= 1.0:
            raise ValueError("share_cap must be in (0, 1]")
        if self.share_refresh_s <= 0:
            raise ValueError("share_refresh_s must be > 0")
        if self.max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "QosPolicy":
        if not isinstance(doc, dict):
            raise ValueError("qos policy must be a JSON object")
        known = {f.name for f in dataclasses.fields(QosPolicy)}
        extra = set(doc) - known
        if extra:
            raise ValueError(f"unknown qos policy fields: {sorted(extra)}")
        return QosPolicy(**doc)


@dataclasses.dataclass(frozen=True)
class ControlPolicy:
    """Declarative autoscaling targets for one fleet.

    Scale-up arms when ANY pressure signal holds for
    ``scale_up_windows`` consecutive reconcile passes: mean ready-worker
    queue depth >= ``queue_high``, fast SLO burn rate >=
    ``max_burn_rate``, or windowed p95 >= ``target_p95_ms`` (when set).
    Scale-down arms when mean depth <= ``queue_low`` AND burn is below
    target for ``scale_down_windows`` passes.  Each direction has its
    own cooldown so the fleet breathes instead of oscillating.
    """

    min_workers: int = 1
    max_workers: int = 4
    queue_high: float = 4.0
    queue_low: float = 0.5
    max_burn_rate: float = 2.0
    target_p95_ms: float = 0.0          # 0 = p95 signal disabled
    scale_up_windows: int = 2
    scale_down_windows: int = 4
    scale_up_cooldown_s: float = 1.0
    scale_down_cooldown_s: float = 2.0

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if self.queue_high <= 0 or self.queue_low < 0:
            raise ValueError("queue_high must be > 0, queue_low >= 0")
        if self.queue_low >= self.queue_high:
            raise ValueError("queue_low must be < queue_high")
        if self.max_burn_rate <= 0:
            raise ValueError("max_burn_rate must be > 0")
        if self.target_p95_ms < 0:
            raise ValueError("target_p95_ms must be >= 0")
        if self.scale_up_windows < 1 or self.scale_down_windows < 1:
            raise ValueError("hysteresis windows must be >= 1")
        if self.scale_up_cooldown_s < 0 or self.scale_down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "ControlPolicy":
        if not isinstance(doc, dict):
            raise ValueError("control policy must be a JSON object")
        known = {f.name for f in dataclasses.fields(ControlPolicy)}
        extra = set(doc) - known
        if extra:
            raise ValueError(
                f"unknown control policy fields: {sorted(extra)}")
        return ControlPolicy(**doc)

    @staticmethod
    def load(path: str) -> "ControlPolicy":
        with open(path) as f:
            return ControlPolicy.from_json(json.load(f))


class TenantQuota:
    """Per-tenant token buckets fed by observed cost shares.

    ``try_admit(tenant)`` spends one token from the tenant's bucket and
    reports whether the request may enter the queue.  Refill is
    ``quota_rps`` scaled DOWN when the tenants sketch says the tenant
    already consumes more than ``share_cap`` of observed dispatch cost:
    effective_rps = quota_rps * min(1, share_cap / cost_share).  The
    share map refreshes at most every ``share_refresh_s`` through the
    injected ``shares_fn`` (a callable returning the ledger's
    ``/tenants`` document), so the hot path stays a dict probe plus a
    couple of float ops.

    The clock is injectable for deterministic tests; buckets are
    bounded by ``max_tenants`` (least-recently-admitted evicted).
    """

    def __init__(self, policy: QosPolicy, shares_fn=None,
                 clock=time.monotonic):
        self.policy = policy
        self._shares_fn = shares_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, Dict[str, float]] = {}
        self._shares: Dict[str, float] = {}
        self._shares_t = -float("inf")
        self.throttled = 0

    def _refresh_shares_locked(self, now: float) -> None:
        if self._shares_fn is None:
            return
        if now - self._shares_t < self.policy.share_refresh_s:
            return
        self._shares_t = now
        try:
            doc = self._shares_fn() or {}
        except Exception:  # noqa: BLE001 - shares are advisory
            return
        self._shares = {
            str(row.get("tenant")): float(row.get("cost_share") or 0.0)
            for row in doc.get("tenants", [])}

    def effective_rps(self, tenant: str) -> float:
        """Refill rate after the cost-share penalty (0 disables)."""
        share = self._shares.get(tenant, 0.0)
        rps = self.policy.quota_rps
        if share > self.policy.share_cap:
            rps *= self.policy.share_cap / share
        return rps

    def try_admit(self, tenant: str) -> bool:
        if self.policy.quota_rps <= 0:
            return True
        now = self._clock()
        with self._lock:
            self._refresh_shares_locked(now)
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= self.policy.max_tenants:
                    oldest = min(self._buckets,
                                 key=lambda t: self._buckets[t]["t"])
                    self._buckets.pop(oldest)
                bucket = self._buckets[tenant] = {
                    "tokens": float(self.policy.quota_burst), "t": now}
            else:
                elapsed = max(0.0, now - bucket["t"])
                bucket["tokens"] = min(
                    float(self.policy.quota_burst),
                    bucket["tokens"] + elapsed * self.effective_rps(tenant))
                bucket["t"] = now
            if bucket["tokens"] >= 1.0:
                bucket["tokens"] -= 1.0
                return True
            self.throttled += 1
            return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "throttled": self.throttled,
                "tenants": {
                    t: {"tokens": round(b["tokens"], 3),
                        "effective_rps": round(self.effective_rps(t), 4)}
                    for t, b in self._buckets.items()},
            }
