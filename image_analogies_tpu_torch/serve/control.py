"""Elastic-fleet control plane: spawn / retire / gate verdicts (the
port's copy of the JAX package's ``serve/control.py``).

Extracted from the fleet health daemon (serve/fleet.py) so POLICY lives
in one place and MECHANISM stays in the fleet: the health loop polls
worker health docs on its jittered cadence and hands them here; this
module renders the verdicts.

Two verdict families:

- :meth:`ControlPlane.gate_verdict` — the per-worker judgement the
  health daemon used to own inline (``Fleet._judge``): None = healthy,
  ``"dead"`` = missed liveness, else an advisory gate reason
  (``breaker_open`` / ``saturated``) that makes the router spill.
- :meth:`ControlPlane.reconcile` — the autoscaling loop (armed only
  when ``FleetConfig.policy`` is set).  It reads ONLY observed signals
  — per-worker queue depths and SLO burn rates from the health docs,
  windowed p95 from the timeline plane — compares them against the
  declarative :class:`~.policy.ControlPolicy`, and acts through the
  fleet's existing primitives: scale-up is ``Fleet._spawn`` + ring join
  + ``catalog warm`` pre-staging (cold builds never land in the request
  path); scale-down gates, ring-leaves, and retires the emptiest worker
  — never one holding inflight work, queued requests, or an unreplayed
  journal.

Every verdict that changes the fleet flows through the decision plane
(sealed DecisionLog line + ``serve.decision.*`` counter + trace
record) under a deterministic idem key ``ctl-<verdict>-<wid>``, so
``ia why ctl-scale_up-w2 --root <journal root>`` attributes each scale
event after the fact.

Host-side only: nothing here touches the card (the serve lock test
scans this file).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

from image_analogies_tpu_torch.obs import ledger as obs_ledger
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import timeline as obs_timeline
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve.policy import ControlPolicy


class ControlPlane:
    """Owns the fleet's spawn/retire/gate verdicts.

    Constructed by :class:`~.fleet.Fleet` for every fleet (the gate
    verdict is unconditional); the reconcile loop runs only when a
    :class:`ControlPolicy` is attached.  All methods are called from
    the fleet's health-daemon thread; cross-thread readers go through
    :meth:`status`.
    """

    def __init__(self, fleet, policy: Optional[ControlPolicy] = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.policy = policy
        self._clock = clock
        self._over = 0          # consecutive passes with scale-up pressure
        self._idle = 0          # consecutive passes idle enough to shrink
        self._last_up = -float("inf")
        self._last_down = -float("inf")
        self.events: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=64)

    # ------------------------------------------------------------------
    # per-worker gate verdicts (extracted Fleet._judge)

    def gate_verdict(self, h: Optional[Dict[str, Any]]) -> Optional[str]:
        """None = healthy; "dead" = missed; else an advisory gate
        reason.  *h* is the worker's health doc, or None when the
        health call itself raised (unresponsive counts as dead)."""
        if h is None:
            return "dead"
        workers = h.get("workers") or {}
        if not h.get("accepting") or workers.get("alive", 0) == 0:
            return "dead"
        if h.get("recovering"):
            # Alive but not READY: journal replay in flight.  Liveness
            # gates the death verdict, and no advisory gate either —
            # spilling keys whose replay is about to answer them would
            # double-compute work the journal already holds.
            return None
        breakers = h.get("breakers") or {}
        if any(state == "open" for state in breakers.values()):
            return "breaker_open"
        cfg = self.fleet.cfg
        depth_gate = cfg.spill_queue_frac * cfg.serve.queue_depth
        if h.get("queue_depth", 0) >= depth_gate:
            return "saturated"
        return None

    # ------------------------------------------------------------------
    # observed signals

    @staticmethod
    def _timeline_p95() -> Optional[float]:
        """Worst per-worker windowed p95 from the timeline plane, or
        None when the plane is disarmed / has no latency points yet."""
        tl = obs_timeline.current()
        if tl is None:
            return None
        worst = None
        try:
            doc = tl.to_json()
        except Exception:  # noqa: BLE001 - timeline is advisory here
            return None
        for key, ent in (doc.get("series") or {}).items():
            if not key.endswith("serve.latency_ms"):
                continue
            points = ent.get("points") or []
            if not points:
                continue
            v = points[-1][1]
            if isinstance(v, dict) and v.get("p95") is not None:
                p95 = float(v["p95"])
                worst = p95 if worst is None else max(worst, p95)
        return worst

    def signals(self, healths: Dict[str, Optional[Dict[str, Any]]]
                ) -> Dict[str, Any]:
        """Digest one polling pass's health docs into the signal vector
        the policy is compared against."""
        ready = [h for h in healths.values()
                 if h and h.get("ok") and not h.get("recovering")]
        depths = [float(h.get("queue_depth") or 0) for h in ready]
        burns = [float((h.get("slo") or {}).get("burn_rate_fast") or 0.0)
                 for h in ready]
        open_breakers = sum(
            1 for h in ready
            if any(s == "open" for s in (h.get("breakers") or {}).values()))
        return {
            "size": len(healths),
            "ready": len(ready),
            "mean_depth": (sum(depths) / len(depths)) if depths else 0.0,
            "max_burn": max(burns) if burns else 0.0,
            "open_breakers": open_breakers,
            "p95_ms": self._timeline_p95(),
        }

    # ------------------------------------------------------------------
    # reconcile

    def _pressure(self, sig: Dict[str, Any]) -> Optional[str]:
        """Scale-up cause, or None when no signal is over target."""
        pol = self.policy
        if sig["mean_depth"] >= pol.queue_high:
            return "queue_pressure"
        if sig["max_burn"] >= pol.max_burn_rate:
            return "burn_rate"
        if pol.target_p95_ms and sig["p95_ms"] is not None \
                and sig["p95_ms"] >= pol.target_p95_ms:
            return "p95_target"
        return None

    def _calm(self, sig: Dict[str, Any]) -> bool:
        pol = self.policy
        return (sig["mean_depth"] <= pol.queue_low
                and sig["max_burn"] < pol.max_burn_rate
                and sig["open_breakers"] == 0)

    def reconcile(self, healths: Dict[str, Optional[Dict[str, Any]]]
                  ) -> Optional[Dict[str, Any]]:
        """One policy pass over one polling pass's health docs.  Returns
        the verdict record when the fleet changed, else None."""
        if self.policy is None:
            return None
        sig = self.signals(healths)
        now = self._clock()
        cause = self._pressure(sig)
        if cause is not None:
            self._over += 1
            self._idle = 0
        elif self._calm(sig):
            self._idle += 1
            self._over = 0
        else:
            self._over = 0
            self._idle = 0
        size = len(self.fleet.workers)
        if (cause is not None and self._over >= self.policy.scale_up_windows
                and size < self.policy.max_workers
                and now - self._last_up >= self.policy.scale_up_cooldown_s):
            self._over = 0
            self._last_up = now
            return self.scale_up(cause, signals=sig)
        if (self._idle >= self.policy.scale_down_windows
                and size > self.policy.min_workers
                and now - self._last_down
                >= self.policy.scale_down_cooldown_s):
            wid = self._pick_retire(healths)
            if wid is None:
                return None  # nobody is safely retireable; stay armed
            self._idle = 0
            self._last_down = now
            return self.scale_down(wid, "idle", signals=sig)
        return None

    # ------------------------------------------------------------------
    # actions (mechanism stays in the fleet; this orders it)

    def _next_wid(self) -> str:
        i = 0
        while "w{}".format(i) in self.fleet.workers:
            i += 1
        return "w{}".format(i)

    def scale_up(self, cause: str,
                 signals: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """Spawn one worker: ``Fleet._spawn`` + ring join + catalog
        pre-staging of the joining worker's home styles, so its first
        home-style request finds warm tiers instead of a cold build."""
        fleet = self.fleet
        wid = self._next_wid()
        t0 = time.monotonic()
        fleet._spawn(wid, generation=0)
        fleet.router.ring.add(wid)
        # Warm BEFORE recording the verdict: the verdict marks the
        # moment the worker is fully in service, not merely spawned.
        from image_analogies_tpu_torch.catalog import tiers as catalog_tiers

        warmed = None
        if catalog_tiers.active():
            warmed = catalog_tiers.warm_for_fleet(
                fleet.router, only_worker=wid)
        return self._record("scale_up", cause, wid,
                            spawn_ms=round((time.monotonic() - t0) * 1e3, 3),
                            warmed_entries=(warmed or {}).get("entries"),
                            signals=signals)

    def _retireable(self, wid: str, h: Optional[Dict[str, Any]]) -> bool:
        """Safe-to-retire: alive, nothing queued, nothing inflight, no
        unreplayed journal entries, and the router holds no pending
        futures for it.  A worker failing ANY of these keeps its slot —
        retiring it would strand accepted work."""
        if h is None or not h.get("ok") or h.get("recovering"):
            return False
        if h.get("queue_depth", 0) or h.get("inflight", 0):
            return False
        journal = h.get("journal") or {}
        if isinstance(journal, dict) and journal.get("admitted") is not None:
            done = (int(journal.get("done") or 0)
                    + int(journal.get("deduped") or 0)
                    + int(journal.get("rejected") or 0)
                    + int(journal.get("poisoned") or 0))
            if int(journal.get("admitted") or 0) > done:
                return False
        if self.fleet.router.pending_for(wid):
            return False
        return True

    def _pick_retire(self, healths: Dict[str, Optional[Dict[str, Any]]]
                     ) -> Optional[str]:
        """The emptiest retireable worker (ties: highest index, so the
        fleet shrinks from the top and w0's journal root stays put)."""
        candidates = [wid for wid, h in healths.items()
                      if self._retireable(wid, h)]
        if not candidates:
            return None
        return sorted(
            candidates,
            key=lambda w: (
                (healths[w] or {}).get("queue_depth", 0),
                -int(w[1:]) if w[1:].isdigit() else 0))[0]

    def scale_down(self, wid: str, cause: str,
                   signals: Optional[Dict[str, Any]] = None
                   ) -> Optional[Dict[str, Any]]:
        """Drain and retire *wid*: gate (router spills away), ring-leave
        (successors inherit its keys), re-verify emptiness, then shut
        the handle down.  Aborts — fully restoring membership — if
        traffic raced in between the checks."""
        fleet = self.fleet
        handle = fleet.workers.get(wid)
        if handle is None:
            return None
        fleet.gate_worker(wid, "retiring")
        fleet.router.ring.remove(wid)
        try:
            h = handle.health()
        except Exception:  # noqa: BLE001 - dying during retire is fine
            h = None
        raced = (h is None or h.get("queue_depth", 0) or h.get("inflight", 0)
                 or fleet.router.pending_for(wid))
        if raced:
            fleet.router.ring.add(wid)
            fleet.ungate_worker(wid)
            self._record("scale_down_abort", "raced_traffic", wid,
                         signals=signals)
            return None
        # Membership is gone from the ring and the gate blocks spills,
        # so no new work can reach the handle: drop it from the worker
        # map FIRST (a racing forward now raises and the router spills
        # to a live successor), then drain-shutdown the empty server.
        with fleet._lock:
            fleet.workers.pop(wid, None)
            fleet._misses.pop(wid, None)
            fleet._scrapes.pop(wid, None)
            fleet._gates.pop(wid, None)
        handle.shutdown()
        return self._record("scale_down", cause, wid, signals=signals)

    # ------------------------------------------------------------------
    # decision plane

    def _record(self, verdict: str, cause: str, wid: str,
                **extra: Any) -> Dict[str, Any]:
        signals = extra.pop("signals", None) or {}
        size = len(self.fleet.workers)
        obs_metrics.inc("control.{}".format(verdict))
        obs_metrics.set_gauge("control.size", size)
        fields = {"worker_id": wid, "size": size,
                  "mean_depth": round(signals.get("mean_depth", 0.0), 3),
                  "max_burn": round(signals.get("max_burn", 0.0), 4)}
        fields.update({k: v for k, v in extra.items() if v is not None})
        # Deterministic idem key: `ia why ctl-scale_up-w2` reconstructs
        # the event from the sealed decision log after the fact.
        idem = "ctl-{}-{}".format(verdict, wid)
        if self.fleet.decisions is not None:
            self.fleet.decisions.record(idem, "control", verdict, cause,
                                        **fields)
        else:
            obs_ledger.emit_decision("control", verdict, cause, idem=idem,
                                     **fields)
        obs_trace.emit_record({"event": "control_verdict",
                               "verdict": verdict, "cause": cause,
                               "worker": wid, "size": size})
        rec = {"t": round(self._clock(), 3), "verdict": verdict,
               "cause": cause, "worker": wid, "size": size}
        self.events.append(rec)
        return rec

    # ------------------------------------------------------------------
    # status (for /healthz and `ia top`)

    def status(self) -> Dict[str, Any]:
        last: Optional[Dict[str, Any]] = None
        events: List[Dict[str, Any]] = list(self.events)
        if events:
            last = events[-1]
        doc: Dict[str, Any] = {
            "autoscale": self.policy is not None,
            "size": len(self.fleet.workers),
            "last_verdict": last,
            "events": len(events),
        }
        if self.policy is not None:
            doc["policy"] = self.policy.to_json()
        return doc
