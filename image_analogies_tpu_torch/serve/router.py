"""Consistent-hash request router over a fleet of Server workers (the
port's copy of the JAX package's ``serve/router.py``).

The front half of ROADMAP direction 1: requests hash onto a ring of
virtual nodes keyed by the existing batch key (params digest x shape
bucket x exemplar hash, serve/batcher.py), so same-exemplar traffic
lands on the worker already holding the warm devcache/KD-tree/compiled
programs.  The router never computes — it forwards to
:meth:`serve.fleet.Fleet.forward` and chains the worker future onto its
own, tracking every in-flight request by idempotency key so a dead
worker's futures can be re-answered after the journal handoff
(``Fleet._replace`` -> :meth:`Router.on_worker_replaced`) without the
client ever seeing the death.

Spillover: a gated worker (open breaker / saturated queue, judged by
the fleet health loop) or a hop fault walks the key to its next ring
successor with capped jittered backoff
(:func:`utils.failure.backoff_delay`, jitter seeded from the idem key
so retry timing is deterministic per request).  ``Rejected("poison")``
and ``Rejected("bad_idempotency_key")`` never spill — they are verdicts
about the REQUEST, not the worker, and must stay identical on any
replica.

Ring determinism: positions come from sha256, never ``hash()`` —
``PYTHONHASHSEED`` would scatter affinity across processes.  The two
packages' rings agree on every key string; the keys themselves differ
(the port's batch key digests its ``AnalogyParams``, ``device``
included), so the same request may have another home here than in the
JAX fleet.

Host-side only: the router never touches the card.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.obs import ledger as obs_ledger
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import batcher
from image_analogies_tpu_torch.serve import journal as serve_journal
from image_analogies_tpu_torch.serve.types import Rejected, Response
from image_analogies_tpu_torch.utils import failure


def _point(s: str) -> int:
    """Deterministic 64-bit ring position (sha256 prefix, never hash())."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class Ring:
    """Consistent-hash ring with ``vnodes`` virtual nodes per worker.

    Adding or removing one worker only remaps the keys whose nearest
    vnode belonged to it — every other key keeps its home (the affinity
    property the rebalance test pins)."""

    def __init__(self, vnodes: int = 32):
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []  # sorted (position, wid)
        self._lock = threading.Lock()

    def add(self, wid: str) -> None:
        with self._lock:
            for i in range(self.vnodes):
                bisect.insort(self._points,
                              (_point(f"{wid}#{i}"), wid))

    def remove(self, wid: str) -> None:
        with self._lock:
            self._points = [p for p in self._points if p[1] != wid]

    def members(self) -> List[str]:
        with self._lock:
            return sorted({wid for _, wid in self._points})

    def successors(self, key: str) -> List[str]:
        """Distinct workers in ring order starting at ``key``'s home."""
        with self._lock:
            pts = self._points
            if not pts:
                return []
            start = bisect.bisect_left(pts, (_point(key), ""))
            order: List[str] = []
            seen = set()
            for i in range(len(pts)):
                wid = pts[(start + i) % len(pts)][1]
                if wid not in seen:
                    seen.add(wid)
                    order.append(wid)
            return order


class _Pending:
    """One in-flight routed request: enough to re-submit by idem key."""

    __slots__ = ("idem", "wid", "future", "payload", "deadline_s",
                 "priority")

    def __init__(self, idem: str, wid: str, future: "Future[Response]",
                 payload: Tuple[Any, ...], deadline_s: Optional[float],
                 priority: int = 2):
        self.idem = idem
        self.wid = wid
        self.future = future
        self.payload = payload
        self.deadline_s = deadline_s
        self.priority = priority


def _resolve(fut: "Future[Response]", src: "Future[Response]") -> None:
    """Copy ``src``'s outcome onto ``fut``; first resolution wins.

    Racing resolutions (worker answer vs handoff re-submit) carry
    bit-identical bytes — the engine is deterministic and the journal
    dedupes — so dropping the loser is safe, not a coin flip."""
    if fut.done():
        return
    try:
        exc = src.exception()
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(src.result())
    except InvalidStateError:
        pass


class Router:
    """Hashes requests to workers, tracks in-flight futures by idem key,
    and re-answers stranded requests after a journal handoff."""

    def __init__(self, fleet: "Any", *, vnodes: int = 32,
                 spill_retries: int = 3, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0, decision_log=None):
        self._fleet = fleet
        self.ring = Ring(vnodes)
        self._spill_retries = int(spill_retries)
        self._backoff_s = float(backoff_s)
        self._backoff_cap_s = float(backoff_cap_s)
        self._pending: Dict[str, _Pending] = {}
        self._lock = threading.Lock()
        # Router verdicts can't land in any worker journal (single-
        # writer, often another process) — they persist in the fleet's
        # DecisionLog (serve/journal.py) when one is configured, so
        # `ia why` can attribute spills and re-chains cross-process.
        self._dlog = decision_log

    def _decide(self, idem: Optional[str], verdict: str, cause: str,
                **extra) -> None:
        if self._dlog is not None:
            self._dlog.record(idem, "router", verdict, cause, **extra)
        else:
            obs_ledger.emit_decision("router", verdict, cause,
                                     idem=idem, **extra)

    # ------------------------------------------------------------------
    # submit path

    def submit(self, a: np.ndarray, ap: np.ndarray, b: np.ndarray,
               params=None, deadline_s: Optional[float] = None,
               idempotency_key: Optional[str] = None,
               priority: int = 2) -> "Future[Response]":
        """Route one request to its ring home (spilling as needed) and
        return a router-owned Future chained to the worker's."""
        if (idempotency_key is not None
                and not serve_journal.valid_idem(idempotency_key)):
            obs_metrics.inc("router.rejected")
            raise Rejected("bad_idempotency_key")
        p = params if params is not None else self._fleet.default_params()
        kstr = batcher.key_str(batcher.batch_key(a, ap, b, p))
        idem = idempotency_key or serve_journal.idem_key(
            kstr, np.asarray(b))
        obs_metrics.inc("router.requests")
        fut: "Future[Response]" = Future()
        payload = (a, ap, b, p)
        # Every routing record (router_route / router_spill) and the
        # downstream worker's spans share one trace id: adopt the
        # caller's (the HTTP hop set it from X-IA-Trace) or mint here.
        with obs_trace.ensure_trace("router_submit", origin_request=idem):
            wid, src = self._route(kstr, idem, payload, deadline_s,
                                   priority=priority)
        ent = _Pending(idem, wid, fut, payload, deadline_s,
                       priority=priority)
        with self._lock:
            self._pending[idem] = ent
        self._chain(src, ent)
        return fut

    def home_for_style(self, exemplar_hash: str) -> Optional[str]:
        """Home worker for a STYLE (exemplar sha1), without a batch key.

        Catalog prefetch and operators ask "which worker owns this
        style" before any traffic exists — there is no params digest or
        target shape yet, so this keys the ring on the exemplar hash
        alone (style-grain placement).  Request routing stays at
        batch-key grain (`submit`), but both walk the SAME ring, so
        membership changes move prefetch placement and traffic
        consistently.  Health gates are ignored on purpose: placement
        answers ownership, not this-instant dispatchability.  None when
        the ring is empty."""
        order = self.ring.successors(exemplar_hash)
        return order[0] if order else None

    def _route(self, kstr: str, idem: str, payload: Tuple[Any, ...],
               deadline_s: Optional[float], priority: int = 2
               ) -> Tuple[str, "Future[Response]"]:
        """Walk ring successors with capped jittered backoff until one
        worker accepts the forward."""
        a, ap, b, p = payload
        jseed = _point(idem) & 0x7FFFFFFF
        last: Optional[BaseException] = None
        for attempt in range(self._spill_retries + 1):
            if attempt:
                time.sleep(failure.backoff_delay(
                    attempt, backoff_s=self._backoff_s,
                    backoff_cap_s=self._backoff_cap_s, jitter_seed=jseed))
            order = self.ring.successors(kstr)
            if not order:
                obs_metrics.inc("router.rejected")
                raise Rejected("fleet_empty")
            ungated = [w for w in order if not self._fleet.gated(w)]
            if not ungated:
                # Everything gated this instant — back off and re-poll;
                # the health loop clears gates as breakers close.
                if last is None:
                    last = Rejected("fleet_saturated")
                continue
            wid = ungated[attempt % len(ungated)]
            if wid != order[0]:
                obs_metrics.inc("router.spills")
                obs_trace.emit_record({"event": "router_spill",
                                       "idem": idem, "home": order[0],
                                       "to": wid, "attempt": attempt})
                self._decide(idem, "spill",
                             "home_gated" if order[0] not in ungated
                             else "hop_fault",
                             home=order[0], to=wid)
            try:
                chaos.site("router.forward", worker=wid, key=kstr)
                src = self._fleet.forward(wid, a, ap, b, p,
                                          deadline_s, idem,
                                          priority=priority)
                obs_metrics.inc("router.routed.{}".format(wid))
                obs_trace.emit_record({"event": "router_route",
                                       "idem": idem, "worker": wid,
                                       "key": kstr, "attempt": attempt})
                return wid, src
            except chaos.ProcessDeath:
                raise  # the ROUTER process dying is never contained
            except Rejected as exc:
                if exc.reason in ("poison", "bad_idempotency_key",
                                  "quota"):
                    # Verdicts about the request, not the worker: every
                    # replica would answer the same — never spill.  A
                    # quota refusal especially: spilling the viral
                    # tenant to ring successors would hand it exactly
                    # the fleet-wide capacity the quota exists to cap.
                    obs_metrics.inc("router.rejected")
                    raise
                last = exc
            except Exception as exc:  # noqa: BLE001 - hop fault, retry
                last = exc
            obs_metrics.inc("router.hop_faults")
        obs_metrics.inc("router.rejected")
        if isinstance(last, Rejected):
            raise last
        raise Rejected("fleet_unavailable")

    def _chain(self, src: "Future[Response]", ent: _Pending) -> None:
        """Resolve the router future from the worker future; unregister
        the pending entry once the answer lands."""

        def _done(f: "Future[Response]") -> None:
            with self._lock:
                if self._pending.get(ent.idem) is ent:
                    del self._pending[ent.idem]
            _resolve(ent.future, f)

        src.add_done_callback(_done)

    # ------------------------------------------------------------------
    # handoff path

    def pending_for(self, wid: str) -> List[_Pending]:
        with self._lock:
            return [e for e in self._pending.values()
                    if e.wid == wid and not e.future.done()]

    def on_worker_replaced(self, wid: str, handle: "Any") -> None:
        """Re-answer requests stranded on a dead worker.

        Entries whose idem key the replacement's ``recover()`` replayed
        chain onto the recovery future directly; everything else is
        re-forwarded by idem key — the journal's done-dedupe makes the
        re-submit exactly-once even when the original answer raced the
        death."""
        for ent in self.pending_for(wid):
            rec = handle.recovery_future(ent.idem)
            if rec is not None:
                obs_metrics.inc("router.rechained")
                obs_trace.emit_record({"event": "router_rechain",
                                       "idem": ent.idem, "worker": wid})
                self._decide(ent.idem, "rechain", "handoff_recovery",
                             worker_id=wid)
                self._chain(rec, ent)
                continue
            obs_metrics.inc("router.resubmitted")
            obs_trace.emit_record({"event": "router_resubmit",
                                   "idem": ent.idem, "worker": wid})
            self._decide(ent.idem, "resubmit", "handoff_not_replayed",
                         worker_id=wid)
            a, ap, b, p = ent.payload
            try:
                src = self._fleet.forward(wid, a, ap, b, p,
                                          ent.deadline_s, ent.idem,
                                          priority=ent.priority)
            except BaseException as exc:  # noqa: BLE001 - surfaced
                if not ent.future.done():
                    try:
                        ent.future.set_exception(exc)
                    except InvalidStateError:
                        pass
                with self._lock:
                    if self._pending.get(ent.idem) is ent:
                        del self._pending[ent.idem]
                continue
            self._chain(src, ent)

    def fail_pending(self, wid: str, exc: BaseException) -> int:
        """Terminal verdict for every request stranded on ``wid`` when
        NO replacement is coming (crash-loop parked slot): hanging the
        futures would strand clients forever.  Returns how many were
        failed."""
        failed = 0
        for ent in self.pending_for(wid):
            try:
                ent.future.set_exception(exc)
                failed += 1
                self._decide(ent.idem, "fail_pending", "crash_loop_gate",
                             worker_id=wid)
            except InvalidStateError:
                pass
            with self._lock:
                if self._pending.get(ent.idem) is ent:
                    del self._pending[ent.idem]
        if failed:
            obs_metrics.inc("router.failed_pending", failed)
        return failed

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)
