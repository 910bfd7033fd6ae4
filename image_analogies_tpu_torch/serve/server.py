"""Server lifecycle + in-process Client API (the port's copy of the JAX
package's ``serve/server.py``).

Lifecycle contract:

1. ``start()`` opens one obs run scope for the whole server lifetime
   (worker threads join it reentrantly — every request's spans, records,
   and counters land in one run log), runs ``tune.warmup`` for the
   configured sizes (every kernel library their levels launch is built
   and loaded before the first request), and only then starts accepting
   traffic.
2. ``submit()`` is non-blocking: it returns a Future or raises
   :class:`Rejected` immediately.
3. ``shutdown()`` stops admission (new submits -> Rejected), drains
   in-flight and queued work (unless ``drain=False``, which fails queued
   requests with Rejected("shutting_down")), joins the workers, then
   closes the run scope so ``run_end`` carries the final counters.

Durability (``ServeConfig.journal_dir``): a write-ahead request journal
(serve/journal.py) records every admit before the queue sees it and
every transition after.  ``start()`` then runs :meth:`Server.recover`
BEFORE accepting traffic: finished entries arm done-dedupe (duplicate
submissions answer instantly with the recorded response — exactly-once
from the client's view), incomplete entries re-enqueue in original admit
order on this server's device, and entries whose dispatch history
already exhausted ``crash_requeues`` are marked poisoned and shed forever
with ``Rejected("poison")``.  ``kill()`` is the non-graceful teardown
that models process death.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import ceilings as obs_ceilings
from image_analogies_tpu_torch.obs import ledger as obs_ledger
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.obs.slo import SloTracker
from image_analogies_tpu_torch.serve import batcher
from image_analogies_tpu_torch.serve import degrade as serve_degrade
from image_analogies_tpu_torch.serve import journal as serve_journal
from image_analogies_tpu_torch.serve.degrade import CostModel
from image_analogies_tpu_torch.serve.policy import TenantQuota
from image_analogies_tpu_torch.serve.queue import AdmissionQueue
from image_analogies_tpu_torch.serve.types import (
    Rejected,
    Request,
    Response,
    ServeConfig,
)
from image_analogies_tpu_torch.serve.worker import WorkerPool
from image_analogies_tpu_torch.tune import warmup as tune_warmup


def _scoped(fn):
    """Bracket a Server entry point in the server's obs scope, so a
    fleet worker's counters land in its own registry no matter which
    thread (router, HTTP handler, health loop) called in.  Transparent
    when ``obs_scope`` is None (standalone server)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with obs_metrics.scope_active(self.obs_scope):
            return fn(self, *args, **kwargs)
    return wrapper


class Server:
    def __init__(self, cfg: ServeConfig,
                 obs_scope: Optional[obs_metrics.ObsScope] = None):
        self.cfg = cfg
        # Fleet workers get their OWN observability scope (isolated
        # registry + flight recorder, writes chained to the fleet's run
        # scope); a standalone server leaves this None and the module
        # helpers resolve to the run scope exactly as before.  Every
        # entry point below brackets itself in scope_active(), which is
        # a transparent no-op for None.
        self.obs_scope = obs_scope
        self._queue = AdmissionQueue(
            cfg.queue_depth,
            deadline_ordering=cfg.deadline_ordering,
            age_bound_s=cfg.ordering_age_bound_s,
            qos=cfg.qos)
        # Per-tenant admission quota: None unless the QoS policy arms a
        # positive rate — the disabled path must stay byte-identical to
        # the pre-QoS server.  Cost shares feed back from the tenant
        # ledger, so a tenant burning an outsized share of dispatch time
        # sees its refill rate squeezed (see policy.TenantQuota).
        self._quota = (TenantQuota(cfg.qos,
                                   shares_fn=obs_ledger.tenants_doc)
                       if cfg.qos is not None and cfg.qos.quota_rps > 0
                       else None)
        # Seed the degrade cost EWMA: store (this device's persisted
        # rate) > packaged class table > optimistic default.
        rate, self.cost_prior_source = serve_degrade.load_prior(cfg.params)
        self.cost_model = CostModel(
            rate, seeded=self.cost_prior_source != "default")
        self.slo = SloTracker(cfg.slo_target,
                              fast_window_s=cfg.slo_fast_window_s,
                              slow_window_s=cfg.slo_slow_window_s)
        if obs_scope is not None:
            obs_scope.slo = self.slo
            if cfg.journal_dir:
                # black-box dumps land next to the worker's journal —
                # the one directory that survives this worker's death
                obs_scope.dump_dir = cfg.journal_dir
        # Write-ahead journal: None unless configured — the disabled
        # request path must never touch the journal module (zero-cost
        # contract, locked by tests).
        self._journal = (serve_journal.RequestJournal(
            cfg.journal_dir, fsync=cfg.journal_fsync)
            if cfg.journal_dir else None)
        # idem -> Future for requests reconstructed by recover(); lets an
        # embedder (or drill) wait for replayed work to finish.
        self.recovery: Dict[str, "Future[Response]"] = {}
        self.recovery_stats: Optional[Dict[str, int]] = None
        self._pool = WorkerPool(cfg, self._queue, self.cost_model,
                                slo=self.slo, journal=self._journal,
                                obs_scope=obs_scope)
        self._exit = contextlib.ExitStack()
        self._accepting = False
        self._started = False
        self._ledger_armed = False
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._t_start: Optional[float] = None
        self.warmup_report: list = []

    # -- lifecycle ---------------------------------------------------------

    @_scoped
    def start(self) -> "Server":
        if self._started:
            return self
        if self.cfg.params.backend == "cuda":
            # the device matcher on a card that is not there raises here,
            # before any traffic: the server never drops to the CPU
            from image_analogies_tpu_torch.models.analogy import \
                resolve_device

            resolve_device(self.cfg.params.device)
        self._started = True
        # One run scope for the server's lifetime; metrics forced on so
        # admission/latency counters exist even when params.metrics is
        # unset (log_path still controls whether records hit disk).
        scope_params = self.cfg.params.replace(metrics=True)
        self._exit.enter_context(obs_trace.run_scope(
            scope_params,
            manifest_extra={"serve": {
                "queue_depth": self.cfg.queue_depth,
                "batch_window_ms": self.cfg.batch_window_ms,
                "max_batch": self.cfg.max_batch,
                "workers": self.cfg.workers,
                "warmup_sizes": [list(s) for s in self.cfg.warmup_sizes],
                "journal": self.cfg.journal_dir,
                "deadline_ordering": self.cfg.deadline_ordering,
                "breaker_threshold": self.cfg.breaker_threshold,
                "cost_prior": self.cost_prior_source,
                "slo_target": self.cfg.slo_target,
                "ledger": self.cfg.ledger,
            }}))
        if self.cfg.ledger:
            # Tenant metering plane: arm (or join) the process ledger
            # for the server's lifetime.  arm() nests, so a fleet of
            # in-process workers shares one plane and the last shutdown
            # disarms it.
            obs_ledger.arm(capacity=self.cfg.ledger_capacity,
                           tenant_k=self.cfg.tenant_k)
            self._ledger_armed = True
        if self.obs_scope is None and self.cfg.journal_dir:
            # standalone journaled server: the run scope's flight
            # recorder dumps into this journal dir on a death path
            scope = obs_metrics.current_scope()
            if scope is not None and scope.dump_dir is None:
                scope.dump_dir = self.cfg.journal_dir
        obs_metrics.inc(f"serve.cost_prior.{self.cost_prior_source}")
        obs_metrics.set_gauge("serve.queue_depth", 0)
        if self.cfg.warmup_sizes:
            with obs_trace.span("serve_warmup",
                                sizes=len(self.cfg.warmup_sizes)):
                self.warmup_report = tune_warmup.warmup_buckets(
                    self.cfg.params, self.cfg.warmup_sizes)
        if self._journal is not None:
            # Replay BEFORE traffic: recovered work re-enqueues first,
            # and done-dedupe / poison state is armed before the first
            # duplicate submission can arrive.
            self._journal.open()
            self.recover()
        self._pool.start()
        self._t_start = time.monotonic()
        self._accepting = True
        return self

    @_scoped
    def shutdown(self, drain: bool = True) -> None:
        if not self._started:
            return
        self._accepting = False
        if not drain:
            for req in self._queue.drain_rejected():
                req.future.set_exception(Rejected("shutting_down"))
        self._queue.close()
        self._pool.join(self.cfg.drain_timeout_s)
        if self.cfg.cost_persist:
            try:
                serve_degrade.persist_rate(self.cost_model, self.cfg.params)
            except Exception:  # pragma: no cover - persistence best-effort
                pass
        if self._journal is not None:
            self._journal.close()
        self._disarm_ledger()
        self._started = False
        self._exit.close()

    def _disarm_ledger(self) -> None:
        if self._ledger_armed:
            self._ledger_armed = False
            obs_ledger.disarm()

    @_scoped
    def kill(self) -> None:
        """Non-graceful teardown — the drill-facing stand-in for process
        death.  Nothing is drained and no future is resolved: queued and
        in-flight clients are left hanging, exactly as a real death
        leaves them.  The write-ahead journal on disk is the only thing
        that survives; a new Server on the same ``journal_dir`` picks the
        work back up via :meth:`recover`."""
        if not self._started:
            return
        self._accepting = False
        self._queue.close()
        self._queue.drain_rejected()  # dropped unresolved, like a death
        self._pool.join(2.0)
        if self._journal is not None:
            self._journal.close()
        self._disarm_ledger()
        self._started = False
        self._exit.close()

    # -- recovery ----------------------------------------------------------

    @_scoped
    def recover(self) -> Dict[str, int]:
        """Replay the journal: arm done-dedupe and the poison set, then
        re-enqueue every incomplete entry in original admit order.
        Replayed requests carry no deadline (the original client's
        absolute deadline died with the old process; the recovered
        response is what a duplicate submission dedupes against) and
        continue their pre-restart dispatch history: an entry whose
        ``dispatched`` count already exceeds ``crash_requeues`` is marked
        poisoned and shed instead of being given another chance to crash
        the fleet."""
        assert self._journal is not None
        rep = self._journal.replay()
        stats = {"entries": len(rep.entries), "replayed": 0, "poisoned": 0,
                 "done": 0, "unrecoverable": 0,
                 "quarantined": rep.quarantined}
        restored = []
        for ent in rep.incomplete:
            if ent.dispatched > self.cfg.crash_requeues:
                obs_ledger.emit_decision("server", "poison",
                                         "replay_dispatch_exhausted",
                                         idem=ent.idem)
                self._journal.record_decision(
                    ent.idem, "server", "poison",
                    "replay_dispatch_exhausted",
                    dispatched=ent.dispatched)
                self._journal.record_poisoned(ent.idem)
                stats["poisoned"] += 1
                obs_trace.emit_record({"event": "serve_replay",
                                       "idem": ent.idem,
                                       "action": "poisoned",
                                       "dispatched": ent.dispatched})
                continue
            # the recovered request runs on THIS server's device
            payload = self._journal.load_payload(
                ent.idem, device=self.cfg.params.device)
            if payload is None:  # spill damaged: quarantined, not re-run
                obs_ledger.emit_decision("server", "reject",
                                         "payload_corrupt", idem=ent.idem)
                self._journal.record_rejected(ent.idem, "payload_corrupt")
                stats["unrecoverable"] += 1
                obs_trace.emit_record({"event": "serve_replay",
                                       "idem": ent.idem,
                                       "action": "unrecoverable"})
                continue
            a, ap, b, params = payload
            with self._id_lock:
                self._next_id += 1
                rid = self._next_id
            fut: "Future[Response]" = Future()
            req = Request(
                request_id=rid, a=a, ap=ap, b=b, params=params,
                key=batcher.batch_key(a, ap, b, params), future=fut,
                idem=ent.idem, replayed=True, requeues=ent.dispatched)
            restored.append(req)
            self.recovery[ent.idem] = fut
            stats["replayed"] += 1
            obs_ledger.emit_decision("server", "replay",
                                     "incomplete_after_restart",
                                     idem=ent.idem)
            self._journal.record_decision(ent.idem, "server", "replay",
                                          "incomplete_after_restart",
                                          dispatched=ent.dispatched)
            obs_metrics.inc("serve.journal.replayed")
            obs_trace.emit_record({"event": "serve_replay",
                                   "idem": ent.idem, "request": rid,
                                   "action": "requeued",
                                   "dispatched": ent.dispatched})
        stats["done"] = sum(1 for e in rep.entries.values()
                            if e.done is not None)
        self._queue.restore(restored)
        obs_trace.emit_record({"event": "serve_recovery", **stats})
        self.recovery_stats = stats
        return stats

    def wait_recovered(self, timeout: Optional[float] = None) -> Dict[str, str]:
        """Block until every journal-replayed request resolves; returns
        ``{idem: outcome}`` where outcome is the response status or the
        exception type name."""
        end = None if timeout is None else time.monotonic() + timeout
        out: Dict[str, str] = {}
        for idem, fut in self.recovery.items():
            left = None if end is None else max(0.0,
                                                end - time.monotonic())
            try:
                out[idem] = fut.result(left).status
            except Exception as exc:  # noqa: BLE001 - summarized
                out[idem] = type(exc).__name__
        return out

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- request path ------------------------------------------------------

    @_scoped
    def submit(self, a: np.ndarray, ap: np.ndarray, b: np.ndarray,
               params: Optional[AnalogyParams] = None,
               deadline_s: Optional[float] = None,
               wire_bytes: int = 0,
               priority: int = 2,
               idempotency_key: Optional[str] = None) -> "Future[Response]":
        """Enqueue one request; returns a Future resolving to a Response
        (or raising DeadlineExceeded / the dispatch error).  Raises
        :class:`Rejected` when the server is full or shutting down, when
        the dispatch breaker is open, or when the tenant's quota is
        spent.

        With the journal enabled, ``idempotency_key`` (or the derived
        content key) makes submission exactly-once across restarts: a
        key the journal already finished answers instantly with the
        recorded response, and a key marked poisoned sheds with
        ``Rejected("poison")`` before it can touch a worker — checked
        ahead of the breaker, so known-poison retries never trip it."""
        if not self._accepting:
            raise Rejected("shutting_down")
        p = params or self.cfg.params
        key = idem = None
        if self._journal is not None:
            if (idempotency_key is not None
                    and not serve_journal.valid_idem(idempotency_key)):
                # The key names files under the journal dir — anything
                # outside [A-Za-z0-9_-]{1,64} (path separators, dots)
                # is refused before it can touch a path or a journal
                # line.  HTTP pre-checks this and answers 400.
                obs_metrics.inc("serve.rejected")
                raise Rejected("bad_idempotency_key")
            key = batcher.batch_key(a, ap, b, p)
            idem = idempotency_key or serve_journal.idem_key(
                batcher.key_str(key), np.asarray(b))
            if self._journal.is_poisoned(idem):
                obs_metrics.inc("serve.rejected")
                obs_metrics.inc("serve.poisoned")
                obs_ledger.emit_decision("server", "shed", "poison",
                                         idem=idem)
                raise Rejected("poison")
            cached = self._journal.lookup_done(idem)
            if cached is not None:
                obs_metrics.inc("serve.journal.deduped")
                obs_trace.emit_record({"event": "serve_dedupe",
                                       "request": cached.request_id,
                                       "idem": idem})
                # The dedupe verdict is part of this key's causal chain
                # ("done, bit-exact dedupe on retry") — journal it so
                # `ia why` shows the retry was answered, not re-run.
                obs_ledger.emit_decision("server", "dedupe",
                                         "journal_done", idem=idem)
                self._journal.record_decision(idem, "server", "dedupe",
                                              "journal_done")
                fut: "Future[Response]" = Future()
                fut.set_result(cached)
                return fut
            rec = self.recovery.get(idem)
            if rec is not None and not rec.done():
                # Join-replay: this key is ALREADY being recomputed by
                # recover()'s replay — a duplicate submission (e.g. a
                # router re-forward after a cross-process handoff, where
                # no in-process future exists to re-chain) joins the
                # in-flight replayed request instead of re-admitting it,
                # keeping recovery exactly-once-compute across the
                # process boundary.
                obs_metrics.inc("serve.journal.join_replay")
                obs_trace.emit_record({"event": "serve_join_replay",
                                       "idem": idem})
                obs_ledger.emit_decision("server", "join_replay",
                                         "replay_in_flight", idem=idem)
                self._journal.record_decision(idem, "server",
                                              "join_replay",
                                              "replay_in_flight")
                joined: "Future[Response]" = Future()

                def _chain(f: "Future[Response]",
                           out: "Future[Response]" = joined) -> None:
                    if out.done():
                        return
                    exc = f.exception()
                    if exc is not None:
                        out.set_exception(exc)
                    else:
                        out.set_result(f.result())

                rec.add_done_callback(_chain)
                return joined
        if self._pool.breaker.admission_open():
            # Breaker-aware admission: the dispatch breaker is open, so
            # an accepted request would only sit in the queue to be
            # fast-failed at dispatch.  Shed one hop earlier instead —
            # queue_depth stays honest during brownouts.  admission_open
            # is non-claiming, so the half-open probe still flows.
            obs_metrics.inc("serve.rejected")
            obs_metrics.inc("serve.rejected.breaker_open")
            obs_ledger.emit_decision("server", "shed", "breaker_open",
                                     idem=idem)
            raise Rejected("breaker_open")
        if self._quota is not None:
            # Per-tenant admission quota (tenant = the batch key's
            # exemplar sha1): a tenant out of tokens is shed HERE, on
            # its own request, before it can hold a queue slot — the
            # viral style degrades itself, not the fleet.  "quota" is a
            # verdict about the request, so the router never spills it
            # to another worker (that would hand the throttled tenant
            # fleet-wide capacity).
            if key is None:
                key = batcher.batch_key(a, ap, b, p)
            tenant = str(key[-1])
            if not self._quota.try_admit(tenant):
                obs_metrics.inc("serve.rejected")
                obs_metrics.inc("serve.quota_throttled")
                obs_ledger.record_throttle(tenant)
                obs_ledger.emit_decision("server", "shed", "quota",
                                         idem=idem, tenant=tenant[:12])
                if self._journal is not None and idem is not None:
                    self._journal.record_decision(
                        idem, "server", "shed", "quota")
                raise Rejected("quota")
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        fut = Future()
        req = Request(
            request_id=rid,
            a=np.asarray(a), ap=np.asarray(ap), b=np.asarray(b),
            params=p,
            key=key if key is not None else batcher.batch_key(a, ap, b, p),
            future=fut,
            idem=idem,
            wire_bytes=wire_bytes,
            priority=priority,
            # Submit runs on the caller's thread; the worker thread that
            # dispatches is a different one — the trace context crosses
            # via the request itself.
            trace=obs_trace.capture_trace(),
        )
        if deadline_s is not None:
            req.deadline = req.t_submit + deadline_s
        if self._journal is not None:
            # WAL ordering: the admit record (payload spill + sealed
            # line) lands BEFORE the queue sees the request, so an
            # accepted request with no journal trace cannot exist.
            self._journal.record_admit(
                idem, rid, req.a, req.ap, req.b, p, deadline_s,
                batcher.key_str(req.key))
            try:
                self._queue.submit(req)
            except Rejected as exc:
                self._journal.record_rejected(idem, exc.reason)
                raise
        else:
            self._queue.submit(req)  # Rejected propagates to the caller
        # Admission instant: the first hop of the request's trace chain
        # (ia trace renders admit -> queue wait -> batch -> dispatch).
        obs_trace.emit_record({"event": "serve_admit",
                               "request": rid,
                               "key": batcher.key_str(req.key),
                               "deadline_s": deadline_s,
                               "queue_depth": len(self._queue)})
        return fut

    def request(self, a, ap, b, params=None, deadline_s=None,
                timeout: Optional[float] = None) -> Response:
        """Blocking convenience: submit + wait."""
        return self.submit(a, ap, b, params, deadline_s).result(timeout)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- live telemetry ------------------------------------------------------

    @_scoped
    def refresh_gauges(self) -> None:
        """Bring point-in-time gauges current before a /metrics scrape
        (event-driven gauges update themselves; these are sampled)."""
        if self._t_start is not None:
            obs_metrics.set_gauge("serve.uptime_s",
                                  round(time.monotonic() - self._t_start, 3))
        obs_metrics.set_gauge("serve.queue_depth", len(self._queue))
        self._pool.breaker.export_state()

    @_scoped
    def tenants_doc(self) -> Dict[str, Any]:
        """JSON-ready /tenants payload: the metering plane's per-tenant
        heavy-hitter document (obs/ledger.py).  ``armed: false`` with an
        empty list when the ledger is off."""
        return obs_ledger.tenants_doc()

    @_scoped
    def health(self) -> Dict[str, Any]:
        """JSON-ready health document: liveness + the state an operator
        needs to route around trouble."""
        live = self._pool.liveness()
        snap = obs_metrics.snapshot()
        gauges = snap.get("gauges", {})
        breaker = self._pool.breaker
        workers_ok = all(live.values()) if live else True
        # Liveness vs readiness split: a server still working through its
        # journal replay backlog is ALIVE (accepting, threads up) but not
        # READY.
        recovering = any(not f.done() for f in self.recovery.values())
        return {
            "ok": bool(self._started and self._accepting and workers_ok),
            "accepting": self._accepting,
            "ready": bool(self._accepting and not recovering),
            "recovering": recovering,
            "recovery": self.recovery_stats,
            "uptime_s": (round(time.monotonic() - self._t_start, 3)
                         if self._t_start is not None else 0.0),
            "queue_depth": len(self._queue),
            "inflight": self._pool.inflight,
            "breakers": {breaker.backend: breaker.state},
            "workers": {
                "total": len(live),
                "alive": sum(1 for ok in live.values() if ok),
                "threads": live,
            },
            "devcache_bytes": gauges.get("devcache.bytes", 0),
            # per-device hbm.peak_bytes.d<N> watermarks -> worst device
            "hbm_peak_bytes": max(
                (v for k, v in gauges.items()
                 if k.startswith("hbm.peak_bytes.")), default=0),
            "slo": self.slo.snapshot(),
            # process vitals from /proc (graceful off-Linux): the
            # ceilings watchdog and `ia top` read the same source.
            "vitals": obs_ceilings.read_proc_vitals(),
            # per-tenant admission quota state (None when QoS is off)
            "quota": (self._quota.snapshot()
                      if self._quota is not None else None),
            # durability plane: live serve.journal.* counter tallies plus
            # lock-holder pid / active segment index (None when the
            # journal is disabled)
            "journal": ({**self._journal.stats(), **self._journal.info()}
                        if self._journal is not None else None),
        }


class Client:
    """In-process client facade — the API tests (and embedders) use.
    Exists so call sites depend on the request surface, not on server
    lifecycle internals; a future remote client keeps this interface."""

    def __init__(self, server: Server):
        self._server = server

    def submit(self, a, ap, b, params=None, deadline_s=None,
               idempotency_key=None):
        return self._server.submit(a, ap, b, params, deadline_s,
                                   idempotency_key=idempotency_key)

    def request(self, a, ap, b, params=None, deadline_s=None, timeout=None):
        return self._server.request(a, ap, b, params, deadline_s, timeout)
