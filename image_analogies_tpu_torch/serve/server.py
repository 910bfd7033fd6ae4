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

The write-ahead journal of the JAX server (``journal_dir``,
``Server.kill`` / ``recover``) waits for the port's journal (ROADMAP
Queue 1 item 10b); ``ServeConfig`` refuses a ``journal_dir`` until then.
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
        self._pool = WorkerPool(cfg, self._queue, self.cost_model,
                                slo=self.slo, obs_scope=obs_scope)
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
        obs_metrics.inc(f"serve.cost_prior.{self.cost_prior_source}")
        obs_metrics.set_gauge("serve.queue_depth", 0)
        if self.cfg.warmup_sizes:
            with obs_trace.span("serve_warmup",
                                sizes=len(self.cfg.warmup_sizes)):
                self.warmup_report = tune_warmup.warmup_buckets(
                    self.cfg.params, self.cfg.warmup_sizes)
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
        self._disarm_ledger()
        self._started = False
        self._exit.close()

    def _disarm_ledger(self) -> None:
        if self._ledger_armed:
            self._ledger_armed = False
            obs_ledger.disarm()

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
               priority: int = 2) -> "Future[Response]":
        """Enqueue one request; returns a Future resolving to a Response
        (or raising DeadlineExceeded / the dispatch error).  Raises
        :class:`Rejected` when the server is full or shutting down, when
        the dispatch breaker is open, or when the tenant's quota is
        spent."""
        if not self._accepting:
            raise Rejected("shutting_down")
        p = params or self.cfg.params
        key = None
        if self._pool.breaker.admission_open():
            # Breaker-aware admission: the dispatch breaker is open, so
            # an accepted request would only sit in the queue to be
            # fast-failed at dispatch.  Shed one hop earlier instead —
            # queue_depth stays honest during brownouts.  admission_open
            # is non-claiming, so the half-open probe still flows.
            obs_metrics.inc("serve.rejected")
            obs_metrics.inc("serve.rejected.breaker_open")
            obs_ledger.emit_decision("server", "shed", "breaker_open")
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
                                         tenant=tenant[:12])
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
            wire_bytes=wire_bytes,
            priority=priority,
            # Submit runs on the caller's thread; the worker thread that
            # dispatches is a different one — the trace context crosses
            # via the request itself.
            trace=obs_trace.capture_trace(),
        )
        if deadline_s is not None:
            req.deadline = req.t_submit + deadline_s
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
        return {
            "ok": bool(self._started and self._accepting and workers_ok),
            "accepting": self._accepting,
            "ready": bool(self._accepting),
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
        }


class Client:
    """In-process client facade — the API tests (and embedders) use.
    Exists so call sites depend on the request surface, not on server
    lifecycle internals; a future remote client keeps this interface."""

    def __init__(self, server: Server):
        self._server = server

    def submit(self, a, ap, b, params=None, deadline_s=None):
        return self._server.submit(a, ap, b, params, deadline_s)

    def request(self, a, ap, b, params=None, deadline_s=None, timeout=None):
        return self._server.request(a, ap, b, params, deadline_s, timeout)
