"""Worker pool: owns device dispatch for batches popped off the queue
(the port's copy of the JAX package's ``serve/worker.py``).

A compatible batch of >= 2 members on the device backend
(``backend="cuda"``) dispatches as ONE lane-engine call
(batch/engine.py, ``ServeConfig.batch_engine``): one level scan
synthesizes every member's B' lane, with per-member fault isolation and
bit-identical outputs.  Everything else — and every refused batch,
reason on ``batch.fallback_sequential.<reason>`` — runs the sequential
per-member loop: one matcher is constructed per batch and shared by
every member (the batch key guarantees identical params + exemplar
content, so the matcher's per-level caches amortize across the batch).
Degraded members run with their own substituted params and therefore
their own matcher; correctness first, sharing second.

Every engine call goes through ``utils.failure.run_with_retry`` so an
injected (or real) transient device failure retries inside the server
and the client never observes it.

Two containment layers sit around that:

- a shared :class:`serve.breaker.CircuitBreaker` — consecutive dispatch
  failures trip it and further requests fail fast with
  ``Rejected("circuit_open")`` instead of burning workers;
- crash containment in the worker loop — an escape below the
  per-request handler (a genuine worker crash) is caught, the batch's
  unresolved requests are requeued (bounded per request) or failed with
  ``Rejected("worker_crash")``, and the thread SURVIVES.  No request is
  ever lost to a crashed thread, and the pool never shrinks.  The flight
  ring is dumped (``obs/recorder.py dump_current``) where the scope has a
  dump directory.

Write-ahead journal (serve/journal.py, when the server has one): each
request's ``dispatched`` line lands before its engine call (on the lane
engine's path, every member's before the one call), its ``done`` line
(the response spilled) before its future resolves, and every terminal
refusal, poison verdict, control-plane decision and cost vector beside
them.

Chaos: the site ``serve.dispatch`` opens each batch run (a raising kind
there is a crash below the per-request handler, contained as one).  A
``chaos.ProcessDeath`` is NOT contained: the worker thread counts
``serve.process_deaths``, emits ``serve_process_death``, dumps the black
box last and exits, its futures unresolved, as a dead process leaves
them; the write-ahead journal's replay is the only recovery.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.obs import ledger as obs_ledger
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import recorder as obs_recorder
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.obs.slo import SloTracker
from image_analogies_tpu_torch.serve import batcher
from image_analogies_tpu_torch.serve import degrade as serve_degrade
from image_analogies_tpu_torch.serve.breaker import CircuitBreaker
from image_analogies_tpu_torch.serve.queue import AdmissionQueue
from image_analogies_tpu_torch.serve.types import (
    DeadlineExceeded,
    Rejected,
    Request,
    Response,
    ServeConfig,
)
from image_analogies_tpu_torch.utils import failure


def _claim(req: Request) -> bool:
    """Move the request's future to RUNNING; False when the client
    cancelled it while queued or it is already resolved.  A future that
    is already RUNNING (claimed by a lane-engine attempt that handed the
    batch back, or requeued by crash containment) is this worker's to
    finish.  (The JAX worker calls ``set_running_or_notify_cancel`` again
    there and catches the RuntimeError, which the futures module logs.)"""
    if req.future.running():
        return True
    try:
        return req.future.set_running_or_notify_cancel()
    except RuntimeError:  # resolved between the two reads
        return False


class WorkerPool:
    def __init__(self, cfg: ServeConfig, queue: AdmissionQueue,
                 cost_model: Optional[serve_degrade.CostModel] = None,
                 slo: Optional[SloTracker] = None, journal=None,
                 obs_scope=None):
        self._cfg = cfg
        self._queue = queue
        self._journal = journal  # write-ahead journal (None = disabled)
        self._obs_scope = obs_scope  # fleet worker's scope (None standalone)
        self._cost = cost_model or serve_degrade.CostModel()
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_cooldown_s,
                                      backend=cfg.params.backend)
        self.slo = slo
        self._threads: List[threading.Thread] = []
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def start(self) -> None:
        # Publish the breaker gauge inside the server's run scope (gauges
        # set before the scope opens are dropped with the old registry).
        self.breaker.export_state()
        for i in range(self._cfg.workers):
            t = threading.Thread(target=self._loop, name=f"ia-serve-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def liveness(self) -> dict:
        """Per-thread liveness for /healthz: ``{thread_name: is_alive}``."""
        return {t.name: t.is_alive() for t in self._threads}

    def join(self, timeout: Optional[float] = None) -> None:
        end = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            t.join(None if end is None else max(0.0, end - time.monotonic()))

    def _loop(self) -> None:
        # The whole loop runs under the pool's obs scope (no-op when
        # standalone): every dispatch counter, span, and record this
        # thread produces lands in the fleet worker's own registry and
        # flight-recorder ring, chained up to the run's registry.
        with obs_metrics.scope_active(self._obs_scope):
            self._loop_scoped()

    def _loop_scoped(self) -> None:
        while True:
            batch = self._queue.pop_batch(self._cfg.max_batch,
                                          self._cfg.batch_window_ms / 1e3)
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except chaos.ProcessDeath:
                # The chaos plane's process-death fault: deliberately NOT
                # contained — a dead process cannot requeue anything.
                # The thread exits, futures stay unresolved, and the only
                # recovery path is the write-ahead journal on restart
                # (the kill-restart drill's whole premise).
                obs_metrics.inc("serve.process_deaths")
                obs_trace.emit_record({"event": "serve_process_death",
                                       "batch_size": len(batch)})
                # Black box out the door LAST, so the ring contains the
                # death record itself; the per-request context already
                # unwound with the raise, so the dump's attribution comes
                # from the batch itself.
                obs_recorder.dump_current("process_death", extra={
                    "batch_size": len(batch),
                    "requests": [r.request_id for r in batch],
                    "key": batcher.key_str(batch[0].key),
                    "trace": (batch[0].trace or {}).get("trace")})
                return
            except BaseException as exc:  # noqa: BLE001 - crash containment
                self._contain_crash(batch, exc)

    def _contain_crash(self, batch: List[Request], exc: BaseException) -> None:
        """An escape below the per-request handler killed this batch run.
        Resolve every unresolved member — requeue (bounded) or fail — and
        keep the thread alive."""
        obs_metrics.inc("serve.worker_crashes")
        obs_trace.emit_record({"event": "serve_worker_crash",
                               "error": type(exc).__name__,
                               "detail": str(exc)[:200],
                               "batch_size": len(batch)})
        # the black box out the door after the crash record, so the ring
        # holds it (no-op without a dump directory; never raises)
        obs_recorder.dump_current("worker_crash", extra={
            "batch_size": len(batch),
            "requests": [r.request_id for r in batch],
            "key": batcher.key_str(batch[0].key),
            "trace": (batch[0].trace or {}).get("trace")})
        for req in batch:
            if req.future.done():
                continue
            if req.requeues < self._cfg.crash_requeues:
                req.requeues += 1
                self._decide(req, "requeue", "worker_crash",
                             requeues=req.requeues)
                self._queue.requeue(req)
            else:
                # Requeue budget exhausted: this request takes workers
                # down every time it runs.  Persist the poison verdict so
                # any RESUBMISSION of the same idempotency key sheds at
                # admission with Rejected("poison") instead of crashing
                # the server again.
                self._decide(req, "poison", "crash_requeues_exhausted")
                if self._journal is not None and req.idem:
                    self._journal.record_poisoned(req.idem)
                obs_metrics.inc("serve.rejected")
                req.future.set_exception(Rejected("worker_crash"))

    def _track_inflight(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight += delta
            obs_metrics.set_gauge("serve.inflight", self._inflight)

    def _run_batch(self, batch: List[Request]) -> None:
        # batch-level fault injection (drills): raising kinds here model a
        # worker dying below the per-request handler — they escape into
        # _loop's crash containment, which must resolve every member.
        chaos.site("serve.dispatch", batch=len(batch))
        self._track_inflight(len(batch))
        obs_metrics.observe("serve.batch_size", len(batch))
        try:
            with obs_trace.span("serve_batch", size=len(batch),
                                key=batcher.key_str(batch[0].key)):
                if (self._cfg.batch_engine and len(batch) >= 2
                        and batch[0].params.backend == "cuda"
                        and self._dispatch_batch(batch)):
                    return
                backend = None
                for req in batch:
                    backend = self._run_one(req, backend, len(batch))
        finally:
            self._track_inflight(-len(batch))

    def _dispatch_batch(self, batch: List[Request]) -> bool:
        """Dispatch a compatible batch as ONE lane-engine call
        (batch/engine.py): one level scan synthesizes every member's B'
        lane.  Returns True when every member was resolved
        here; False means "not handled" — the caller runs the
        sequential per-member loop, whose ``set_running`` tolerance
        covers members this path already claimed."""
        from image_analogies_tpu_torch.batch import engine as batch_engine

        # Serve-side preflight the engine can't see: the batch key
        # guarantees identical request params, but degrade plans depend
        # on per-request deadlines and may diverge — a shared launch
        # cannot run members at different fidelity.
        plans = [serve_degrade.plan(req, self._cost,
                                    allow_degrade=self._cfg.degrade)
                 for req in batch]
        if any(action != "run" or degraded is not None
               for action, _, degraded in plans):
            obs_metrics.inc("batch.fallback_sequential.degrade_divergence")
            return False
        if not self.breaker.allow():
            return False  # sequential path fails each member fast
        params = plans[0][1]

        # claim every member; a cancelled member would break lane
        # alignment, so hand the whole batch back to the sequential loop
        for req in batch:
            if not _claim(req):
                return False

        # WAL transition for every member BEFORE the engine call (same
        # contract as the one-by-one path; replay treats a repeated
        # `dispatched` append from a later fallback as the same state)
        if self._journal is not None:
            for req in batch:
                if req.idem:
                    self._journal.record_dispatched(req.idem)

        t0 = time.monotonic()
        try:
            results = batch_engine.create_image_analogy_batch(
                batch[0].a, batch[0].ap, [req.b for req in batch], params)
        except batch_engine.BatchIncompatible:
            # reason already counted by the engine's refusal path
            return False
        except Exception:  # noqa: BLE001 - whole-launch failure
            # below per-lane isolation: the sequential path gives each
            # member its own retry envelope and breaker accounting
            obs_metrics.inc("batch.fallback_sequential.launch_error")
            return False
        dispatch_s = time.monotonic() - t0

        # ONE cost observation per launch with the SUMMED work units:
        # the EWMA rate is seconds per unit, so this attributes the
        # marginal per-member cost at dispatch_s / k automatically.
        # Observing the full launch wall-clock once per member would
        # inflate the learned rate k-fold and over-fire the degrade
        # ladder on every deadlined request that follows.
        units = 0.0
        ok_lanes = 0
        for req, res in zip(batch, results):
            if isinstance(res, Exception):
                continue
            units += serve_degrade.work_units(
                int(req.b.shape[0]) * int(req.b.shape[1]),
                params.levels, params.patch_size)
            ok_lanes += 1
        if ok_lanes:
            self._cost.observe(units, dispatch_s)
            self.breaker.record_success()

        for lane, (req, res) in enumerate(zip(batch, results)):
            with obs_trace.request_context(request=req.request_id,
                                           key=batcher.key_str(req.key),
                                           **(req.trace or {})):
                if isinstance(res, Exception):
                    # per-lane fault isolation: only this member
                    # re-runs, sequentially, with its own retry budget
                    obs_trace.emit_record({"event": "serve_batch_lane",
                                           "lane": lane,
                                           "request": req.request_id,
                                           "status": "fault",
                                           "error": type(res).__name__})
                    self._dispatch_one(req, None, len(batch))
                    continue
                now = time.monotonic()
                resp = Response(
                    request_id=req.request_id,
                    bp=res.bp,
                    bp_y=res.bp_y,
                    stats=res.stats,
                    batch_size=len(batch),
                    queue_ms=((req.t_dequeue or t0) - req.t_submit) * 1e3,
                    dispatch_ms=dispatch_s * 1e3,
                    total_ms=(now - req.t_submit) * 1e3,
                    degraded=None,
                )
                obs_metrics.inc("serve.completed")
                self._record_slo(req,
                                 req.deadline is None or now <= req.deadline)
                obs_metrics.observe("serve.latency_ms", resp.total_ms)
                obs_metrics.observe("serve.queue_ms", resp.queue_ms)
                obs_trace.emit_record({"event": "serve_batch_lane",
                                       "lane": lane,
                                       "request": req.request_id,
                                       "status": "ok"})
                self._emit_request_record(req, resp.status,
                                          batch_size=len(batch),
                                          dispatch_ms=resp.dispatch_ms)
                self._emit_cost(req, resp, params)
                if self._journal is not None and req.idem:
                    self._journal.record_done(req.idem, resp)
                req.future.set_result(resp)
        return True

    def _decide(self, req: Request, verdict: str, cause: str,
                **extra) -> None:
        """One control-plane verdict on this request's fate: counter +
        trace record (the obs/ledger funnel) and, when journaled, a sealed
        ``decision`` line `ia why` replays."""
        obs_ledger.emit_decision("worker", verdict, cause,
                                 idem=req.idem, request=req.request_id,
                                 **extra)
        if self._journal is not None and req.idem:
            self._journal.record_decision(req.idem, "worker", verdict,
                                          cause, **extra)

    def _emit_cost(self, req: Request, resp: Response, params, *,
                   retries: int = 0) -> None:
        """Assemble this request's cost vector at dispatch completion.
        Fast-exits before building anything when both sinks (ledger
        plane, journal) are off — the disarmed path allocates nothing."""
        if not obs_ledger.armed() and self._journal is None:
            return
        degraded = resp.degraded or {}
        vec = {
            "tenant": str(req.key[-1]) if req.key else None,
            "trace": (req.trace or {}).get("trace"),
            "rid": resp.request_id,
            "status": resp.status,
            "queue_ms": round(resp.queue_ms, 3),
            "dispatch_ms": round(resp.dispatch_ms, 3),
            "total_ms": round(resp.total_ms, 3),
            "lanes": resp.batch_size,
            "degrade_levels": degraded.get("levels"),
            "retries": retries,
            "requeues": req.requeues,
            "priority": req.priority,
            "ann": bool(getattr(params, "ann_prefilter", False)),
            "catalog": bool(getattr(params, "catalog_dir", None)),
            "wire_bytes": req.wire_bytes,
        }
        obs_ledger.record(vec)
        obs_trace.emit_record({"event": "serve_cost", **vec})
        if self._journal is not None and req.idem:
            self._journal.record_cost(req.idem, vec)

    def _emit_request_record(self, req: Request, status: str, *,
                             batch_size: int, dispatch_ms: float = 0.0,
                             degraded=None) -> None:
        now = time.monotonic()
        queue_ms = ((req.t_dequeue or now) - req.t_submit) * 1e3
        obs_trace.emit_record({
            "event": "serve_request",
            "request": req.request_id,
            "status": status,
            "batch_size": batch_size,
            "queue_ms": round(queue_ms, 3),
            "dispatch_ms": round(dispatch_ms, 3),
            "total_ms": round((now - req.t_submit) * 1e3, 3),
            "degraded": degraded,
        })

    def _record_slo(self, req: Request, met: bool) -> None:
        """Feed the SLO tracker: only *deadlined* requests count toward
        the deadline-attainment SLO (undeadlined traffic has no promise
        to break)."""
        if self.slo is not None and req.deadline is not None:
            self.slo.record(met)

    def _run_one(self, req: Request, backend, batch_size: int):
        # Ambient request id + inbound trace context for the whole
        # per-request path: every span and record below — including the
        # engine's own level/fetch spans inside create_image_analogy —
        # inherits them, so `ia trace` renders one connected request-id
        # chain from admit to dispatch, stitched to the submitting hop's
        # trace even though this thread is not the submit thread.
        with obs_trace.request_context(request=req.request_id,
                                       key=batcher.key_str(req.key),
                                       **(req.trace or {})):
            return self._dispatch_one(req, backend, batch_size)

    def _dispatch_one(self, req: Request, backend, batch_size: int):
        """Dispatch one request; returns the (possibly newly built) shared
        backend for subsequent same-batch members."""
        # lazy import: the engine loads on the first dispatch
        from image_analogies_tpu_torch.backends import get_backend
        from image_analogies_tpu_torch.models.analogy import create_image_analogy

        if not _claim(req):
            return backend  # cancelled while queued, or already resolved

        action, params, degraded = serve_degrade.plan(
            req, self._cost, allow_degrade=self._cfg.degrade)
        if action == "timeout":
            obs_metrics.inc("serve.timeouts")
            self._record_slo(req, False)
            self._emit_request_record(req, "timeout", batch_size=batch_size)
            self._decide(req, "timeout", "deadline_expired")
            self._journal_rejected(req, "deadline")
            req.future.set_exception(
                DeadlineExceeded(req.request_id, -(req.remaining() or 0.0)))
            return backend

        if degraded is not None:
            # Instant on the serve track: the degrade ladder substituted
            # params for this request — part of its critical path.
            obs_trace.emit_record({"event": "serve_degrade_decision",
                                   "request": req.request_id,
                                   "degraded": degraded})
            self._decide(req, "degrade",
                         "best_effort" if degraded.get("best_effort")
                         else "ewma_over_budget",
                         levels=degraded.get("levels"))

        if not self.breaker.allow():
            # circuit open: fail fast, no dispatch, no retry burn
            obs_metrics.inc("serve.rejected")
            self._record_slo(req, False)
            self._emit_request_record(req, "rejected", batch_size=batch_size)
            self._decide(req, "shed", "breaker_open")
            self._journal_rejected(req, "circuit_open")
            req.future.set_exception(Rejected("circuit_open"))
            return backend

        if degraded is not None:
            # substituted params -> different level shapes and plans; do
            # not share the batch's matcher
            dispatch_backend = get_backend(params)
        else:
            backend = backend or get_backend(params)
            dispatch_backend = backend

        # WAL transition: dispatched BEFORE the engine call.  If the
        # process dies anywhere past this line without a done append,
        # replay sees `dispatched` and re-enqueues (counting the attempt
        # against the cross-restart poison budget).
        if self._journal is not None and req.idem:
            self._journal.record_dispatched(req.idem)

        t0 = time.monotonic()
        # Per-request attempt count for the cost vector: run_with_retry
        # absorbs transient faults invisibly, so the closure is the only
        # honest witness of how many engine calls this request burned.
        attempts = {"n": 0}

        def _invoke():
            attempts["n"] += 1
            return create_image_analogy(req.a, req.ap, req.b, params,
                                        backend=dispatch_backend)

        try:
            with obs_trace.span("serve_dispatch", request=req.request_id,
                                batch_size=batch_size,
                                degraded=bool(degraded)):
                result = failure.run_with_retry(
                    _invoke,
                    retries=self._cfg.request_retries,
                    context={"scope": "serve", "request": req.request_id},
                    log_path=self._cfg.params.log_path,
                    backoff_s=0.0,
                )
        except Exception as exc:  # noqa: BLE001 - forwarded to the client
            self.breaker.record_failure()
            obs_metrics.inc("serve.errors")
            self._record_slo(req, False)
            self._emit_request_record(req, "error", batch_size=batch_size,
                                      dispatch_ms=(time.monotonic() - t0) * 1e3)
            self._journal_rejected(req, "error")
            req.future.set_exception(exc)
            return backend

        self.breaker.record_success()
        dispatch_s = time.monotonic() - t0
        pixels = int(req.b.shape[0]) * int(req.b.shape[1])
        self._cost.observe(
            serve_degrade.work_units(pixels, params.levels, params.patch_size),
            dispatch_s)

        now = time.monotonic()
        resp = Response(
            request_id=req.request_id,
            bp=result.bp,
            bp_y=result.bp_y,
            stats=result.stats,
            batch_size=batch_size,
            queue_ms=((req.t_dequeue or t0) - req.t_submit) * 1e3,
            dispatch_ms=dispatch_s * 1e3,
            total_ms=(now - req.t_submit) * 1e3,
            degraded=degraded,
        )
        obs_metrics.inc("serve.completed")
        self._record_slo(req, req.deadline is None or now <= req.deadline)
        if degraded is not None:
            obs_metrics.inc("serve.degraded")
        obs_metrics.observe("serve.latency_ms", resp.total_ms)
        obs_metrics.observe("serve.queue_ms", resp.queue_ms)
        self._emit_request_record(req, resp.status, batch_size=batch_size,
                                  dispatch_ms=resp.dispatch_ms,
                                  degraded=degraded)
        self._emit_cost(req, resp, params,
                        retries=max(attempts["n"] - 1, 0))
        # WAL transition: done is appended (response spilled + digest
        # sealed) BEFORE the future resolves.  If the process dies between
        # the two, the client never saw the answer and replay serves the
        # recorded one — the exactly-once edge, not a duplicate.
        if self._journal is not None and req.idem:
            self._journal.record_done(req.idem, resp)
        req.future.set_result(resp)
        return backend

    def _journal_rejected(self, req: Request, reason: str) -> None:
        """Terminal non-success transition: replay must not re-enqueue a
        request whose client already saw a definitive refusal."""
        if self._journal is not None and req.idem:
            self._journal.record_rejected(req.idem, reason)
