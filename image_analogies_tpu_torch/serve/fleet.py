"""Worker fleet: N workers behind one consistent-hash Router (the port's
copy of the JAX package's ``serve/fleet.py``).

Each worker is a full
:class:`serve.server.Server` (own queue, batcher, breaker, journal
directory) reached through a :class:`serve.transport.Transport` — in
the same process by default, or as a real child process
(``transport="subprocess"``) on its own loopback HTTP port.  Either
way the worker has a STABLE identity ``w0..w{size-1}``: the wid owns
the ring slot and the journal directory, so a replacement worker
inherits both — affinity for untouched keys is preserved trivially and
the dead worker's write-ahead journal is recovered by whoever takes
the wid next.

Health gate loop (daemon thread, ``health_interval_s`` cadence):

- ``handle.health()`` raising, or reporting not-accepting / zero alive
  worker threads, counts a MISS; ``death_checks`` consecutive misses
  declare the worker dead and trigger :meth:`_replace` — kill the old
  incarnation (SIGKILL for a subprocess: the journal lock is left on
  disk holding a real foreign pid, swept by the replacement's open()),
  start a replacement on the SAME journal dir (``Server.start`` runs
  ``recover()`` before traffic: done-dedupe, admit-order replay,
  poison preserved), then hand the router every stranded in-flight
  future to re-answer by idempotency key.
- A worker that is ALIVE but replaying its journal reports
  ``recovering: true`` — liveness without readiness.  The death
  verdict is gated on liveness only: a long recovery must not look
  like a corpse and trigger a spurious second handoff.
- An open breaker or a queue at ``spill_queue_frac`` of depth GATES the
  worker: the router spills its keys to the next ring successor until
  the gate clears.  Gating is advisory and reversible; death is not.
- Every death consults the :class:`transport.CrashLoopSupervisor`:
  rapid deaths (within ``crash_loop_window_s`` of their own spawn)
  back off before respawn, and ``crash_loop_threshold`` consecutive
  rapid deaths park the slot (gate ``"crash_loop"``,
  ``router.crash_loops``) instead of burning spawns forever — an
  operator ``ungate_worker`` re-arms it.

Wire negotiation (satellite of the IAF2 work in serve/wire.py): every
router->worker hop round-trips the three request planes (and the
response planes) through the negotiated codec — IAF2 binary frames by
default, JSON lists on fallback.  In-process that rehearses the exact
encode/decode path; over the subprocess transport the same frames
actually cross the process boundary as HTTP bodies.

On the card: in-process workers share this process's card and stream
(their kernels interleave in its order); a subprocess worker is a CUDA
context of its own, and its SIGKILL is reaped (``SubprocessHandle.kill``
waits for the corpse) before the replacement spawns, so the card's
memory comes back first.  The parent's launch counts see no child's
launches: a subprocess fleet's come from the children's ``launch.*``
counters through the federated snapshot (:meth:`metrics_snapshots`).

Host-side only: nothing here launches a kernel (the serve lock test
scans this file).  Device work happens inside each worker's engine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

from image_analogies_tpu_torch.obs import fleet as obs_fleet
from image_analogies_tpu_torch.obs import archive as obs_archive
from image_analogies_tpu_torch.obs import ceilings as obs_ceilings
from image_analogies_tpu_torch.obs import ledger as obs_ledger
from image_analogies_tpu_torch.obs import live as obs_live
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import tenants as obs_tenants
from image_analogies_tpu_torch.obs import timeline as obs_timeline
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import journal as serve_journal
from image_analogies_tpu_torch.serve import transport as serve_transport
from image_analogies_tpu_torch.serve.control import ControlPlane
from image_analogies_tpu_torch.serve.router import Router
from image_analogies_tpu_torch.serve.types import (FleetConfig, Rejected,
                                                   Response)


class Fleet:
    """Owns the workers, the health-gate loop, and the Router."""

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.workers: Dict[str, Any] = {}
        self.transport = serve_transport.make_transport(cfg.transport)
        self.supervisor = serve_transport.CrashLoopSupervisor(
            cfg.crash_loop_window_s, cfg.crash_loop_threshold,
            cfg.backoff_s, cfg.backoff_cap_s)
        # Router/fleet verdicts persist in a sealed DecisionLog at the
        # fleet journal root (they can't land in any worker journal —
        # single-writer, often another process); `ia why` merges it
        # with the per-worker journals into one causal chain.
        self.decisions = (serve_journal.DecisionLog(
            os.path.join(cfg.journal_root, serve_journal.DecisionLog.NAME))
            if cfg.journal_root else None)
        self.router = Router(self, vnodes=cfg.vnodes,
                             spill_retries=cfg.spill_retries,
                             backoff_s=cfg.backoff_s,
                             backoff_cap_s=cfg.backoff_cap_s,
                             decision_log=self.decisions)
        # Control plane (serve/control.py): owns the per-worker gate
        # verdict always, and the autoscaling reconcile pass when a
        # declarative policy is attached.
        self.control = ControlPlane(self, cfg.policy)
        self.handoffs: List[Dict[str, Any]] = []
        self._gates: Dict[str, str] = {}   # wid -> reason
        self._misses: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._started = False
        # Fleet-level obs scope (parent of every in-process worker
        # scope) + the health loop's scrape cache:
        # wid -> {scope, t, snapshot}.
        self._scope: Optional[obs_metrics.ObsScope] = None
        self._scope_exit = contextlib.ExitStack()
        self._scrapes: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    # lifecycle

    def _worker_cfg(self, wid: str):
        if self.cfg.journal_root:
            return dataclasses.replace(
                self.cfg.serve,
                journal_dir=os.path.join(self.cfg.journal_root, wid))
        return self.cfg.serve

    def _negotiate(self, advertised) -> str:
        if self.cfg.wire in ("auto", "binary") and "iaf2" in advertised:
            return "iaf2"
        return "json"

    def _spawn(self, wid: str, generation: int):
        codec = self._negotiate(self.transport.handle_cls.wire_formats)
        handle = self.transport.spawn(
            wid, generation, self._worker_cfg(wid), codec,
            scope_parent=self._scope,
            spawn_timeout_s=self.cfg.spawn_timeout_s)
        with self._lock:
            self.workers[wid] = handle
            self._misses[wid] = 0
            self._scrape_locked(wid, handle)
        obs_metrics.inc("router.wire.{}".format(codec), 0)
        return handle

    def start(self) -> "Fleet":
        if self._started:
            return self
        self._started = True
        # The fleet's own run scope (joins an ambient drill/test run
        # reentrantly): router counters written from caller threads
        # resolve here, and every worker scope chains into it.
        # With an autoscaling policy the fleet breathes: start at the
        # policy floor and let the control plane grow it under load.
        initial = (self.cfg.policy.min_workers if self.cfg.policy
                   else self.cfg.size)
        self._scope_exit.enter_context(obs_trace.run_scope(
            self.cfg.serve.params.replace(metrics=True),
            manifest_extra={"fleet": {"size": initial,
                                      "wire": self.cfg.wire,
                                      "vnodes": self.cfg.vnodes,
                                      "transport": self.cfg.transport,
                                      "autoscale": bool(self.cfg.policy)}}))
        self._scope = obs_metrics.current_scope()
        # Temporal plane: the health loop below is the fleet's sampling
        # cadence — arm the process timeline for the fleet's lifetime so
        # each poll lands worker-labeled windowed series in it.
        obs_timeline.arm()
        # Witness plane: with an archive root configured (env
        # IA_ARCHIVE_DIR — the fleet-operator path, like the catalog's
        # IA_CATALOG_DIR), the health loop also persists closed
        # timeline/tenants documents to sealed disk segments, and the
        # ceilings watchdog trends RSS / journal / archive growth.
        archive_root = os.environ.get("IA_ARCHIVE_DIR")
        self._archive_armed = bool(archive_root)
        if archive_root:
            obs_archive.arm(root=archive_root)
        obs_ceilings.arm(decision_log=self.decisions)
        for i in range(initial):
            wid = "w{}".format(i)
            self._spawn(wid, generation=0)
            self.router.ring.add(wid)
        # Catalog prefetch (ROADMAP item 4): with a catalog root
        # configured (env IA_CATALOG_DIR — the fleet-operator path),
        # pre-stage each style's sealed entries into host RAM now that
        # the ring knows every style's home worker, so the first request
        # for a cataloged style finds warm tiers instead of paying the
        # disk load (or the full build) inside the request path.
        from image_analogies_tpu_torch.catalog import tiers as catalog_tiers

        if catalog_tiers.active():
            catalog_tiers.warm_for_fleet(self.router)
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fleet-health", daemon=True)
        self._health_thread.start()
        return self

    def shutdown(self) -> None:
        if not self._started:
            return
        # Stop the health loop FIRST so a draining worker is not
        # mistaken for a dead one and "replaced" mid-shutdown.
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(5.0)
        for handle in list(self.workers.values()):
            handle.shutdown()
        if self.decisions is not None:
            self.decisions.close()
        obs_ceilings.disarm()
        if getattr(self, "_archive_armed", False):
            obs_archive.disarm()
            self._archive_armed = False
        obs_timeline.disarm()
        self._scope_exit.close()
        self._started = False

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # router-facing surface

    def default_params(self):
        return self.cfg.serve.params

    def gated(self, wid: str) -> bool:
        with self._lock:
            return wid in self._gates

    def gate_worker(self, wid: str, reason: str) -> None:
        """Ops/test hook: force-gate a worker (router spills its keys)."""
        with self._lock:
            self._gates[wid] = reason

    def ungate_worker(self, wid: str) -> None:
        with self._lock:
            self._gates.pop(wid, None)
        self.supervisor.reset(wid)

    def forward(self, wid: str, a, ap, b, params,
                deadline_s: Optional[float], idem: Optional[str],
                priority: int = 2) -> "Future[Response]":
        """One router->worker hop through the transport handle: request
        planes AND the trace context through the negotiated codec,
        submit, response planes back through the codec."""
        return self.workers[wid].forward(a, ap, b, params, deadline_s,
                                         idem, priority=priority)

    def submit(self, a, ap, b, params=None, deadline_s=None,
               idempotency_key=None,
               wire_bytes: int = 0, priority: int = 2
               ) -> "Future[Response]":
        """Client entry point — delegates to the router.  ``wire_bytes``
        (the fleet HTTP front end's body size) is accepted for submit_fn
        signature parity; the router->worker hop measures its own frame
        and that is what the worker-side cost vector records."""
        del wire_bytes
        return self.router.submit(a, ap, b, params=params,
                                  deadline_s=deadline_s,
                                  idempotency_key=idempotency_key,
                                  priority=priority)

    # ------------------------------------------------------------------
    # health gate loop

    def _judge(self, handle) -> Optional[str]:
        """None = healthy; "dead" = missed; else a gate reason.  The
        judgement itself moved to the control plane
        (ControlPlane.gate_verdict); this shim fetches the health doc
        and keeps the historical handle-facing surface."""
        try:
            h = handle.health()
        except Exception:  # noqa: BLE001 - unresponsive counts as dead
            h = None
        control = getattr(self, "control", None) or ControlPlane(self)
        return control.gate_verdict(h)

    def _scrape_locked(self, wid: str, handle) -> None:
        """Cache a metrics snapshot of the worker's registry (lock held).

        The health loop is the fleet's scrape cadence: each pass stores
        the worker's isolated registry snapshot plus when it was taken,
        so /healthz can report scrape freshness per worker and a merged
        view is available even for a worker that dies mid-interval.
        In-process that reads the chained scope registry; over the
        subprocess transport it is a /metrics.json fetch (None while
        the child is unreachable — keep the last good scrape).
        """
        snap = handle.snapshot()
        if snap is None:
            return
        self._scrapes[wid] = {
            "scope": handle.scope_id,
            "t": time.monotonic(),
            "snapshot": snap,
        }
        # Feed the temporal plane: the worker's isolated registry
        # becomes worker-labeled windowed series (counter deltas /
        # gauge last-values / windowed histograms) in the timeline —
        # delta logic there treats a replacement's reset counters as a
        # fresh generation, so wN keeps one continuous series across
        # incarnations.
        obs_timeline.sample_snapshot(snap, worker=wid)

    def _journal_bytes(self) -> Optional[float]:
        """Total on-disk bytes under the fleet journal root (segments,
        decision log, worker subdirs) — the ceilings watchdog's
        journal-growth series.  None (series skipped) without a root."""
        root = self.cfg.journal_root
        if not root:
            return None
        total = 0
        try:
            for dirpath, _dirs, files in os.walk(root):
                for name in files:
                    try:
                        total += os.path.getsize(
                            os.path.join(dirpath, name))
                    except OSError:
                        pass
        except OSError:
            return None
        return float(total)

    @staticmethod
    def _poll_phase(wid: str) -> float:
        """Deterministic per-worker fraction of the poll interval.

        N workers polled back-to-back at a fixed cadence scrape (and,
        over the subprocess transport, hit /healthz) in lockstep — a
        thundering herd that grows with the fleet.  Hashing the wid
        spreads the polls across the interval, stably per worker, with
        no shared state and no RNG."""
        digest = hashlib.sha256(wid.encode()).digest()
        return int.from_bytes(digest[:4], "big") / 2.0 ** 32

    def _health_loop(self) -> None:
        interval = self.cfg.health_interval_s
        if self._stop.wait(interval):
            return
        while True:
            if self._scope is not None:
                # Fleet-level series (router.* live only here) sampled
                # unlabeled, alongside the worker-labeled ones below.
                obs_timeline.sample_snapshot(self._scope.registry.snapshot())
            # Tenant metering plane: mirror the local ledger's tracked
            # tenants into tenant:<sha1[:8]>-labeled timeline series at
            # the same cadence (no-op when the plane is disarmed — e.g.
            # subprocess transport, where children sample their own).
            obs_ledger.sample_timeline()
            # Witness + watchdog planes (both no-ops when disarmed):
            # persist the current timeline/tenants documents to the
            # archive, and trend the resource-ceiling series.
            obs_archive.sample()
            obs_ceilings.sample(extra={
                "journal.bytes": self._journal_bytes()})
            # Jittered per-worker polls: visit workers in phase order,
            # sleeping the phase gap between them, so one pass still
            # takes ~interval but no two workers scrape in lockstep.
            healths: Dict[str, Optional[Dict[str, Any]]] = {}
            elapsed = 0.0
            for wid in sorted(list(self.workers), key=self._poll_phase):
                gap = self._poll_phase(wid) * interval - elapsed
                if gap > 0:
                    if self._stop.wait(gap):
                        return
                    elapsed += gap
                if self._stop.is_set():
                    return
                handle = self.workers.get(wid)
                if handle is None:
                    continue
                with self._lock:
                    if self._gates.get(wid) == "crash_loop":
                        # Parked by the supervisor: no polls, no
                        # respawns, until an operator ungates.
                        continue
                    self._scrape_locked(wid, handle)
                try:
                    h = handle.health()
                except Exception:  # noqa: BLE001 - unresponsive = dead
                    h = None
                healths[wid] = h
                verdict = self.control.gate_verdict(h)
                if verdict == "dead":
                    with self._lock:
                        self._misses[wid] = self._misses.get(wid, 0) + 1
                        misses = self._misses[wid]
                    if misses >= self.cfg.death_checks:
                        try:
                            self._replace(wid)
                        except Exception:  # noqa: BLE001 - keep looping
                            obs_metrics.inc("router.replace_errors")
                    continue
                with self._lock:
                    self._misses[wid] = 0
                    if verdict is None:
                        self._gates.pop(wid, None)
                    else:
                        self._gates[wid] = verdict
            # Autoscaling pass (no-op without a policy): the control
            # plane compares this pass's observed signals against the
            # declarative targets and spawns/retires through the
            # fleet's own primitives.
            if self.control.policy is not None:
                try:
                    self.control.reconcile(healths)
                except Exception:  # noqa: BLE001 - keep the loop alive
                    obs_metrics.inc("control.reconcile_errors")
            if self._stop.wait(max(0.0, interval - elapsed)):
                return

    # ------------------------------------------------------------------
    # death + journal handoff

    def _replace(self, wid: str):
        """Declare ``wid`` dead, hand its journal dir to a replacement,
        and let the router re-answer stranded futures.  Returns the
        replacement handle, or None when the crash-loop supervisor
        parked the slot instead."""
        old = self.workers[wid]
        uptime_s = time.monotonic() - getattr(old, "spawned_at", 0.0)
        with self._lock:
            self._gates[wid] = "dead"
        obs_metrics.inc("router.deaths")
        obs_trace.emit_record({"event": "router_death", "worker": wid,
                               "generation": old.generation})
        # Fleet verdicts are worker-scope (no idem): they feed counters,
        # `ia report`, and the decisions journal, but never a per-idem
        # chain — those steps come from the router's spill/rechain sites.
        if self.decisions is not None:
            self.decisions.record(None, "fleet", "death", "health_misses",
                                  worker_id=wid, generation=old.generation)
        # kill() releases the journal lock (in-process) or abandons it
        # on disk (subprocess SIGKILL — a real foreign stale lock); the
        # replacement's open() sweeps it, starts a fresh segment, and
        # recover() replays what's left.
        old.kill()
        verdict = self.supervisor.on_death(wid, uptime_s)
        if verdict["rapid"]:
            obs_metrics.inc("router.crash_loop_rapid")
        if verdict["gate"]:
            # Crash loop: park the slot instead of respawning forever.
            # Stranded futures get a terminal verdict — with no
            # replacement coming, hanging them would strand clients.
            obs_metrics.inc("router.crash_loops")
            obs_trace.emit_record({"event": "router_crash_loop",
                                   "worker": wid,
                                   "rapid": verdict["rapid"]})
            if self.decisions is not None:
                self.decisions.record(None, "fleet", "crash_loop",
                                      "rapid_deaths", worker_id=wid)
            with self._lock:
                self._gates[wid] = "crash_loop"
                self._misses[wid] = 0
            self.router.fail_pending(wid, Rejected("crash_loop"))
            return None
        if verdict["delay_s"]:
            obs_trace.emit_record({"event": "router_respawn_backoff",
                                   "worker": wid,
                                   "delay_s": verdict["delay_s"]})
            if self.decisions is not None:
                self.decisions.record(None, "fleet", "respawn_backoff",
                                      "recent_death", worker_id=wid,
                                      delay_s=verdict["delay_s"])
            if self._stop.wait(verdict["delay_s"]):
                return None  # fleet shutting down mid-backoff
        # Offline-compact the corpse's journal before the replacement
        # opens it: the dir is guaranteed writer-free in this window, so
        # a long-lived fleet's per-worker journals stay bounded by live
        # state instead of growing a segment per incarnation.  A
        # single-segment corpse (first kill) is skipped untouched —
        # the replacement keeps its historic handoff evidence (stale
        # lock sweep, contiguous segment numbering).  Refusal is safe —
        # the replacement just inherits the uncompacted history.
        if self.cfg.journal_root:
            serve_journal.autocompact(
                os.path.join(self.cfg.journal_root, wid))
        handle = self._spawn(wid, generation=old.generation + 1)
        recovered = handle.recovery_stats()
        obs_metrics.inc("router.handoffs")
        obs_trace.emit_record({"event": "router_handoff", "worker": wid,
                               "generation": handle.generation,
                               "recovered": recovered})
        if self.decisions is not None:
            self.decisions.record(None, "fleet", "handoff",
                                  "journal_inherited", worker_id=wid,
                                  generation=handle.generation)
        self.handoffs.append({"worker": wid,
                              "generation": handle.generation,
                              "recovered": recovered})
        with self._lock:
            self._gates.pop(wid, None)
            self._misses[wid] = 0
        self.router.on_worker_replaced(wid, handle)
        return handle

    # ------------------------------------------------------------------
    # observability

    def _worker_obs(self, wid: str, handle) -> Dict[str, Any]:
        """Obs identity for /healthz: which scope serves this wid and how
        stale the health loop's last scrape of it is."""
        with self._lock:
            scrape = self._scrapes.get(wid)
        obs: Dict[str, Any] = {
            "scope": handle.scope_id,
        }
        if scrape is not None:
            obs["last_scrape_age_s"] = round(
                time.monotonic() - scrape["t"], 3)
            if scrape["scope"] != obs["scope"]:
                obs["stale_scope"] = scrape["scope"]
        return obs

    def metrics_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """Fresh per-worker registry snapshots keyed by wid (the
        federation input: each is the worker's ISOLATED view — chained
        scope registry in-process, /metrics.json over the subprocess
        transport)."""
        out: Dict[str, Dict[str, Any]] = {}
        for wid, handle in sorted(self.workers.items()):
            snap = handle.snapshot()
            if snap is not None:
                out[wid] = snap
        return out

    def tenants_doc(self) -> Dict[str, Any]:
        """Fleet-level ``/tenants``: the local ledger (in-process
        transport shares one module plane, so this is the whole fleet)
        merged with whatever each handle can scrape (subprocess children
        serve their own ``/tenants``).  Mergeable space-saving keeps the
        federated top-K an honest interval."""
        local = obs_ledger.tenants_doc()
        docs = [local]
        for _wid, handle in sorted(self.workers.items()):
            doc = handle.tenants()
            if doc is not None:
                docs.append(doc)
        merged = obs_tenants.merge_docs(docs)
        merged["armed"] = any(d.get("armed") for d in docs)
        merged["recorded"] = sum(int(d.get("recorded") or 0)
                                 for d in docs)
        uptime = max((float(d.get("uptime_s") or 0.0) for d in docs),
                     default=0.0)
        if uptime:
            merged["uptime_s"] = uptime
            for row in merged["tenants"]:
                row["qps"] = round(row.get("requests", 0) / uptime, 4)
        return merged

    def metrics_text(self, worker: Optional[str] = None) -> Optional[str]:
        """Prometheus exposition: merged fleet view with ``worker=<wid>``
        labeled series, or one worker's isolated view (``worker=``
        selector).  Returns None for an unknown (or unreachable) wid."""
        if worker is not None:
            handle = self.workers.get(worker)
            if handle is None:
                return None
            snap = handle.snapshot()
            if snap is None:
                return None
            return obs_live.render_prometheus(snap)
        extra = None
        if self._scope is not None:
            # Fleet-scope families the workers do not chain into
            # (router.*) ride along labeled worker="fleet"; worker-
            # chained families are filtered inside render_fleet so
            # nothing is double counted.
            extra = ("fleet", self._scope.registry.snapshot())
        return obs_fleet.render_fleet(self.metrics_snapshots(), extra=extra)

    def health(self) -> Dict[str, Any]:
        """Fleet /healthz view: per-worker liveness + readiness + ring
        membership."""
        workers: Dict[str, Any] = {}
        for wid, handle in sorted(self.workers.items()):
            try:
                h = handle.health()
                workers[wid] = {
                    "ok": h.get("ok", False),
                    "ready": bool(h.get("ready", h.get("ok", False))),
                    "recovering": bool(h.get("recovering", False)),
                    "generation": handle.generation,
                    "pid": handle.pid,
                    "codec": handle.codec,
                    "queue_depth": h.get("queue_depth", 0),
                    "breakers": h.get("breakers", {}),
                    "journal": h.get("journal"),
                    "gate": self._gates.get(wid),
                    "obs": self._worker_obs(wid, handle),
                }
            except Exception as exc:  # noqa: BLE001 - report, not raise
                workers[wid] = {"ok": False, "ready": False,
                                "error": str(exc),
                                "generation": handle.generation,
                                "pid": handle.pid,
                                "gate": self._gates.get(wid),
                                "obs": self._worker_obs(wid, handle)}
        return {
            "ok": all(w.get("ok") for w in workers.values()),
            # Live size: with an autoscaling policy the fleet breathes,
            # so /healthz reports what exists, not what was configured.
            "size": len(self.workers),
            "configured_size": self.cfg.size,
            "wire": self.cfg.wire,
            "transport": self.cfg.transport,
            "ring": {"members": self.router.ring.members(),
                     "vnodes": self.cfg.vnodes},
            "pending": self.router.pending_count(),
            "handoffs": len(self.handoffs),
            "control": self.control.status(),
            "workers": workers,
        }
