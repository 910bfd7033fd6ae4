"""Core serving datatypes (the port's copy of the JAX package's
``serve/types.py``).

Host-side only: numpy planes in, numpy planes out.  The engine types
(`AnalogyParams`, `AnalogyResult`) are reused as they are, so a served
request runs the code path a CLI run does, to the bit.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.serve.policy import ControlPolicy, QosPolicy


class Rejected(RuntimeError):
    """Admission control refused the request (no hang, no unbounded queue).

    ``reason`` is machine-readable: ``"queue_full"`` when the bounded queue
    is at depth, ``"shutting_down"`` once drain has begun,
    ``"breaker_open"`` when admission sheds because the dispatch circuit
    breaker is open (one hop before the queue — see serve/breaker.py),
    ``"circuit_open"`` when the breaker trips between an accepted
    request's admission and its dispatch,
    ``"worker_crash"`` when a crashed worker exhausted the requeue budget,
    ``"quota"`` when the tenant's per-style admission token bucket is
    empty (serve/policy.py — the viral style degrades itself, not the
    fleet; like ``"poison"`` this is a verdict about the REQUEST, so
    the router never spills it to another worker),
    ``"poison"`` when the request's idempotency key was previously marked
    poisoned in the write-ahead journal (it exhausted ``crash_requeues``
    once already — resubmission sheds instantly, before the breaker, so a
    known-poison key can neither re-crash the server nor trip the
    breaker), ``"bad_idempotency_key"`` when a journaled server is given
    a key outside ``[A-Za-z0-9_-]{1,64}`` (keys name spill files).
    """

    def __init__(self, reason: str):
        super().__init__(f"request rejected: {reason}")
        self.reason = reason


class DeadlineExceeded(RuntimeError):
    """Deadline expired before dispatch; the request was cancelled, never
    sent to the device."""

    def __init__(self, request_id: int, late_s: float):
        super().__init__(
            f"request {request_id} deadline expired {late_s * 1e3:.1f}ms "
            "before dispatch")
        self.request_id = request_id
        self.late_s = late_s


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler knobs.  ``params`` is the default engine config; requests
    may carry their own (each distinct digest forms its own batch key)."""

    params: AnalogyParams
    queue_depth: int = 32          # admission bound; above it -> Rejected
    batch_window_ms: float = 4.0   # coalescing wait once a leader is held
    max_batch: int = 8             # requests per batched invocation
    workers: int = 2
    default_deadline_s: Optional[float] = None  # None -> no deadline
    degrade: bool = True           # False -> never degrade, only timeout
    request_retries: int = 1       # run_with_retry budget around dispatch
    warmup_sizes: Tuple[Tuple[int, int], ...] = ()  # (h, w) AOT precompile
    drain_timeout_s: float = 60.0
    # Deadline-aware batch pop: the leader is the earliest-deadline
    # request instead of the oldest, so tight-deadline traffic dispatches
    # first.  Undeadlined (or slack) requests are protected by the aging
    # bound: once the oldest waiter's queue age exceeds
    # ``ordering_age_bound_s`` it is promoted to leader regardless of
    # deadlines — EDF can reorder, never starve.
    deadline_ordering: bool = True
    ordering_age_bound_s: float = 5.0
    # Dispatch circuit breaker (serve/breaker.py): this many CONSECUTIVE
    # batch-dispatch failures trip it open (0 disables); while open,
    # requests fail fast with Rejected("circuit_open") instead of burning
    # workers, and one probe per cooldown tests recovery.
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 1.0
    # Persist the learned cost-model rate into the tune store on shutdown
    # so the NEXT server seeds its degrade estimates from it
    # (provenance "store").  Off by default: tests and embedders should
    # not write store files unless asked; `ia serve` enables it.
    cost_persist: bool = False
    # A crashed worker thread (an escape below the per-request handler)
    # requeues its batch's unresolved requests up to this many times each
    # before failing them with Rejected("worker_crash") — no request is
    # ever silently lost, and a poison request can't requeue forever.
    crash_requeues: int = 1
    # SLO over deadline outcomes (obs/slo.py): target fraction of
    # deadlined requests that must meet their deadline, with fast
    # (paging) and slow (ticket) burn-rate windows.  Exported as gauges
    # and in /healthz; undeadlined traffic is not counted.
    slo_target: float = 0.99
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0
    # Durability (serve/journal.py): when set, every request is recorded
    # in a write-ahead journal under this directory at admit time and on
    # each state transition; Server.recover() replays it on startup
    # (done-dedupe, re-enqueue, poison shed).  None (default) disables
    # the journal entirely — the request path never touches the module.
    journal_dir: Optional[str] = None
    # fsync each journal append (the durability guarantee).  Tests and
    # throughput-over-durability embedders may turn it off.
    journal_fsync: bool = True
    # The lane engine (batch/engine.py): a compatible same-key batch of
    # >= 2 requests on the device backend dispatches as ONE engine call
    # (one level scan, k lanes) with per-member fault isolation.
    # Incompatible batches fall back to the sequential per-member loop
    # with the reason on batch.fallback_sequential.<reason>.  Outputs
    # are bit-identical either way (the loadgen selftest gates it).
    batch_engine: bool = True
    # Tenant metering plane (obs/ledger.py): arm the per-request cost
    # ledger + space-saving heavy-hitter tracker for the server's
    # lifetime.  One style (= batcher exemplar sha1) is one tenant;
    # /tenants and `ia top --tenants` read the resulting document.
    # Disarming makes the cost path one bool check (zero-alloc,
    # tracemalloc-locked in tests) — what bench.py's
    # ledger_overhead_pct measures.
    ledger: bool = True
    ledger_capacity: int = 512     # bounded in-memory cost vectors
    tenant_k: int = 16             # heavy-hitter slots (O(K) memory)
    # Per-tenant QoS (serve/policy.py): admission token buckets fed by
    # the tenants sketch's observed cost shares + weighted-fair batch
    # pop across tenants.  None (default) disables QoS entirely — the
    # admission and pop paths are those of a server without QoS.
    qos: Optional[QosPolicy] = None

    def __post_init__(self):
        if self.ledger_capacity < 1:
            raise ValueError("ledger_capacity must be >= 1")
        if self.tenant_k < 1:
            raise ValueError("tenant_k must be >= 1")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.breaker_threshold < 0 or self.crash_requeues < 0:
            raise ValueError("breaker_threshold/crash_requeues must be >= 0")
        if self.ordering_age_bound_s < 0:
            raise ValueError("ordering_age_bound_s must be >= 0")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError("slo_target must be in (0, 1)")
        if (self.slo_fast_window_s <= 0
                or self.slo_slow_window_s < self.slo_fast_window_s):
            raise ValueError(
                "slo windows must satisfy 0 < fast <= slow")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router + worker-fleet knobs (serve/fleet.py, serve/router.py).

    ``serve`` is the per-worker template; each worker gets a copy with
    ``journal_dir`` pointed at ``<journal_root>/<wid>`` (when
    ``journal_root`` is set) so a dead worker's journal directory can be
    handed, whole, to its replacement."""

    serve: ServeConfig
    size: int = 2                  # number of in-process Server workers
    journal_root: Optional[str] = None
    vnodes: int = 32               # virtual nodes per worker on the ring
    # Worker transport (serve/transport.py): "inproc" keeps today's
    # in-process Server workers; "subprocess" spawns each worker as a
    # `python -m image_analogies_tpu_torch.serve.worker_main` child on its
    # own loopback HTTP port — same wire frames, same journal handoff, but
    # kill/replace is a real SIGKILL + re-spawn on the same journal dir.
    transport: str = "inproc"
    # Subprocess readiness handshake deadline: the child must report
    # {pid, port} over its startup pipe within this many seconds (torch
    # import, the card's context, warmup and journal replay all happen
    # before ready).
    spawn_timeout_s: float = 120.0
    # Crash-loop supervisor (transport.CrashLoopSupervisor): a worker
    # death within ``crash_loop_window_s`` of its own spawn counts as
    # RAPID; respawns after rapid deaths back off (capped jittered,
    # utils.failure.backoff_delay over backoff_s/backoff_cap_s below),
    # and ``crash_loop_threshold`` consecutive rapid deaths gate the
    # worker ("crash_loop") instead of respawning forever.  0 disables
    # the gate (respawn always).
    crash_loop_window_s: float = 1.0
    crash_loop_threshold: int = 3
    # Router<->worker hop encoding: "auto"/"binary" negotiate the IAF2
    # frame (serve/wire.py) when the worker advertises it, "json" forces
    # the list transport (the fallback both sides always speak).
    wire: str = "auto"
    health_interval_s: float = 0.25  # health-gate poll cadence
    death_checks: int = 2          # consecutive failed polls -> dead
    # Gate a worker (spill its keys to the next ring successor) when its
    # queue depth reaches this fraction of queue_depth, or any breaker
    # reports "open".
    spill_queue_frac: float = 0.8
    spill_retries: int = 3         # extra route attempts after the first
    backoff_s: float = 0.05        # utils.failure.backoff_delay base
    backoff_cap_s: float = 1.0
    # Elastic-fleet control plane (serve/control.py): when set, the
    # fleet starts at ``policy.min_workers`` (``size`` is ignored) and
    # the health daemon's reconcile pass scales it between min and max
    # under the declarative targets.  None (default) keeps the fixed
    # ``size`` fleet with no autoscaling — only the gate/death verdicts
    # (now rendered by the control plane) remain.
    policy: Optional[ControlPolicy] = None

    def __post_init__(self):
        if self.size < 1:
            raise ValueError("size must be >= 1")
        if self.vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if self.wire not in ("auto", "binary", "json"):
            raise ValueError("wire must be auto|binary|json")
        if self.transport not in ("inproc", "subprocess"):
            raise ValueError("transport must be inproc|subprocess")
        if self.spawn_timeout_s <= 0:
            raise ValueError("spawn_timeout_s must be > 0")
        if self.crash_loop_window_s < 0 or self.crash_loop_threshold < 0:
            raise ValueError(
                "crash_loop_window_s/crash_loop_threshold must be >= 0")
        if self.health_interval_s <= 0:
            raise ValueError("health_interval_s must be > 0")
        if self.death_checks < 1:
            raise ValueError("death_checks must be >= 1")
        if not 0.0 < self.spill_queue_frac <= 1.0:
            raise ValueError("spill_queue_frac must be in (0, 1]")
        if self.spill_retries < 0:
            raise ValueError("spill_retries must be >= 0")
        if self.backoff_s <= 0 or self.backoff_cap_s < self.backoff_s:
            raise ValueError(
                "backoff must satisfy 0 < backoff_s <= backoff_cap_s")


@dataclasses.dataclass
class Request:
    """One enqueued synthesis job.  ``deadline`` is absolute
    ``time.monotonic()`` seconds (None = unbounded)."""

    request_id: int
    a: np.ndarray
    ap: np.ndarray
    b: np.ndarray
    params: AnalogyParams
    key: Tuple[Any, ...]
    future: "Future[Response]"
    deadline: Optional[float] = None
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    t_dequeue: Optional[float] = None
    requeues: int = 0  # crash-containment requeue count (bounded)
    # Cross-hop trace context (obs/trace.py TRACE_KEYS): captured from
    # the submitting thread, adopted by the worker thread that runs the
    # request — worker threads are NOT the submit thread, so the trace
    # must travel in the request, not in a thread-local.
    trace: Optional[Dict[str, str]] = None
    # Encoded request size as it crossed the HTTP boundary (0 for
    # in-process submissions) — part of the cost vector (obs/ledger.py).
    wire_bytes: int = 0
    # Priority class weight (serve/policy.py PRIORITY_*): the tenant's
    # stride-scheduling share in the weighted-fair queue pop.  Carried
    # per request (X-IA-Priority over HTTP); inert unless the queue
    # runs with a QosPolicy that arms weighted_fair.
    priority: int = 2
    # Write-ahead-journal identity (None when the journal is disabled).
    # ``replayed`` marks a request reconstructed by Server.recover() —
    # its dispatch transitions continue the pre-restart history.
    idem: Optional[str] = None
    replayed: bool = False

    def __post_init__(self):
        if self.priority < 1:
            raise ValueError("priority must be >= 1")

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - (time.monotonic() if now is None else now)


@dataclasses.dataclass
class Response:
    """Completed request.  ``degraded`` is None for a full-fidelity run,
    else the substitutions made to meet the deadline (e.g.
    ``{"levels": 1, "patch_size": 3}``) — degraded responses are valid
    outputs, just flagged."""

    request_id: int
    bp: np.ndarray
    bp_y: np.ndarray
    stats: Dict[str, Any]
    batch_size: int
    queue_ms: float
    dispatch_ms: float
    total_ms: float
    degraded: Optional[Dict[str, Any]] = None

    @property
    def status(self) -> str:
        return "degraded" if self.degraded else "ok"
