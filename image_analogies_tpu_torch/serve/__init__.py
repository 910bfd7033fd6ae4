"""The serving path of the port (the JAX package's ``serve/``): one
server, or a fleet of them behind a consistent-hash router.

Layering (each module one concern):

- :mod:`serve.types`    — ServeConfig / FleetConfig / Request / Response /
  Rejected.
- :mod:`serve.policy`   — the fleet's autoscaling targets
  (``ControlPolicy``) and per-tenant QoS: admission quotas and
  weighted-fair pop.
- :mod:`serve.queue`    — thread-safe admission queue (bounded depth,
  explicit ``Rejected(reason="queue_full")`` backpressure, EDF pop).
- :mod:`serve.batcher`  — the compatibility key micro-batching groups by
  (AnalogyParams digest + tune shape buckets + exemplar content).
- :mod:`serve.degrade`  — deadline cost model: cancel-before-dispatch vs
  degrade (fewer pyramid levels / coarser patch) decisions.
- :mod:`serve.breaker`  — the dispatch circuit breaker.
- :mod:`serve.worker`   — worker pool owning dispatch: compatible batches
  through the lane engine (``batch/engine.py``), the rest one by one;
  every engine call wrapped in ``utils.failure.run_with_retry``.
- :mod:`serve.server`   — lifecycle (warmup before traffic, drain on
  shutdown) + the in-process :class:`Client` API.
- :mod:`serve.journal`  — the write-ahead request journal (sealed
  segments, payload and response spills, replay, compaction) and the
  ``ia why`` forensic reader.
- :mod:`serve.wire`     — the ``IAF2`` raw-f32 plane frames and ``IAT1``
  trace-context frames.
- :mod:`serve.http`     — the loopback stdlib HTTP front end (``ia serve
  --http PORT``, the fleet's ``ia fleet --http PORT``).
- :mod:`serve.router`   — consistent-hash ring (sha256 positions) +
  spillover routing by batch key; re-answers in-flight futures across a
  worker death by idempotency key.
- :mod:`serve.transport` — how the fleet reaches a worker: in-process
  Servers, or ``serve.worker_main`` children on loopback ports; the
  crash-loop supervisor.
- :mod:`serve.control`  — the fleet's gate verdicts and autoscaling.
- :mod:`serve.fleet`    — N stable-identity Server workers behind the
  router: health-gate loop, dead-worker detection, and journal-directory
  handoff to the replacement (``ia fleet``).
- :mod:`serve.loadgen`  — ``ia serve --selftest N`` / ``ia fleet
  --selftest N`` synthetic load.

Everything here is host-side orchestration: no module of ``serve/``
launches a kernel or imports torch itself; the card's
work happens only inside the engine (``models/analogy.py``,
``batch/engine.py``), in this process or in a fleet's child.
"""

from image_analogies_tpu_torch.serve.server import Client, Server
from image_analogies_tpu_torch.serve.types import (
    DeadlineExceeded,
    FleetConfig,
    Rejected,
    Request,
    Response,
    ServeConfig,
)

__all__ = ["Client", "Server", "ServeConfig", "FleetConfig", "Request",
           "Response", "Rejected", "DeadlineExceeded"]
