"""The single-process serving path of the port (the JAX package's
``serve/``, without its fleet).

Layering (each module one concern):

- :mod:`serve.types`    — ServeConfig / Request / Response / Rejected.
- :mod:`serve.policy`   — per-tenant QoS: admission quotas and
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
  --http PORT``).
- :mod:`serve.loadgen`  — ``ia serve --selftest N`` synthetic load.

Everything here is host-side orchestration: no module of ``serve/``
launches a kernel or imports torch itself; the card's
work happens only inside the engine (``models/analogy.py``,
``batch/engine.py``).  The fleet (ROADMAP Queue 1 item 10c) is not
ported yet.
"""

from image_analogies_tpu_torch.serve.server import Client, Server
from image_analogies_tpu_torch.serve.types import (
    DeadlineExceeded,
    Rejected,
    Request,
    Response,
    ServeConfig,
)

__all__ = ["Client", "Server", "ServeConfig", "Request", "Response",
           "Rejected", "DeadlineExceeded"]
