"""Seeded fault-injection plane and resilience drills (the port's copy of
the JAX package's ``chaos/``).

The pyramid level is the natural recovery unit, and the engine has
level-granular retry and checkpoints; but recovery paths that are never
driven under realistic, reproducible fault schedules are robust only by
assertion.  This package drives them:

- :mod:`chaos.plan`   — :class:`ChaosPlan`: a seed plus per-site fault
  rules (a probability or an explicit call schedule, a fault kind).  The
  same seed gives the same fault schedule, so drills replay.
- :mod:`chaos.inject` — the injection plane.  Engine layers call
  ``site("level.dispatch", ...)`` at their boundaries; each site is a
  named no-op while chaos is disarmed (one module-bool check, no metric,
  log or lock: the obs/ off-path contract).
- :mod:`chaos.faults` — the fault kinds: transient errors, device OOM
  (a ``torch.cuda.OutOfMemoryError``), latency spikes and hangs,
  checkpoint byte corruption, worker-thread crashes, process death.
- :mod:`chaos.drills` — the seeded drill inputs and configs, each taking
  the device.
- :mod:`chaos.runner` — ``ia chaos``: run a workload under a plan and
  assert the resilience invariants (bit-identical output, no lost or hung
  request, queue drained, counters reconciled).

Nothing here imports jax or the JAX package (grep-locked by
tests/test_torch_ops.py); torch is imported by the fault kinds, and the
engine is reached through lazy imports inside the drills.
"""

from image_analogies_tpu_torch.chaos.faults import ProcessDeath  # noqa: F401
from image_analogies_tpu_torch.chaos.inject import (  # noqa: F401
    arm,
    armed,
    disarm,
    injected_total,
    plan_scope,
    plan_seed,
    site,
    snapshot,
)
from image_analogies_tpu_torch.chaos.plan import (  # noqa: F401
    KNOWN_SITES,
    ChaosPlan,
    SiteRule,
)

FAULT_KINDS = ("transient", "oom", "latency", "corrupt", "crash",
               "process_death")
