"""Trace-driven soak harness of the port (the JAX package's ``soak/``).

- :mod:`soak.trace`      — :class:`TraceSpec`: a JSON artifact (seed,
  Zipf style popularity, diurnal + flash-crowd arrival shapes, mixed
  session kinds, priority classes) that replays from one seed — same
  spec ⇒ byte-identical request stream, locked by digest;
  ``smoke_spec`` / ``full_spec`` are the built-in profiles.
- :mod:`soak.driver`     — runs a spec against an autoscaling fleet with
  a chaos plan armed the whole run (worker kills, catalog tier
  evictions, torn telemetry artifacts, injected hop latency) while the
  timeline, ceilings and archive witnesses sample.
- :mod:`soak.invariants` — the end-of-run gate: zero-loss accounting
  reconciled against every worker journal, bit-identity of a seeded
  audit subset, the DDSketch p99.9 bound, zero ``obs.ceiling.*``
  alarms, and journals bounded under autocompaction.

``ia soak`` is the CLI.  The soak serves on the host oracle
(``backend="cpu"``, as the JAX soak does): it launches no kernel.
"""

from image_analogies_tpu_torch.soak.trace import TraceSpec  # noqa: F401
