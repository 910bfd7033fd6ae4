"""Observability of the port (the JAX package's ``obs/`` without its live
exposition, archive, fleet roll-up, reports and exports): the metrics
registry (``metrics.py`` over ``quantiles.py`` and ``recorder.py``, with
its black-box dumps), the run scope, spans and request context
(``trace.py``), the launch, compile and memory hooks (``device.py``),
and the planes the server reads: the SLO tracker (``slo.py``), the
tenant sketch and cost ledger (``tenants.py``, ``ledger.py``), the
windowed timeline (``timeline.py``) and the resource-ceiling watchdogs
(``ceilings.py``).  Off by default (``AnalogyParams.metrics``); with no run
active every hook is one module-bool read."""
