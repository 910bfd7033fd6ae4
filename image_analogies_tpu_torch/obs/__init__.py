"""Run-scoped observability of the port (the part of the JAX package's
``obs/`` that a run records about itself): the metrics registry
(``metrics.py`` over ``quantiles.py`` and ``recorder.py``), the run scope
and spans (``trace.py``), and the launch, compile and memory hooks
(``device.py``).  Off by default (``AnalogyParams.metrics``); with no run
active every hook is one module-bool read."""
