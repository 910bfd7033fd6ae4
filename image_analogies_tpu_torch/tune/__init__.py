"""Launch-geometry tuning of the port (counterpart of the JAX package's
``tune/``):

- ``geometry.py``: the default knobs (pure);
- ``store.py`` + ``resolve.py``: the persistent JSON store of measured
  winners and the funnel every launch-geometry knob flows through
  (override > env > store > packaged ``tables.py`` > default);
- ``buckets.py``: shape buckets (the DB side and the batched query side);
- ``autotune.py`` (``ia tune``) and ``warmup.py`` (``ia warmup`` and the
  library directory): imported by their callers, not here, so importing
  ``tune`` from the kernels never pulls in the model layer.
"""
