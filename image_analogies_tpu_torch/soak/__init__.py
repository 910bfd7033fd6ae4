"""The traffic model of the port (``soak/trace.py``, the JAX package's
``TraceSpec``), which ``ia serve --selftest`` draws its load from.  The
soak driver and its invariants wait for ROADMAP Queue 1 item 10d."""

from image_analogies_tpu_torch.soak.trace import TraceSpec  # noqa: F401
