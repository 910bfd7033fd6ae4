"""Device observability of the port (counterpart of the JAX package's
``obs/device.py``).

The JAX package wraps each jit entry point in a compile-aware shim.  The
port has no jit programs: its device work is the hand-written kernels,
built by ``nvcc`` into libraries (``ops/_build.py``) and launched by the
wrappers of ``ops/match.py``.  So the counterpart is a set of hooks, not a
wrapper:

- :func:`note_launch`: each kernel wrapper, beside its ``LAUNCHES`` count,
  calls ``if _metrics._ACTIVE: note_launch(name, ...)``, which counts
  ``launch.<name>`` and, for the main path's two kernels, the work of the
  call as ``kernel.bytes`` and ``kernel.flops`` (:func:`argmin_work`,
  :func:`packed2k_work`: the counts ``chip_smoke.py``'s bounds use).
- :func:`note_compile` / :func:`note_cache_hit`: the library builds are
  the compiles.  A library ``nvcc`` built in this process counts in
  ``compile.count`` and ``compile.ms`` (with one ``compile`` record); one
  found already built in the library directory counts in
  ``compile.cache_hits``.
- :func:`record_memory`: ``torch.cuda.max_memory_allocated`` folded into
  the peak gauges ``hbm.peak_bytes.d<N>``.

With no run active a wrapper pays one module-bool read and no frame of
this module runs.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Tuple

from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import trace as _trace
from image_analogies_tpu_torch.utils import logging as _logging


def argmin_work(m: int, n: int, f: int) -> Tuple[int, int]:
    """(bytes, flops) of one fp32 argmin call: the M x F queries, the F
    used DB columns of N rows and the N norms read once, (idx, val)
    written once; 2 M N F operations."""
    return 4 * (m * f + n * f + n) + 8 * m, 2 * m * n * f


def packed2k_work(m: int, n: int, width: int) -> Tuple[int, int]:
    """(bytes, flops) of one packed2k call at ``width`` lanes: the bf16
    query rows and DB rows read once, (idx, val) written once; 2 M N width
    operations."""
    return 2 * (m * width + n * width) + 8 * m, 2 * m * n * width


def note_launch(name: str, nbytes: int = 0, flops: int = 0) -> None:
    """One launch of kernel ``name`` (a ``LAUNCHES`` key) and its work."""
    _metrics.inc("launch." + name)
    if nbytes:
        _metrics.inc("kernel.bytes", nbytes)
    if flops:
        _metrics.inc("kernel.flops", flops)


def note_compile(name: str, ms: float) -> None:
    """One library built by ``nvcc`` in this process, in ``ms``."""
    if not _metrics._ACTIVE:
        return
    _metrics.inc("compile.count")
    _metrics.inc("compile.ms", ms)
    rec: Dict[str, Any] = {"event": "compile", "name": name,
                           "ms": round(ms, 3), "ok": True}
    attrs = _trace.current_span_attrs()
    if attrs and "level" in attrs:
        rec["level"] = attrs["level"]
    ctx = _trace._CURRENT
    _logging.emit(rec, ctx.log_path if ctx is not None else None)


def note_cache_hit(name: str) -> None:
    """One library loaded from the library directory, built earlier."""
    if _metrics._ACTIVE:
        _metrics.inc("compile.cache_hits")


def record_memory(level: Optional[int] = None,
                  log_path: Optional[str] = None) -> None:
    """Fold each initialized card's ``max_memory_allocated`` into the
    ``hbm.peak_bytes.d<N>`` peak gauges and, with a log path, one ``hbm``
    record.  Silent on the CPU and where CUDA is not initialized; never
    resets the caller's peak statistics."""
    if not _metrics._ACTIVE:
        return
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    peaks: Dict[str, int] = {}
    for d in range(torch.cuda.device_count()):
        peak = int(torch.cuda.max_memory_allocated(d))
        if peak:
            _metrics.max_gauge(f"hbm.peak_bytes.d{d}", float(peak))
            peaks[f"d{d}"] = peak
    if peaks and log_path:
        rec: Dict[str, Any] = {"event": "hbm", "peaks": peaks}
        if level is not None:
            rec["level"] = level
        _logging.emit(rec, log_path)
