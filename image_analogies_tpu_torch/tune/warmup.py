"""Warmup and runtime wiring (counterpart of the JAX package's
``tune/warmup.py``).

The JAX package's compile cache is XLA's persistent cache; the port's is
the ``nvcc`` library directory (``ops/_build.py``): ``compile_cache_dir``
(``IA_COMPILE_CACHE_DIR`` over ``AnalogyParams.compile_cache_dir`` over
``image_analogies_tpu_torch/_build/``) is where a process builds its
kernel libraries and where a later process finds them.
:func:`apply_runtime_config` is the one call the driver makes per run to
apply it, the upload cache's budget and the exemplar catalog's root and
host budget.  :func:`warmup` runs one real
synthesis on seeded planes at a target size with metrics on, so every
library its levels launch is built (and kept in the directory) before
traffic; ``ia warmup`` is its CLI face.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from image_analogies_tpu_torch.ops import _build
from image_analogies_tpu_torch.utils import devcache


def compile_cache_dir(params: Any = None) -> Optional[str]:
    """The configured library directory: ``IA_COMPILE_CACHE_DIR``, else
    ``params.compile_cache_dir`` (None: the default)."""
    env = os.environ.get(_build.COMPILE_CACHE_ENV, "").strip()
    if env:
        return env
    return getattr(params, "compile_cache_dir", None)


def apply_runtime_config(params: Any = None) -> str:
    """Per-run wiring: the library directory (each run's params decide; None
    is the default directory), the upload cache's byte budget and the
    catalog's root and host-tier budget (``catalog.tiers.configure``; a
    run without them clears the previous run's, the tiers stay warm).
    Returns the library directory in effect."""
    from image_analogies_tpu_torch.catalog import tiers as catalog_tiers

    mb = getattr(params, "devcache_max_bytes", None)
    if mb:
        devcache.set_max_bytes(int(mb))
    catalog_tiers.configure(
        root_dir=getattr(params, "catalog_dir", None),
        host_bytes=getattr(params, "catalog_host_bytes", None))
    return _build.set_build_dir(compile_cache_dir(params))


def warmup(params: Any, height: int, width: int, *,
           exemplar_height: Optional[int] = None,
           exemplar_width: Optional[int] = None,
           seed: int = 0) -> Dict[str, Any]:
    """Run one synthesis of a ``height`` x ``width`` B against an exemplar of
    ``exemplar_height`` x ``exemplar_width`` (default the same) on seeded
    planes, with metrics on: the driver loads every library its levels
    launch first (``CudaMatcher.load_kernels``), building the missing ones
    in the library directory.  Returns the run's compile counters (the JAX
    function's keys): in a fresh process ``compile_count`` is the number
    of libraries built, ``compile_cache_hits`` the number found built."""
    import numpy as np

    from image_analogies_tpu_torch.models.analogy import create_image_analogy
    from image_analogies_tpu_torch.obs import metrics as _metrics
    from image_analogies_tpu_torch.obs import trace as _trace

    eh = exemplar_height or height
    ew = exemplar_width or width
    rng = np.random.RandomState(seed)
    a = rng.rand(eh, ew).astype(np.float32)
    ap = rng.rand(eh, ew).astype(np.float32)
    b = rng.rand(height, width).astype(np.float32)
    wp = params.replace(metrics=True, checkpoint_dir=None,
                        resume_from_level=None, save_levels_dir=None)
    with _trace.run_scope(wp):
        create_image_analogy(a, ap, b, wp)
        snap = _metrics.snapshot() or {}
    counters = snap.get("counters", {})
    return {"height": height, "width": width,
            "exemplar": [eh, ew],
            "levels": wp.levels,
            "compile_count": counters.get("compile.count", 0),
            "compile_ms": counters.get("compile.ms", 0),
            "compile_cache_hits": counters.get("compile.cache_hits", 0),
            "compile_cache_dir": compile_cache_dir(wp)}


def warmup_buckets(params: Any, sizes, *, seed: int = 0):
    """:func:`warmup` over a set of (height, width) target sizes; one
    summary each."""
    return [warmup(params, int(h), int(w), seed=seed) for (h, w) in sizes]


def fleet_libraries(params: Any) -> Dict[str, str]:
    """Before the first spawn of a subprocess fleet: build every missing
    kernel library once, in the parent, into the directory in effect for
    ``params`` (the build ``ia warmup`` ends in, one ``nvcc`` a source, all
    started together), and return the environment that names it to the
    children (``{IA_COMPILE_CACHE_DIR: dir}``), so that N children neither
    compile inside their readiness windows nor build N copies.  The JAX
    fleet's children compile their programs themselves; this is the
    port's counterpart.  Returns {} when there is nothing to build for:
    the host oracle, a CPU device, or no card (a child asked for the card
    there refuses in ``Server.start``)."""
    if getattr(params, "backend", "cuda") != "cuda" or \
            not str(getattr(params, "device", "cuda")).startswith("cuda"):
        return {}
    import torch

    if not torch.cuda.is_available():
        return {}
    directory = _build.set_build_dir(compile_cache_dir(params))
    missing = [n for n in _build.KERNEL_SOURCES
               if not os.path.exists(_build.library_path(n))]
    if missing:
        _build.build(missing)
    return {_build.COMPILE_CACHE_ENV: directory}
