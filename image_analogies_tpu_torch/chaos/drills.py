"""Drill workloads: small, deterministic jobs the runner executes under a
fault plan (the port's copy of the JAX package's ``chaos/drills.py``).

Everything here is seeded numpy — the SAME inputs and params serve the
clean reference run and the chaos run, so "bit-identical output" is a
meaningful assertion, not a tolerance check.  The engine is imported
inside the calls.

Every config function takes the ``device``.  The JAX drills name
``backend="cpu"`` (the host oracle) or ``backend="tpu"`` (the device
matcher); here both become the port's device matcher, ``backend="cuda"``
on ``device``, so on the card the kernels sit under the faults.
``backend="cpu"`` (the port's ``CpuMatcher``, the JAX package's
``backend="cpu"``) is the caller's choice where a drill's report is held
to the JAX drill's.  The one fixed exception is :func:`catalog_params`:
the engine's level loop consults the catalog's feature tiers only for the
host oracle (as the JAX one does), so the ``devcache.tier`` drill runs
``backend="cpu"`` on every device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def make_inputs(size: Tuple[int, int] = (20, 20), seed: int = 7
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic (A, A', B) planes for one synthesis."""
    h, w = size
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w).astype(np.float32),
            rng.rand(h, w).astype(np.float32),
            rng.rand(h, w).astype(np.float32))


def image_params(*, levels: int = 2, retries: int = 3,
                 checkpoint_dir: Optional[str] = None,
                 dispatch_timeout_s: float = 0.0, device: str = "cuda",
                 backend: str = "cuda"):
    """Small engine config for image drills.  Patch 3 / tiny planes: a
    drill exercises control flow, not throughput."""
    from image_analogies_tpu_torch.config import AnalogyParams

    return AnalogyParams(backend=backend, device=device, levels=levels,
                         patch_size=3, coarse_patch_size=3,
                         level_retries=retries,
                         checkpoint_dir=checkpoint_dir,
                         dispatch_timeout_s=dispatch_timeout_s,
                         metrics=True)


def catalog_params(catalog_dir: str, *, levels: int = 2,
                   device: str = "cuda"):
    """Catalog-tier drill config: the host oracle (the only matcher the
    level loop hands the feature tiers to) with the exemplar catalog
    rooted at ``catalog_dir``.  No retries — the devcache.tier directive never
    raises; recovery is the tier fall-through itself."""
    from image_analogies_tpu_torch.config import AnalogyParams

    return AnalogyParams(backend="cpu", device=device, levels=levels,
                         patch_size=3, coarse_patch_size=3, level_retries=0,
                         catalog_dir=catalog_dir, metrics=True)


def ann_params(catalog_dir: str, *, levels: int = 2, device: str = "cuda"):
    """Two-stage ANN drill config: the device matcher's wavefront with the
    exemplar catalog rooted at ``catalog_dir`` and the prefilter armed.
    No retries — the ``match.prefilter`` corrupt directive never raises;
    recovery is the quarantine → exact-fallback → rebuild chain itself."""
    from image_analogies_tpu_torch.config import AnalogyParams

    return AnalogyParams(backend="cuda", device=device, strategy="wavefront",
                         levels=levels, patch_size=3, coarse_patch_size=3,
                         level_retries=0, ann_prefilter=True,
                         catalog_dir=catalog_dir, metrics=True)


def run_image(a: np.ndarray, ap: np.ndarray, b: np.ndarray, params
              ) -> np.ndarray:
    """One engine synthesis; returns the host bp plane."""
    from image_analogies_tpu_torch.models.analogy import create_image_analogy

    return np.asarray(create_image_analogy(a, ap, b, params).bp)


def batch_params(*, levels: int = 2, device: str = "cuda"):
    """Lane-engine drill config: the device matcher's batched strategy, no
    luminance remap (random targets would diverge the A/A' DB and refuse
    the batch), no level retries (the engine refuses those — per-lane
    isolation IS its recovery story)."""
    from image_analogies_tpu_torch.config import AnalogyParams

    return AnalogyParams(backend="cuda", device=device, strategy="batched",
                         levels=levels, patch_size=3, coarse_patch_size=3,
                         remap_luminance=False, level_retries=0,
                         metrics=True)


def make_batch_load(k: int, size: Tuple[int, int] = (16, 16), seed: int = 7
                    ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """One exemplar pair + k distinct same-shape targets (the lane
    engine's admission shape)."""
    rng = np.random.RandomState(seed)
    h, w = size
    return (rng.rand(h, w).astype(np.float32),
            rng.rand(h, w).astype(np.float32),
            [rng.rand(h, w).astype(np.float32) for _ in range(k)])


def make_serve_load(n: int, size: Tuple[int, int] = (12, 12), seed: int = 7
                    ) -> List[Dict[str, np.ndarray]]:
    """N batch-compatible requests (shared exemplars, distinct targets)."""
    rng = np.random.RandomState(seed)
    h, w = size
    a = rng.rand(h, w).astype(np.float32)
    ap = rng.rand(h, w).astype(np.float32)
    return [{"index": i, "a": a, "ap": ap,
             "b": rng.rand(h, w).astype(np.float32)}
            for i in range(n)]


def serve_config(*, workers: int = 2, max_batch: int = 4,
                 crash_requeues: int = 1, breaker_threshold: int = 5,
                 deadline_ordering: bool = True,
                 batch_window_ms: float = 2.0,
                 journal_dir: Optional[str] = None, device: str = "cuda",
                 backend: str = "cuda"):
    """Small serve config for serve drills.

    ``journal_dir`` arms the write-ahead journal (kill-restart drill);
    drill journals skip fsync — the drill restarts in-process, so
    OS-buffer durability is enough and the selftest stays fast.

    The lane engine is off: the JAX drills serve on the host oracle, which
    never tries it, so their batches run member by member, and the
    journal visit schedules of ``runner.plan_for_kind`` count on that (a
    lane-engine attempt writes every member's ``dispatched`` line before
    the engine refuses the drill's remap-divergent targets).  The lane
    engine's own fault boundary is the ``batch_partial`` drill's."""
    from image_analogies_tpu_torch.serve.types import ServeConfig

    return ServeConfig(
        params=image_params(levels=1, retries=0, device=device,
                            backend=backend),
        queue_depth=64,
        batch_window_ms=batch_window_ms,
        max_batch=max_batch,
        workers=workers,
        request_retries=2,
        crash_requeues=crash_requeues,
        breaker_threshold=breaker_threshold,
        deadline_ordering=deadline_ordering,
        drain_timeout_s=60.0,
        journal_dir=journal_dir,
        journal_fsync=False,
        batch_engine=False,
    )
