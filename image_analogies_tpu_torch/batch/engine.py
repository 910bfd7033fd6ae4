"""The lane engine (counterpart of the JAX package's ``batch/engine.py``).

The driver (``models/analogy.py``) runs one B plane per coarse-to-fine
loop, and every wavefront step or scan row pays its ~58 (batched: ~190)
launches for that one plane.  For k targets against ONE exemplar pair the
A/A' feature DB and the level schedule are shared; only the query planes
differ.  This engine stacks the k query sides on a lane axis and runs the
singleton's scan once for all of them
(``CudaMatcher.synthesize_level_lanes``): each step or row makes one
anchor or approximate-match launch on k x M query rows.

Correctness contract: each member is **bit-identical** to its singleton
run.  Each lane runs the singleton's ``build_features`` on its own inputs,
the members' A/A' planes are checked bitwise-equal, and the lane scan
gives every query row the ops it has in a singleton, at an address of the
same alignment.  A batch that would break this raises
:class:`BatchIncompatible`, whose ``reason`` says why:

  level_retries     retries rebuild one member's level; a shared scan
                    cannot re-run one lane
  unsupported       a strategy without a lane scan (exact, rowwise), or a
                    run that needs the sequential driver (checkpoints,
                    saved levels, profiles, resume)
  shape_mismatch    members disagree on shape where sharing needs
                    equality (wavefront lanes, unbucketed batched lanes,
                    the width of bucketed ones, the level count)
  mixed_bucket      bucketed members land in different query buckets at
                    some level
  remap_divergence  remap_luminance ties the A/A' DB to each member's B
                    statistics, and the members' differ
  pad_waste         a member's finest-level query bucket is padding past
                    the ceiling (``tune.resolve.batch_pad_waste_pct``)

Each refusal also counts ``batch.fallback_sequential.<reason>`` in an
active metrics run; an admitted batch counts ``batch.launches`` and
``batch.lanes`` (k), sets the ``batch.pad_waste_frac`` gauge, and a lane
whose build fails counts ``batch.lane_faults`` (the JAX names).  The run
opens its own obs run scope and tune pin scope, as a singleton's does.
  sharded           data_shards > 1 composes with the mesh wavefront, not
                    the lane axis; and db_shards > 1: the lanes would read
                    the sharded level's 1-row placeholders (the JAX
                    engine does, and its lanes come out wrong)

  cpu_backend       ``backend="cpu"``: the host oracle's literal raster
                    scan has no lane axis

``degrade_divergence`` is serve's (``serve/worker.py``).  The chaos site
``engine.batch`` opens each lane's build, inside the per-lane fault
boundary.
``dispatch_timeout_s`` and ``pipeline`` are neither refused nor applied,
as in the JAX engine: lanes run lock-step, with no watchdog.

Query-side bucketing (``tune/buckets.py``, ``shape_buckets``) admits
members of one width whose heights share a query bucket at every level:
the lane scan's row loop runs to the tallest, a shorter lane's extra rows
touch only its zero rows and the carry rows the crop drops.

Lane-fault isolation: a ``build_features`` exception in one lane marks
that member failed and a live lane's query side takes its slot (k stays
fixed); the other members finish bit-identical.  The engine returns one
entry per member: its ``AnalogyResult``, or the exception that failed it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.backends import get_backend
from image_analogies_tpu_torch.backends.base import LevelJob
from image_analogies_tpu_torch.backends.cuda import CudaMatcher
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.models.analogy import (
    AnalogyResult,
    _color_output,
    _fetch_finest,
    _host,
    _prep_planes,
    create_image_analogy,
)
from image_analogies_tpu_torch.obs import device as obs_device
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.ops.features import spec_for_level
from image_analogies_tpu_torch.ops.pyramid import (
    build_pyramid_np,
    num_feasible_levels,
)
from image_analogies_tpu_torch.tune import buckets as tune_buckets
from image_analogies_tpu_torch.tune import resolve as tune_resolve
from image_analogies_tpu_torch.tune import warmup as tune_warmup


class BatchIncompatible(RuntimeError):
    """This batch cannot share one lane scan; run its members one by one.
    ``reason`` names why (the module docstring's vocabulary)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"batch incompatible ({reason})"
                         + (f": {detail}" if detail else ""))


def _refuse(reason: str, detail: str = "") -> BatchIncompatible:
    """The refusal to raise, counted as
    ``batch.fallback_sequential.<reason>``."""
    obs_metrics.inc(f"batch.fallback_sequential.{reason}")
    return BatchIncompatible(reason, detail)


def create_image_analogy_batch(
    a: np.ndarray,
    ap: np.ndarray,
    targets: Sequence[np.ndarray],
    params: AnalogyParams = AnalogyParams(),
    backend: Optional[CudaMatcher] = None,
    device=None,
) -> List[Any]:
    """Synthesize B'_i for every B_i in ``targets`` against one (A, A')
    pair, the k members sharing one level scan per level.

    ``device`` None means ``params.device`` ("cuda" by default), which
    raises when no card is present; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU.  ``backend`` replaces the matcher
    (``device`` is then the matcher's).  Returns a list the length of
    ``targets``: the member's ``AnalogyResult``, or the exception that
    failed its lane.  Raises :class:`BatchIncompatible` when the batch as
    a whole cannot share the scan; the caller then runs the members one by
    one.  A batch of one is the singleton run (``create_image_analogy``).
    """
    if backend is None:
        backend = get_backend(params, device)
    targets = list(targets)
    if not targets:
        return []
    if len(targets) == 1:
        try:
            return [create_image_analogy(a, ap, targets[0], params,
                                         backend=backend)]
        except Exception as e:  # noqa: BLE001 - the per-member contract
            return [e]
    tune_warmup.apply_runtime_config(params)
    with obs_trace.run_scope(params, manifest_extra=dict(
            tune_resolve.manifest_info(),
            device=str(getattr(backend, "device", None)))):
        with tune_resolve.pin_scope():
            return _run_batch(a, ap, targets, params, backend)


def _preflight(a, ap, targets, params):
    """Refuse anything that would break the shared scan or bit-identity.
    Returns (each member's prepped planes, the resolved strategy)."""
    if params.level_retries > 0:
        raise _refuse(
            "level_retries", "a retry rebuilds one member's level; a shared "
            "scan cannot re-run one lane")
    if params.data_shards > 1:
        raise _refuse("sharded", "data_shards composes with the mesh "
                      "wavefront, not the lane axis")
    if params.db_shards > 1:
        raise _refuse("sharded", "a sharded level holds 1-row placeholders "
                      "for the DB the lanes read; run the members one by "
                      "one on the mesh")
    if params.backend != "cuda":
        raise _refuse("cpu_backend", "the host oracle's raster scan has no "
                      "lane axis")
    strategy = "wavefront" if params.strategy == "auto" else params.strategy
    if strategy not in ("wavefront", "batched"):
        raise _refuse(
            "unsupported", f"strategy {strategy!r} has no lane scan")
    if (params.checkpoint_dir or params.save_levels_dir
            or params.profile_dir or params.resume_from_level is not None):
        raise _refuse(
            "unsupported", "checkpoint/save-levels/profile runs need the "
            "sequential driver")
    try:
        preps = [_prep_planes(a, ap, b, params) for b in targets]
    except ValueError as e:
        raise _refuse("shape_mismatch", str(e)) from e
    # remap_luminance ties the A/A' planes to each member's B statistics
    # (Hertzmann §3.4): lanes share lane 0's DB, so every member must have
    # prepped the same A planes, bit for bit, whatever the cause
    a0_src, a0_filt = preps[0][0], preps[0][2]
    for p in preps[1:]:
        if not (np.array_equal(a0_src, p[0])
                and np.array_equal(a0_filt, p[2])):
            raise _refuse(
                "remap_divergence", "the members' luminance statistics remap "
                "the A/A' DB differently; batch with remap_luminance=False "
                "or targets of identical statistics")
    return preps, strategy


def _check_level_shapes(b_pyrs, strategy, params, levels) -> float:
    """Per-level shape compatibility across members; returns the finest
    level's largest pad-waste fraction (0.0 unbucketed)."""
    bucketed = (strategy == "batched"
                and tune_buckets.buckets_enabled(params))
    waste = 0.0
    for level in range(levels):
        shapes = [p[level].shape[:2] for p in b_pyrs]
        if not bucketed:
            if any(sh != shapes[0] for sh in shapes[1:]):
                raise _refuse(
                    "shape_mismatch",
                    f"level {level} B shapes {shapes} must be identical for "
                    "the " + ("wavefront" if strategy == "wavefront"
                              else "unbucketed") + " lane scan")
            continue
        if any(sh[1] != shapes[0][1] for sh in shapes[1:]):
            # lanes share a scan row's columns: bucketing pads rows only
            raise _refuse(
                "shape_mismatch",
                f"level {level} B widths {[sh[1] for sh in shapes]} must be "
                "identical")
        bks = [tune_buckets.bucket_rows(h * w) for h, w in shapes]
        if any(bk != bks[0] for bk in bks[1:]):
            raise _refuse(
                "mixed_bucket", f"level {level} query buckets {bks} diverge")
        if level == 0:
            # the finest level dominates the dead rows' work: level sizes
            # shrink geometrically
            waste = max(tune_buckets.pad_waste_frac(h * w, bks[0])
                        for h, w in shapes)
    return waste


def _finalize_lane(bp, s, stats, params, ap_rgb, b_yiq) -> AnalogyResult:
    """A member's tail of the driver: one fetch of its finest plane with
    its levels' deferred counts, then the colour reconstruction exactly as
    ``models.analogy.create_image_analogy`` does it."""
    bp_y = _fetch_finest(bp, stats, params)
    s_raw = _host(s, np.int32) if params.color_mode == "source_rgb" else s
    return AnalogyResult(bp=_color_output(bp_y, s_raw, params, ap_rgb,
                                          b_yiq),
                         bp_y=bp_y, source_map_raw=s_raw, stats=stats,
                         timing={})


def _run_batch(a, ap, targets, params, backend) -> List[Any]:
    preps, strategy = _preflight(a, ap, targets, params)
    if not hasattr(backend, "synthesize_level_lanes"):
        raise _refuse(
            "unsupported", f"backend {type(backend).__name__} has no lane "
            "scan")
    k = len(targets)
    # A-side planes are bitwise-equal across members (preflighted), so
    # member 0's pyramids serve every lane; query pyramids are per lane
    a_src, _, a_filt, ap_rgb, _ = preps[0]
    levels_per = [num_feasible_levels(
        (min(a_src.shape[0], p[1].shape[0]),
         min(a_src.shape[1], p[1].shape[1])), params.levels,
        params.patch_size) for p in preps]
    if any(lv != levels_per[0] for lv in levels_per[1:]):
        raise _refuse(
            "shape_mismatch", f"members disagree on feasible levels "
            f"{levels_per}")
    levels = levels_per[0]
    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    b_pyrs = [build_pyramid_np(p[1], levels) for p in preps]
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]

    waste = _check_level_shapes(b_pyrs, strategy, params, levels)
    h0, w0 = b_pyrs[0][0].shape[:2]
    ceiling = tune_resolve.batch_pad_waste_pct(
        strategy=strategy, n_rows=h0 * w0) / 100.0
    if waste > ceiling:
        raise _refuse(
            "pad_waste", f"finest-level pad waste {waste:.0%} exceeds the "
            f"ceiling {ceiling:.0%} (IA_BATCH_PAD_WASTE)")
    obs_metrics.inc("batch.launches")
    obs_metrics.inc("batch.lanes", k)
    obs_metrics.set_gauge("batch.pad_waste_frac", waste)

    failed: List[Optional[Exception]] = [None] * k
    bp_pyr: List[List[Any]] = [[None] * levels for _ in range(k)]
    s_pyr: List[List[Any]] = [[None] * levels for _ in range(k)]
    stats: List[List[Dict[str, Any]]] = [[] for _ in range(k)]

    for level in range(levels - 1, -1, -1):  # coarsest -> finest
        t0 = time.perf_counter()
        coarse = level + 1 < levels
        spec = spec_for_level(params, level, levels, src_channels)
        jobs: List[Optional[LevelJob]] = [None] * k
        dbs: List[Any] = [None] * k
        for i in range(k):
            if failed[i] is not None:
                continue
            job = LevelJob(
                level=level,
                spec=spec,
                kappa_mult=params.kappa_factor(level) ** 2,
                a_src=a_src_pyr[level],
                a_filt=a_filt_pyr[level],
                b_src=b_pyrs[i][level],
                a_src_coarse=a_src_pyr[level + 1] if coarse else None,
                a_filt_coarse=a_filt_pyr[level + 1] if coarse else None,
                b_src_coarse=b_pyrs[i][level + 1] if coarse else None,
                b_filt_coarse=bp_pyr[i][level + 1] if coarse else None,
            )
            try:
                # the per-lane fault boundary: the chaos site and one
                # lane's host-side build can fail without taking the
                # shared scan down
                chaos.site("engine.batch", lane=i, level=level)
                dbs[i] = backend.build_features(job)
                jobs[i] = job
            except Exception as e:  # noqa: BLE001 - isolated per lane
                failed[i] = e
                obs_metrics.inc("batch.lane_faults")
        live = [i for i in range(k) if failed[i] is None]
        if not live:
            break
        # a failed lane's slot runs a live lane's query side: k stays
        # fixed, and that lane's results are never read
        ref = live[0]
        run_dbs = [dbs[i] if dbs[i] is not None else dbs[ref]
                   for i in range(k)]
        run_jobs = [jobs[i] if jobs[i] is not None else jobs[ref]
                    for i in range(k)]
        try:
            outs = backend.synthesize_level_lanes(run_dbs, run_jobs)
        except Exception as e:  # noqa: BLE001 - the scan failed every lane
            for i in live:
                failed[i] = e
            break
        del dbs, run_dbs  # the next level's builds need no level DB
        total_ms = (time.perf_counter() - t0) * 1e3  # the builds and scan
        for i in live:
            bp_pyr[i][level], s_pyr[i][level], st = outs[i]
            st["total_ms"] = total_ms
            stats[i].append(st)
        # the per-level memory watermark (hbm.peak_bytes.d<N>), as the
        # single-image driver and the JAX engine record it
        obs_device.record_memory(level, params.log_path)

    results: List[Any] = [None] * k
    for i in range(k):
        if failed[i] is not None:
            results[i] = failed[i]
            continue
        results[i] = _finalize_lane(bp_pyr[i][0], s_pyr[i][0], stats[i],
                                    params, ap_rgb, preps[i][4])
        results[i].timing["lanes"] = float(k)
    return results
