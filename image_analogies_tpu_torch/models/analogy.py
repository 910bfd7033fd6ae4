"""The synthesis driver (counterpart of the JAX package's
``models/analogy.py``): coarse-to-fine over pyramid levels on one device,
delegating feature building and the level scan to the matcher
(``CudaMatcher``, or the host oracle ``CpuMatcher`` for
``backend="cpu"``).

B' chains between levels as a device tensor; the host fetches once at the
end (the finest plane together with every level's coherence count and,
for the batched strategy, its refinement count).
With ``temporal_prev`` (video mode, ``models/video.py``) the previous
output frame's pyramid fills the temporal block of the queries and A' at
each level fills it on the DB side; ``remap_anchor`` pins the luminance
remap to another image (a clip's first frame).

Around the level loop, as in the JAX package (``AnalogyParams`` names the
fields): ``AnalogyResult.timing``; the pipeline (the next level's planes
uploaded and its schedule built on a helper thread and a side stream while
the level in flight is issued) and donation (each coarser level's plane
and source map dropped once consumed); per-level checkpoints and resume;
level retries on transient faults, under a watchdog; a JSONL record per
level; each level saved as a PNG; a ``torch.profiler`` trace; the
content-keyed upload cache (``utils/devcache.py``); the runtime wiring of
``tune/warmup.py`` (the library directory, the cache budget); and, as in
the JAX driver, every run inside ``obs.trace.run_scope`` (inert unless
``params.metrics`` or a log path: the manifest, the ``pipeline.*``,
``fetch.bytes`` and ``kappa.*`` counters, per-level memory watermarks,
the kernels' ``launch.*`` counts) and ``tune.resolve.pin_scope`` (each
level's launch geometry resolves once a run).  With ``ann_prefilter`` the
matcher resolves each level's ANN basis through the exemplar catalog's
sealed artifacts (``catalog/``, ``backends/cuda.py``).  With
``backend="cpu"`` the matcher is the host oracle (``backends/cpu.py``),
and, as in the JAX driver, only then does the driver consult the
catalog's feature tiers: each level's A-side goes to the matcher as
``job.a_features`` (``catalog/tiers.py lookup``), and a cold build records
itself back through it.  The chaos site ``level.dispatch`` opens each
level's dispatch inside the body the watchdog runs, so an injected hang is
abandoned on its own stream as a real wedge would be.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.backends import get_backend
from image_analogies_tpu_torch.backends.base import LevelJob, Matcher
from image_analogies_tpu_torch.catalog import tiers as catalog_tiers
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import device as obs_device
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.ops import color
from image_analogies_tpu_torch.ops.features import spec_for_level
from image_analogies_tpu_torch.ops.pyramid import (
    build_pyramid_np,
    num_feasible_levels,
)
from image_analogies_tpu_torch.parallel import distributed
from image_analogies_tpu_torch.tune import resolve as tune_resolve
from image_analogies_tpu_torch.tune import warmup as tune_warmup
from image_analogies_tpu_torch.utils import checkpoint as ckpt
from image_analogies_tpu_torch.utils import failure
from image_analogies_tpu_torch.utils import logging as ialog
from image_analogies_tpu_torch.utils.imageio import save_image


@dataclass
class AnalogyResult:
    bp: np.ndarray  # (H,W,3) or (H,W) final B'
    bp_y: np.ndarray  # (H,W) synthesized filtered plane (luminance)
    # (H,W) int32 flat indices into A (finest level); a device tensor until
    # first read through `source_map`
    source_map_raw: Any = None
    stats: List[Dict[str, Any]] = field(default_factory=list)
    # with keep_levels=True: every level's (bp, s) as NumPy, finest first —
    # the layout the tie-audit (utils/parity.py) reads
    levels: Optional[List] = None
    # the run's wall-clock accounting (ms), filled by the driver:
    # host_gap_ms — host time between successive level dispatches;
    # with the pipeline, prep_ms / wait_ms / host_hidden_ms — the prefetch
    # thread's time, the time the driver blocked joining it, and their
    # difference (host work hidden), prepped_levels and prefetch_errors
    # (prefetches that raised: swallowed, the dispatch redoes their work);
    # with donation, donated_levels
    timing: Dict[str, float] = field(default_factory=dict)

    @property
    def source_map(self) -> np.ndarray:
        sm = self.source_map_raw
        if not isinstance(sm, np.ndarray):
            sm = sm.cpu().numpy().astype(np.int32)
            self.source_map_raw = sm
        return sm


def resolve_device(device) -> torch.device:
    """The run's device.  A CUDA device without a card raises: the port
    never drops to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "create_image_analogy runs on the card by default and CUDA is "
            "not available here; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _prep_planes(a, ap, b, params, remap_anchor=None):
    """Build the src/filt planes per color mode.

    Returns (a_src, b_src, a_filt, ap_rgb, b_yiq): the matching planes
    ((H,W) or (H,W,C)), A' luminance (possibly remapped), A' as float RGB
    (for source_rgb) and B in YIQ (None when B is grayscale).

    ``remap_anchor``: an image whose luminance stats drive the Hertzmann
    §3.4 remap instead of B's (video anchors every frame of a clip on its
    first frame, so the A mapping stays the same across frames)."""
    a = color.as_float(np.asarray(a))
    ap = color.as_float(np.asarray(ap))
    b = color.as_float(np.asarray(b))
    if a.shape[:2] != ap.shape[:2]:
        raise ValueError(f"A {a.shape} and A' {ap.shape} must share H,W")

    a_filt = color.luminance(ap)
    b_yiq = color.rgb2yiq(b) if (b.ndim == 3 and b.shape[-1] == 3) else None

    def remap_target(b_src):
        if remap_anchor is None:
            return b_src
        return color.luminance(color.as_float(np.asarray(remap_anchor)))

    if params.color_mode == "yiq_transfer":
        a_src = color.luminance(a)
        b_src = b_yiq[..., 0] if b_yiq is not None else color.luminance(b)
        if params.remap_luminance:
            # ONE affine transform (A's stats -> B's) on both A and A'
            a_src, a_filt = color.remap_pair(a_src, a_filt,
                                             remap_target(b_src))
    else:  # source_rgb: keep label/source channels as-is
        a_src = a
        b_src = b
        a_nc = 1 if a_src.ndim == 2 else a_src.shape[-1]
        b_nc = 1 if b_src.ndim == 2 else b_src.shape[-1]
        if a_nc != b_nc:
            raise ValueError(
                f"A ({a_nc}ch) and B ({b_nc}ch) must have matching channels")
        if params.remap_luminance and a_src.ndim == 2:
            a_src, a_filt = color.remap_pair(a_src, a_filt,
                                             remap_target(b_src))
    return a_src, b_src, a_filt, ap, b_yiq


def _finalize_stats(st: Dict[str, Any]) -> Dict[str, Any]:
    """Turn the fetched coherence (and refinement) counts into the
    documented coherence_ratio (and refined_ratio)."""
    if "_n_coh" in st:
        n = max(st.get("pixels", 1), 1)
        st["coherence_ratio"] = float(st.pop("_n_coh")) / n
        if "_n_ref" in st:
            st["refined_ratio"] = float(st.pop("_n_ref")) / n
    return st


def _host(x, dtype) -> np.ndarray:
    """A host copy of a level plane: a device tensor, or a NumPy array
    (a level resumed from disk, or chained through host copies while
    retries are armed)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(dtype)
    return np.asarray(x, dtype)


def _fetch_finest(bp, stats: List[Dict[str, Any]], params) -> np.ndarray:
    """ONE host fetch for the finest B' plane ``bp`` (a device tensor, or a
    NumPy plane resumed from disk) and every level's deferred device counts
    (counts <= 2^24 are exact in fp32); then each level's stats are
    finalized and logged (unless the level loop logged it already).
    Returns B' as (hb, wb) float32."""
    hb, wb = bp.shape[:2]
    deferred = [(st, k) for st in stats for k in ("_n_coh", "_n_ref")
                if k in st]
    counts = ([torch.stack([st[k].reshape(()) for st, k in deferred]).to(
        torch.float32)] if deferred else [])
    if isinstance(bp, torch.Tensor):
        fetched = torch.cat([bp.reshape(-1)] + [
            c.to(bp.device) for c in counts]).cpu().numpy()
        bp_y = fetched[:hb * wb].reshape(hb, wb).astype(np.float32)
        fetched = fetched[hb * wb:]
    else:
        bp_y = _host(bp, np.float32)
        fetched = counts[0].cpu().numpy() if counts else []
    if deferred:
        obs_metrics.inc("fetch.bytes", 4 * len(deferred) + int(bp_y.nbytes))
    for (st, k), c in zip(deferred, fetched):
        st[k] = float(c)
    for st in stats:
        _finalize_stats(st)
        if not st.pop("_emitted", False):
            ialog.emit(st, params.log_path)
    if obs_metrics._ACTIVE:
        # coherence-vs-approximate pick totals, weighted by pixel count
        for st in stats:
            cr, px = st.get("coherence_ratio"), st.get("pixels", 0)
            if cr is not None and px:
                obs_metrics.inc("kappa.coherence_px", cr * px)
                obs_metrics.inc("kappa.total_px", px)
    return bp_y


def _color_output(bp_y: np.ndarray, s_raw, params, ap_rgb: np.ndarray,
                  b_yiq: Optional[np.ndarray]) -> np.ndarray:
    """The final B' from the synthesized plane: A' colors gathered through
    the source map (``source_rgb``; ``s_raw`` on the host), B's I/Q
    channels around the plane (an RGB B), or the plane clipped to [0, 1]."""
    if params.color_mode == "source_rgb":
        ap_flat = ap_rgb.reshape(-1, ap_rgb.shape[-1]) if ap_rgb.ndim == 3 \
            else ap_rgb.reshape(-1)
        return ap_flat[s_raw.reshape(-1)].reshape(
            bp_y.shape + (() if ap_rgb.ndim == 2 else (ap_rgb.shape[-1],)))
    if b_yiq is not None:
        return color.yiq2rgb(
            np.stack([bp_y, b_yiq[..., 1], b_yiq[..., 2]], axis=-1))
    return np.clip(bp_y, 0.0, 1.0)


def create_image_analogy(
    a: np.ndarray,
    ap: np.ndarray,
    b: np.ndarray,
    params: AnalogyParams = AnalogyParams(),
    device=None,
    keep_levels: bool = False,
    backend: Optional[Matcher] = None,
    temporal_prev: Optional[np.ndarray] = None,
    remap_anchor: Optional[np.ndarray] = None,
) -> AnalogyResult:
    """Synthesize B' such that A : A' :: B : B' (Hertzmann §3).

    ``device`` None means ``params.device`` ("cuda" by default), which
    raises when no card is present; pass ``device="cpu"`` to run on the
    CPU.  ``keep_levels`` returns every level's (bp, s) for the tie-audit.
    ``backend`` replaces the matcher (as the JAX package's argument of the
    same name; ``device`` is then the matcher's); None is the one
    ``params.backend`` names (``backends.get_backend``).

    ``temporal_prev`` is the previous output frame's synthesized luminance
    (B'_{t-1}, B's shape) for video mode: with ``params.temporal_weight >
    0`` its windows join the feature vector and are matched against A'
    windows on the DB side.  ``remap_anchor`` pins the luminance remap to
    another image's stats (``_prep_planes``).

    With ``params.db_shards`` > 1 the patch DB shards over the ranks of a
    running world (``parallel/``: ``torchrun``, the CLI's
    ``--coordinator``, or ``parallel.launch.spawn_local``), and with
    ``data_shards`` > 1 each anti-diagonal's queries split over the data
    axis (the wavefront only).  Every rank calls this function alike and
    gets the same result; rank 0 alone writes the run's files (log,
    checkpoints, saved levels, profile), and every rank reads a resume.
    """
    if params.data_shards > 1 and params.strategy not in ("wavefront",
                                                          "auto"):
        raise ValueError(
            "data_shards > 1 on a single image is the query-parallel "
            "wavefront (anti-diagonals split over the mesh 'data' axis) "
            "and exists only for strategy='wavefront'/'auto'; for video "
            "frame sharding use models.video.video_analogy")
    if not distributed.is_writer():
        params = params.replace(log_path=None, save_levels_dir=None,
                                profile_dir=None)
    if backend is None:
        backend = get_backend(params, device)
    tune_warmup.apply_runtime_config(params)
    dev = getattr(backend, "device", None)
    # the obs run scope (inert unless params.metrics or a log path; joins an
    # enclosing run: a video clip's, the engine's) with the tune store in
    # its manifest, and the level configs pinned for the run
    with obs_trace.run_scope(params, manifest_extra=dict(
            tune_resolve.manifest_info(), device=str(dev))):
        with tune_resolve.pin_scope():
            return _create_image_analogy(
                a, ap, b, params, backend, dev, keep_levels, temporal_prev,
                remap_anchor)


def _create_image_analogy(a, ap, b, params, backend, dev, keep_levels,
                          temporal_prev, remap_anchor) -> AnalogyResult:
    on_card = dev is not None and torch.device(dev).type == "cuda"
    # the exemplar catalog's feature tiers, for the host oracle only (the
    # device matcher's A-side is built on the card, its warmth the upload
    # cache): the style key is the raw exemplar's sha1, once a run
    catalog_style = None
    if params.backend == "cpu" and catalog_tiers.active():
        catalog_style = catalog_tiers.style_key(a, ap)
    a_src, b_src, a_filt, ap_rgb, b_yiq = _prep_planes(
        a, ap, b, params, remap_anchor=remap_anchor)

    min_shape = (min(a_src.shape[0], b_src.shape[0]),
                 min(a_src.shape[1], b_src.shape[1]))
    levels = num_feasible_levels(min_shape, params.levels, params.patch_size)
    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    b_src_pyr = build_pyramid_np(b_src, levels)
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]
    temporal = params.temporal_weight > 0 and temporal_prev is not None
    # the DB side's temporal plane is A' (the remapped plane the features
    # use); the query side's is the previous output frame's pyramid
    b_temporal_pyr = (build_pyramid_np(
        np.asarray(temporal_prev, np.float32), levels) if temporal else None)
    digest = ckpt.run_digest(params, a_src.shape[:2], b_src.shape[:2])

    # Donation drops each level's chained plane once the next level has
    # consumed it, but only where nothing else reads it: retries rebuild
    # from it, and keep_levels, checkpoints and saved levels read it, so
    # each of them wins over donate_buffers=True.  Auto: on the card.
    donate = False
    if (params.level_retries == 0 and not keep_levels
            and not params.checkpoint_dir and not params.save_levels_dir):
        donate = (params.donate_buffers if params.donate_buffers is not None
                  else on_card)
    pipeline_on = params.pipeline_active()
    timing: Dict[str, float] = {"host_gap_ms": 0.0}
    if pipeline_on:
        timing.update(prep_ms=0.0, wait_ms=0.0, host_hidden_ms=0.0,
                      prepped_levels=0.0, prefetch_errors=0.0)
    if donate:
        timing["donated_levels"] = 0.0

    def make_job(level: int, b_filt_coarse=None) -> LevelJob:
        coarse = level + 1 < levels
        return LevelJob(
            level=level,
            spec=spec_for_level(params, level, levels, src_channels,
                                temporal=temporal),
            kappa_mult=params.kappa_factor(level) ** 2,
            a_src=a_src_pyr[level],
            a_filt=a_filt_pyr[level],
            b_src=b_src_pyr[level],
            a_src_coarse=a_src_pyr[level + 1] if coarse else None,
            a_filt_coarse=a_filt_pyr[level + 1] if coarse else None,
            b_src_coarse=b_src_pyr[level + 1] if coarse else None,
            b_filt_coarse=b_filt_coarse,
            a_temporal=a_filt_pyr[level] if temporal else None,
            b_temporal=b_temporal_pyr[level] if temporal else None,
            donate=donate,
        )

    def prefetch(job: LevelJob):
        # cache warming only: a failure is logged, counted and swallowed —
        # the dispatch redoes the work on a cold cache, changing timing,
        # never results
        t0 = time.perf_counter()
        failed = False
        try:
            backend.prefetch_level(job)
        except Exception:  # noqa: BLE001 - a boundary that must go on
            ialog.logger.exception("prefetch of level %d failed", job.level)
            obs_metrics.inc("pipeline.prefetch_errors")
            failed = True
        return (time.perf_counter() - t0) * 1e3, failed

    if params.dispatch_timeout_s > 0 or params.metrics:
        # load every library the levels route to now: a first-use nvcc
        # build (tens of seconds) must not run under a dispatch deadline,
        # and an observed run counts its builds before its first level
        # (``ia warmup``)
        backend.load_kernels([make_job(lv) for lv in range(levels)])

    prof = contextlib.nullcontext()
    if params.profile_dir:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        prof = profile(
            activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else []),
            on_trace_ready=tensorboard_trace_handler(params.profile_dir))

    bp_pyr: List[Any] = [None] * levels
    s_pyr: List[Any] = [None] * levels
    stats: List[Dict[str, Any]] = []
    pool = None
    pending = None  # the prefetch in flight
    gap_t0 = None  # perf_counter when the previous dispatch returned
    try:
        with prof:
            for level in range(levels - 1, -1, -1):  # coarsest -> finest
                if pending is not None:
                    # join the helper BEFORE this level touches the caches
                    # it warmed
                    twait = time.perf_counter()
                    with obs_trace.span("pipeline.wait", level=level):
                        prep_ms, failed = pending.result()
                    wait_ms = (time.perf_counter() - twait) * 1e3
                    pending = None
                    timing["prep_ms"] += prep_ms
                    timing["wait_ms"] += wait_ms
                    timing["host_hidden_ms"] += max(prep_ms - wait_ms, 0.0)
                    timing["prepped_levels"] += 1.0
                    timing["prefetch_errors"] += float(failed)
                if (params.checkpoint_dir
                        and params.resume_from_level is not None
                        and level > params.resume_from_level):
                    loaded = ckpt.load_level(params.checkpoint_dir, level,
                                             digest=digest,
                                             log_path=params.log_path)
                    if loaded is not None:
                        bp_pyr[level], s_pyr[level] = loaded
                        ialog.emit({"event": "resume_level", "level": level},
                                   params.log_path)
                        continue
                coarse = level + 1 < levels
                job = make_job(level, bp_pyr[level + 1] if coarse else None)
                if catalog_style is not None:
                    # tier by tier (resident, host, disk); a full miss
                    # leaves entry None, and the matcher builds cold and
                    # records back through the ref
                    job.a_features = catalog_tiers.lookup(catalog_style, job)
                if pipeline_on and level > 0:
                    # the port's host issues a level's launches for the
                    # whole of its scan, so the next level's prefetch runs
                    # beside that from the start (the JAX driver starts it
                    # after a dispatch that returns at once)
                    if pool is None:
                        pool = ThreadPoolExecutor(
                            max_workers=1, thread_name_prefix="ia-prefetch")
                    pending = pool.submit(prefetch, make_job(level - 1))
                t0 = time.perf_counter()
                if gap_t0 is not None:
                    timing["host_gap_ms"] += (t0 - gap_t0) * 1e3

                def level_body():
                    chaos.site("level.dispatch", level=level)
                    return backend.synthesize_level(
                        backend.build_features(job), job)

                def dispatch():
                    # the watchdog wraps the whole dispatch INSIDE the retry
                    # body: a wedged level raises WatchdogTimeout
                    # (transient) and is retried, on a stream of its own
                    return failure.run_with_watchdog(
                        level_body, params.dispatch_timeout_s,
                        context={"level": level},
                        log_path=params.log_path, device=dev)

                with obs_trace.span("level", level=level):
                    bp, s, st = failure.run_with_retry(
                        dispatch, retries=params.level_retries,
                        context={"level": level}, log_path=params.log_path)
                gap_t0 = time.perf_counter()
                st["total_ms"] = (gap_t0 - t0) * 1e3
                if donate and coarse:
                    bp_pyr[level + 1] = s_pyr[level + 1] = None
                    timing["donated_levels"] += 1.0
                    obs_metrics.inc("pipeline.donated_levels")
                if params.level_retries > 0:
                    # a retried level rebuilds from planes that survive a
                    # device reset: with retries armed, levels chain
                    # through host copies
                    bp, s = _host(bp, np.float32), _host(s, np.int32)
                bp_pyr[level], s_pyr[level] = bp, s
                if params.log_path:
                    # a log pays for the count's fetch now
                    ialog.emit(_finalize_stats(st), params.log_path)
                    st["_emitted"] = True
                stats.append(st)
                if params.checkpoint_dir and distributed.is_writer():
                    ckpt.save_level(params.checkpoint_dir, level,
                                    _host(bp, np.float32),
                                    _host(s, np.int32), digest=digest)
                if params.save_levels_dir:
                    save_image(os.path.join(params.save_levels_dir,
                                            f"level_{level:02d}.png"),
                               _host(bp, np.float32))
                # per-level memory watermark (hbm.peak_bytes.d<N>): one
                # bool read with metrics off, silent on the CPU
                obs_device.record_memory(level, params.log_path)
            if params.profile_dir and on_card:
                torch.cuda.synchronize(dev)  # the trace holds every kernel
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    # the pipeline accounting, as the JAX driver's gauges and counters
    obs_metrics.set_gauge("pipeline.host_gap_ms", timing["host_gap_ms"])
    if pipeline_on:
        for k in ("prep_ms", "wait_ms", "host_hidden_ms"):
            obs_metrics.set_gauge(f"pipeline.{k}", timing[k])
        obs_metrics.inc("pipeline.levels_prepped",
                        int(timing["prepped_levels"]))
    with obs_trace.span("fetch"):
        bp_y = _fetch_finest(bp_pyr[0], stats, params)
    obs_device.record_memory(None, params.log_path)  # the fetch's too
    need_s_host = params.color_mode == "source_rgb" or keep_levels
    s_raw = _host(s_pyr[0], np.int32) if need_s_host else s_pyr[0]
    out = _color_output(bp_y, s_raw, params, ap_rgb, b_yiq)
    levels_np = None
    if keep_levels:
        levels_np = [(bp_y, s_raw)] + [
            (_host(bp_pyr[lv], np.float32), _host(s_pyr[lv], np.int32))
            for lv in range(1, levels)]
    return AnalogyResult(bp=out, bp_y=bp_y, source_map_raw=s_raw,
                         stats=stats, levels=levels_np, timing=timing)
