"""Configuration of the PyTorch/CUDA port (counterpart of
``image_analogies_tpu/config.py``).

Only the fields the ported paths read are here.  Field names, defaults and
validation mirror the JAX package so a params object reads the same in
both; the device is explicit (``device``, "cuda" by default — the port
runs on the card unless the caller asks for the CPU), and the backend seam
picks the matcher (``backend``: the device's, or the host oracle).  Every
strategy and every match mode of the JAX package is ported, and so are the
driver's surroundings (``models/analogy.py``): ``level_retries``,
``dispatch_timeout_s``, ``level_sync``, ``checkpoint_dir``,
``resume_from_level``, ``profile_dir``, ``log_path``, ``save_levels_dir``,
``devcache_max_bytes``, ``pipeline`` and ``donate_buffers``, with the JAX
defaults and validation, and ``pipeline_active()``; and the run's own
observability and tuning: ``metrics``, ``compile_cache_dir`` and
``shape_buckets``; and the exemplar catalog and the two-stage ANN matcher:
``catalog_dir``, ``catalog_host_bytes`` and ``ann_prefilter``; and the
mesh: ``db_shards`` and ``data_shards`` (``parallel/``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

# the JAX package's strategies ("auto" resolves to "wavefront")
STRATEGIES = ("auto", "wavefront", "exact", "rowwise", "batched")
# the production match modes: every one is parity-grade (its picks hold the
# oracle tie-audit)
PARITY_MATCH_MODES = ("auto", "exact_hi", "exact_hi2", "exact_hi2_2p")
# non-parity A/B probe modes (bf16-resolution scans): selecting one needs
# IA_EXPERIMENTAL=1 in the environment
EXPERIMENTAL_MATCH_MODES = ("scan_rescue", "scan_rescue_1p",
                            "two_pass", "two_pass_1p")


def env_truthy(name: str) -> bool:
    """Fail-closed boolean env gate: only explicit truthy spellings count,
    so typos, falsey values and an unset variable never open a gate (the
    JAX package's ``config.env_truthy`` with its one default)."""
    raw = os.environ.get(name)
    return raw is not None and raw.strip().lower() in ("1", "true", "yes",
                                                      "on")


def experimental_enabled() -> bool:
    """True when IA_EXPERIMENTAL opts into the non-parity probe modes."""
    return env_truthy("IA_EXPERIMENTAL")


@dataclass(frozen=True)
class AnalogyParams:
    """Knobs of the synthesis engine (Hertzmann et al. 2001); see the JAX
    package's ``AnalogyParams`` for the full semantics of each field.

    - ``kappa``: coherence wins iff ``d_coh <= d_app * kappa_factor(l)**2``.
    - ``strategy``: "auto" resolves to "wavefront" (anti-diagonal parity
      scan, ``backends/cuda.py``); "exact" (per-pixel sequential scan,
      full-DB fp32 scores), "rowwise" (one approximate match per scan row,
      then the per-pixel pass) and "batched" (a whole scan row per step
      over the rows-above metric, then ``refine_passes`` left-propagation
      passes).  On the card the approximate match of rowwise and batched
      is one bf16 pass with fp32 accumulation; on the CPU it is exact fp32.
    - ``refine_passes``: batched strategy's vectorized left-propagation
      refinement passes per scan row.
    - ``match_mode``: the wavefront anchor scan — "exact_hi" (fp32 argmin
      kernel), "exact_hi2" (three-pass packed scan, the full bf16_6x
      product set), "exact_hi2_2p" (bf16 lane-packed K-wide scan), or
      "auto" (per level: exact_hi2_2p at or above
      ``backends.cuda.PACKED_CROSSOVER_ROWS`` A rows, exact_hi below).
      Behind IA_EXPERIMENTAL=1: "scan_rescue" (bf16 per-tile champions +
      top-8 fp32 rescue), "two_pass" (bf16 top-2 + fp32 re-score) and
      their single-pass "_1p" variants.
    - ``bf16_scoring``: opt-in bf16 candidate scoring for the wavefront
      anchor (the scan_rescue machinery), gated by a parity probe on first
      use per device (``backends/gate.py``): a verdict that is not fully
      tie-explained keeps the exact scan.
    - ``temporal_weight``: the weight of the video term, the previous
      output frame's windows matched against A' windows
      (``models/video.py``); it acts only where a previous frame is given
      (``create_image_analogy(..., temporal_prev=...)``), so single-image
      synthesis ignores it.
    - ``device``: where tensors live.  "cuda" (default) requires a card and
      never drops to the CPU; "cpu" runs every kernel's plain version.
    - ``backend``: the matcher.  "cuda" (default) is ``CudaMatcher`` on
      ``device``; "cpu" is the host oracle (``backends/cpu.py``: NumPy and
      the cKDTree, the JAX package's ``backend="cpu"``), which ignores
      ``device``, ``strategy`` and ``match_mode``.
    - ``use_ann``: the CPU oracle's approximate match through a cKDTree
      (True, default), or brute force (``backends/native_match.py``).
    - ``shape_buckets``: on the wavefront and batched strategies each
      level's scan copies of the DB pad their rows, with rows that cannot
      win, up to ``tune.buckets.bucket_rows(ha*wa)`` (the JAX package's DB
      side); the batched strategy also pads each level's query rows
      (``static_q`` and the gather maps) with zero rows up to
      ``bucket_rows(hb*wb)``, in a singleton run and in the lane engine
      (``batch/engine.py``), where targets of one width and different
      heights in one bucket then share a lane run; results are cropped to
      the real shape.  Env ``IA_SHAPE_BUCKETS`` overrides either way.
      False (default) changes nothing, bit for bit.
    - ``metrics``: run the synthesis inside an observed run
      (``obs/trace.py run_scope``): a per-run metrics registry (launch,
      compile, memory, pipeline, fetch and kappa counters), span records
      and a manifest; with ``log_path`` the records and the ``run_end``
      snapshot go to the log.  Off by default, and one bool read per
      hook when off.
    - ``compile_cache_dir``: the directory of the kernel libraries that
      ``nvcc`` builds (``ops/_build.py``): a later process finds them
      there (``ia warmup``).  None: ``image_analogies_tpu_torch/_build/``;
      env ``IA_COMPILE_CACHE_DIR`` overrides either way.
    - ``ann_prefilter``: opt-in two-stage matcher for the wavefront anchor
      and the batched approximate match (``ops/ann.py``): a PCA-projected
      prefilter ranks every DB row and the exact fp32 distance re-scores
      the top ``ann_top_m`` (``tune/resolve.py``).  Gated by a parity
      probe on first use per (device, strategy) (``backends/gate.py``);
      a refused or unsupported request runs the exact matcher.
    - ``catalog_dir``: the exemplar catalog's root (``catalog/``); on the
      card it serves the sealed ANN bases (``_ann/``) built by ``ia
      catalog build``.  Env ``IA_CATALOG_DIR`` overrides.
    - ``catalog_host_bytes``: the catalog's host-RAM tier budget (None:
      256 MiB; env ``IA_CATALOG_HOST_BYTES`` overrides).
    - ``db_shards``: shard the A/A' patch DB over this many ranks of a
      running world (``parallel/``), on the wavefront and batched
      strategies; each rank runs the whole scan against its shard and
      every rank gets the same result.
    - ``data_shards``: video (two_phase): shard the frames over this many
      ranks; one image on the wavefront: split each anti-diagonal's
      queries over them (query-parallel).  The world must hold exactly
      ``db_shards * data_shards`` ranks.  A sharded run refuses
      ``level_retries`` and ``dispatch_timeout_s``: each rank is a
      process of its own, and a rank that retried or timed out alone
      would leave its peers waiting in the step's collectives.

    The driver's surroundings (``models/analogy.py``, ``utils/``):

    - ``level_retries``: retry a level this many times on a transient
      fault (``utils/failure.py`` says which CUDA faults are transient);
      pair with ``checkpoint_dir`` so a restart loses at most one level.
    - ``dispatch_timeout_s``: > 0 runs each level's dispatch under a
      watchdog that raises the transient ``WatchdogTimeout`` past this
      many seconds; 0 dispatches inline.
    - ``level_sync``: True (default) waits for each level's device work,
      so per-level ``ms`` / ``pixels_per_s`` are device times; False
      only enqueues (per-level ``enqueue_ms``), one wait at the final
      fetch.  ``level_retries > 0`` forces the wait.
    - ``checkpoint_dir`` / ``resume_from_level``: save each level as a
      sealed npz (``utils/checkpoint.py``); resume every level coarser
      than ``resume_from_level`` from disk.
    - ``profile_dir``: a ``torch.profiler`` trace of the run there.
    - ``log_path``: one JSONL record per level (``utils/logging.py``).
    - ``save_levels_dir``: each level's B' as ``level_XX.png``.
    - ``devcache_max_bytes``: the upload cache's byte budget
      (``utils/devcache.py``; None: 1 GiB; env IA_DEVCACHE_BYTES wins).
    - ``pipeline``: prefetch the next level's inputs on a helper thread
      and a side stream while the level in flight is issued; None (auto)
      is on when ``level_sync`` is False; ``level_retries > 0`` forces it
      off.
    - ``donate_buffers``: drop each coarser level's plane and source map
      once the next level has consumed them; None (auto) is on on the
      card; retries, ``keep_levels``, checkpoints and saved levels force
      it off.
    """

    levels: int = 3
    patch_size: int = 5
    coarse_patch_size: int = 3
    kappa: float = 5.0
    gaussian_weights: bool = True
    remap_luminance: bool = True
    src_weight: float = 1.0
    color_mode: str = "yiq_transfer"  # "yiq_transfer" | "source_rgb"
    strategy: str = "auto"
    refine_passes: int = 3
    match_mode: str = "auto"
    temporal_weight: float = 0.0
    bf16_scoring: bool = False
    device: str = "cuda"
    backend: str = "cuda"  # "cuda" (CudaMatcher on device) | "cpu"
    use_ann: bool = True
    shape_buckets: bool = False
    level_retries: int = 0
    dispatch_timeout_s: float = 0.0
    level_sync: bool = True
    checkpoint_dir: Optional[str] = None
    resume_from_level: Optional[int] = None  # finest = 0
    profile_dir: Optional[str] = None
    log_path: Optional[str] = None
    save_levels_dir: Optional[str] = None
    devcache_max_bytes: Optional[int] = None
    pipeline: Optional[bool] = None
    donate_buffers: Optional[bool] = None
    metrics: bool = False
    compile_cache_dir: Optional[str] = None
    catalog_dir: Optional[str] = None
    catalog_host_bytes: Optional[int] = None
    ann_prefilter: bool = False
    db_shards: int = 1
    data_shards: int = 1

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        for name in ("patch_size", "coarse_patch_size"):
            v = getattr(self, name)
            if v < 1 or v % 2 == 0:
                raise ValueError(f"{name} must be odd and >= 1, got {v}")
        if self.kappa < 0:
            raise ValueError(f"kappa must be >= 0, got {self.kappa}")
        if self.color_mode not in ("yiq_transfer", "source_rgb"):
            raise ValueError(f"unknown color_mode {self.color_mode!r}")
        if self.bf16_scoring and self.strategy not in ("wavefront", "auto"):
            raise ValueError(
                "bf16_scoring requires strategy 'wavefront' or 'auto', "
                f"got {self.strategy!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.refine_passes < 0:
            raise ValueError(
                f"refine_passes must be >= 0, got {self.refine_passes}")
        if self.match_mode not in PARITY_MATCH_MODES:
            if self.match_mode not in EXPERIMENTAL_MATCH_MODES:
                raise ValueError(f"unknown match_mode {self.match_mode!r}")
            if not experimental_enabled():
                raise ValueError(
                    f"match_mode {self.match_mode!r} is a non-parity "
                    "experimental A/B probe (its bf16-resolution scan "
                    "drifts from the oracle — see "
                    "experiments/rescue_probe.py); set IA_EXPERIMENTAL=1 "
                    "to enable it, or use one of "
                    f"{PARITY_MATCH_MODES}")
        if self.device not in ("cuda", "cpu") and not \
                self.device.startswith("cuda:"):
            raise ValueError(f"unknown device {self.device!r}")
        if self.backend not in ("cuda", "cpu"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.bf16_scoring and self.backend != "cuda":
            raise ValueError(
                "bf16_scoring applies to the device's wavefront scan; "
                f"backend {self.backend!r} has no bf16 candidate path")
        if self.ann_prefilter and self.backend != "cuda":
            raise ValueError(
                "ann_prefilter is the device matcher's two-stage matcher; "
                f"backend {self.backend!r} has its own ANN toggle "
                "(use_ann)")
        if self.level_retries < 0:
            raise ValueError(
                f"level_retries must be >= 0, got {self.level_retries}")
        if self.db_shards < 1:
            raise ValueError(f"db_shards must be >= 1, got {self.db_shards}")
        if self.data_shards < 1:
            raise ValueError(
                f"data_shards must be >= 1, got {self.data_shards}")
        if (self.db_shards > 1 or self.data_shards > 1) and (
                self.level_retries > 0 or self.dispatch_timeout_s > 0):
            raise ValueError(
                "a sharded run (db_shards or data_shards > 1) takes no "
                "level_retries or dispatch_timeout_s: each rank is its own "
                "process, and a rank that retried or timed out alone would "
                "leave its peers waiting in the step's collectives")
        if self.devcache_max_bytes is not None and self.devcache_max_bytes < 1:
            raise ValueError(
                "devcache_max_bytes must be positive when set, got "
                f"{self.devcache_max_bytes}")
        if (self.catalog_host_bytes is not None
                and self.catalog_host_bytes < 1):
            raise ValueError(
                "catalog_host_bytes must be positive when set, got "
                f"{self.catalog_host_bytes}")
        if self.ann_prefilter and self.strategy not in ("wavefront",
                                                        "batched", "auto"):
            raise ValueError(
                "ann_prefilter requires strategy 'wavefront', 'batched' "
                f"or 'auto', got {self.strategy!r}")

    def pipeline_active(self) -> bool:
        """The resolved pipeline flag: an explicit setting wins, auto is on
        exactly when dispatches are not waited for (``level_sync=False``),
        and retries always force lock-step (a prefetch fault would surface
        outside the retry wrapper)."""
        if self.level_retries > 0:
            return False
        if self.pipeline is not None:
            return self.pipeline
        return not self.level_sync

    def replace(self, **kw) -> "AnalogyParams":
        """A copy with the given fields changed (validated again)."""
        return dataclasses.replace(self, **kw)

    def kappa_factor(self, level: int) -> float:
        """Coherence threshold multiplier at `level` (0 = finest):
        1 + 2^(-level) * kappa, squared by callers (squared distances)."""
        return 1.0 + (2.0 ** (-level)) * self.kappa


# The JAX package's presets (image_analogies_tpu/config.py PRESETS), with
# the backend seam dropped: every preset runs on the card by default.
PRESETS = {
    "texture_by_numbers": AnalogyParams(
        levels=1, patch_size=5, kappa=1.0, remap_luminance=False,
        color_mode="source_rgb",
    ),
    "oil_filter": AnalogyParams(levels=3, patch_size=5, kappa=5.0),
    "super_resolution": AnalogyParams(levels=2, patch_size=7, kappa=0.5),
    "npr_1024": AnalogyParams(levels=5, patch_size=5, kappa=5.0),
    "texture_synthesis": AnalogyParams(
        levels=3, patch_size=5, kappa=2.0, remap_luminance=False,
        src_weight=0.0, color_mode="source_rgb",
    ),
    "video": AnalogyParams(levels=3, patch_size=5, kappa=5.0,
                           temporal_weight=1.0),
}
