"""The backend boundary (counterpart of the JAX package's
``backends/base.py``).

Only feature building and the within-level scan cross it; the
coarse-to-fine level loop stays in Python (``models/analogy.py``).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch.ops.features import FeatureSpec


@dataclass
class LevelJob:
    """Everything a backend needs to synthesize one pyramid level.

    Planes are host NumPy float32 except ``b_filt_coarse``, the coarser
    level's synthesized B', which the level loop chains as a device tensor.
    ``level`` counts from the finest (0); ``*_coarse`` planes are None at
    the coarsest level.  Video mode adds the temporal planes at this
    level: ``a_temporal`` (the DB side, A') and ``b_temporal`` (the query
    side, the previous output frame's pyramid), both None otherwise.
    """

    level: int
    spec: FeatureSpec
    kappa_mult: float  # (1 + 2^-level * kappa)^2, threshold on squared dists

    a_src: np.ndarray
    a_filt: np.ndarray
    b_src: np.ndarray
    a_src_coarse: Optional[np.ndarray] = None
    a_filt_coarse: Optional[np.ndarray] = None
    b_src_coarse: Optional[np.ndarray] = None
    b_filt_coarse: Optional[Any] = None
    a_temporal: Optional[np.ndarray] = None
    b_temporal: Optional[np.ndarray] = None
    # The exemplar catalog's resolution of this level's A-side
    # (catalog/tiers.CatalogRef), attached by the driver for the CPU
    # matcher only: ``entry`` holds a stored build_features_np output (a
    # cold build's bytes); entry=None asks the matcher to build cold and
    # record the result through ``a_features.record(...)``.  CudaMatcher
    # ignores it.
    a_features: Optional[Any] = None
    # Donation consent, set by the driver (it alone knows whether anything
    # still reads the chained planes: retries, keep_levels, checkpoints,
    # saved levels).  The port's donation is the driver's: it drops the
    # coarser level's plane and source map once this level has consumed
    # them; no backend reuses a buffer in place.
    donate: bool = False

    @property
    def a_shape(self) -> Tuple[int, int]:
        return self.a_src.shape[:2]

    @property
    def b_shape(self) -> Tuple[int, int]:
        return self.b_src.shape[:2]


class Matcher(abc.ABC):
    """A matching backend.  Stateless across levels except via returned
    values."""

    def __init__(self, params):
        self.params = params

    @abc.abstractmethod
    def build_features(self, job: LevelJob) -> Any:
        """Build the per-level state (feature DB over A/A', static query
        features, scan schedule) on the backend's device."""

    @abc.abstractmethod
    def synthesize_level(self, db: Any, job: LevelJob
                         ) -> Tuple[Any, Any, Dict[str, Any]]:
        """Synthesize one level.  Returns (bp (H,W) float32, s (H,W) flat
        indices into A, stats) as device tensors; stats may defer device
        scalars under "_n_coh" for the single final fetch."""

    def prefetch_level(self, job: LevelJob) -> None:
        """Warm the caches of a FUTURE level (the pipelined driver calls
        this from a helper thread while the level in flight is issued).
        Only content- or shape-keyed caches may be filled — never the
        level's results — so a prefetch that is skipped, fails or races
        the dispatch changes timing and nothing else.  Default: nothing to
        warm."""

    def load_kernels(self, jobs) -> None:
        """Build and load every kernel library the levels of ``jobs``
        route to, before a watchdogged level loop: a first-use build must
        not run under a dispatch deadline.  Default: no kernels."""
