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
