"""Configuration of the PyTorch/CUDA port (counterpart of
``image_analogies_tpu/config.py``).

Only the fields the ported paths read are here.  Field names, defaults and
validation mirror the JAX package so a params object reads the same in
both; the backend seam becomes an explicit ``device`` ("cuda" by default —
the port runs on the card unless the caller asks for the CPU).  Every
strategy and every match mode of the JAX package is ported.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

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
