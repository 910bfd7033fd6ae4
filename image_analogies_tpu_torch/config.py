"""Configuration of the PyTorch/CUDA port (counterpart of
``image_analogies_tpu/config.py``).

Only the fields the ported main path reads are here.  Field names, defaults
and validation mirror the JAX package so a params object reads the same in
both; the backend seam becomes an explicit ``device`` ("cuda" by default —
the port runs on the card unless the caller asks for the CPU).

Values of ``strategy`` / ``match_mode`` that the JAX package supports but
this slice has not ported raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

# strategy / match_mode values ported so far
PORTED_STRATEGIES = ("auto", "wavefront")
PORTED_MATCH_MODES = ("auto", "exact_hi", "exact_hi2_2p")

# the rest of the JAX package's surface, with the ROADMAP item porting it
_UNPORTED_STRATEGIES = {
    "exact": "ROADMAP Queue 1 item 5",
    "rowwise": "ROADMAP Queue 1 item 5",
    "batched": "ROADMAP Queue 1 item 5",
}
_UNPORTED_MATCH_MODES = {
    "exact_hi2": "ROADMAP Queue 2 item 3 (packed3_best)",
    "scan_rescue": "ROADMAP Queue 1 item 11 / Queue 2 item 5",
    "scan_rescue_1p": "ROADMAP Queue 1 item 11 / Queue 2 item 5",
    "two_pass": "ROADMAP Queue 1 item 11 / Queue 2 item 6",
    "two_pass_1p": "ROADMAP Queue 1 item 11 / Queue 2 item 6",
}


@dataclass(frozen=True)
class AnalogyParams:
    """Knobs of the synthesis engine (Hertzmann et al. 2001); see the JAX
    package's ``AnalogyParams`` for the full semantics of each field.

    - ``kappa``: coherence wins iff ``d_coh <= d_app * kappa_factor(l)**2``.
    - ``strategy``: "auto" resolves to "wavefront" (anti-diagonal parity
      scan, ``backends/cuda.py``).
    - ``match_mode``: the wavefront anchor scan — "exact_hi" (fp32 argmin
      kernel), "exact_hi2_2p" (bf16 lane-packed tensor-core scan), or "auto"
      (per level: packed at or above ``backends.cuda.PACKED_CROSSOVER_ROWS``
      A rows).
    - ``temporal_weight``: the video term; single-image synthesis ignores it
      (video is ROADMAP Queue 1 item 6).
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
    match_mode: str = "auto"
    temporal_weight: float = 0.0
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
        if self.strategy in _UNPORTED_STRATEGIES:
            raise NotImplementedError(
                f"strategy {self.strategy!r} is not ported yet "
                f"({_UNPORTED_STRATEGIES[self.strategy]}); the port runs "
                f"{PORTED_STRATEGIES}")
        if self.strategy not in PORTED_STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.match_mode in _UNPORTED_MATCH_MODES:
            raise NotImplementedError(
                f"match_mode {self.match_mode!r} is not ported yet "
                f"({_UNPORTED_MATCH_MODES[self.match_mode]}); the port runs "
                f"{PORTED_MATCH_MODES}")
        if self.match_mode not in PORTED_MATCH_MODES:
            raise ValueError(f"unknown match_mode {self.match_mode!r}")
        if self.device not in ("cuda", "cpu") and not \
                self.device.startswith("cuda:"):
            raise ValueError(f"unknown device {self.device!r}")

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
