"""Application modes (counterpart of the JAX package's
``models/modes.py``): one engine, several applications by varying the
inputs (Hertzmann §6).

- ``artistic_filter``     A : A' :: B : B' with a filtered training pair.
- ``texture_by_numbers``  A = label map, A' = texture; a new label map B
                          gives a texture B' that follows it.
- ``super_resolution``    A = a degraded A', so the analogy learns low-res
                          -> high-res detail; applied to a low-res B.
- ``texture_synthesis``   the degenerate analogy with the source planes
                          ignored (src_weight = 0): patch-based synthesis of
                          more texture like A'.
- video                   frames with a temporal term: ``models/video.py``.

Every function takes a params object (its preset by default) and field
overrides; the device comes the same way (``params.device``, "cuda" by
default, or ``device="cpu"`` among the overrides).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from image_analogies_tpu_torch.config import PRESETS, AnalogyParams
from image_analogies_tpu_torch.models.analogy import (
    AnalogyResult,
    create_image_analogy,
)
from image_analogies_tpu_torch.ops import color, pyramid


def artistic_filter(a, ap, b, params: Optional[AnalogyParams] = None,
                    **overrides) -> AnalogyResult:
    """Classic A : A' :: B : B' filter transfer (the oil_filter preset)."""
    params = (params or PRESETS["oil_filter"]).replace(**overrides)
    return create_image_analogy(a, ap, b, params)


def texture_by_numbers(labels_a, texture_a, labels_b,
                       params: Optional[AnalogyParams] = None,
                       **overrides) -> AnalogyResult:
    """A = label map, A' = texture, B = new label map."""
    params = (params or PRESETS["texture_by_numbers"]).replace(**overrides)
    return create_image_analogy(labels_a, texture_a, labels_b, params)


def blur_for_superres(img: np.ndarray, passes: int = 2) -> np.ndarray:
    """The degradation that builds the super-res training pair: repeated
    binomial blur (the pyramid's stencil, so the coarse statistics of A and
    B agree)."""
    out = color.as_float(img)
    for _ in range(passes):
        out = pyramid.blur_np(out)
    return out


def super_resolution(sharp_a: np.ndarray, low_b: np.ndarray,
                     params: Optional[AnalogyParams] = None,
                     blur_passes: int = 2, **overrides) -> AnalogyResult:
    """Sharpen ``low_b`` by analogy with a sharp exemplar: A = blur(A'),
    A' = ``sharp_a``, B = ``low_b``."""
    params = (params or PRESETS["super_resolution"]).replace(**overrides)
    a = blur_for_superres(sharp_a, blur_passes)
    b = blur_for_superres(low_b, 0)
    return create_image_analogy(a, sharp_a, b, params)


def texture_synthesis(texture: np.ndarray, out_shape,
                      params: Optional[AnalogyParams] = None,
                      seed: Optional[int] = None, seed_weight: float = 0.1,
                      **overrides) -> AnalogyResult:
    """Synthesize an ``out_shape`` patch of more ``texture``.

    ``seed=None`` is the deterministic degenerate analogy: src_weight = 0
    and an all-zero A, so every DB row ties on its source lanes and only
    the causal B' windows (and the lowest-index rule) decide.  With a
    ``seed``, A and B are noise planes drawn from the exemplar's values
    (``np.random.default_rng(seed)``, A first) with the small feature
    weight ``seed_weight``, so repeated syntheses differ.  An explicit
    ``src_weight`` override wins over ``seed_weight``."""
    params = (params or PRESETS["texture_synthesis"]).replace(**overrides)
    tex = color.as_float(texture)
    if seed is None:
        if params.src_weight != 0.0:
            params = params.replace(src_weight=0.0)
        a = np.zeros(tex.shape[:2], np.float32)
        b = np.zeros(tuple(out_shape), np.float32)
    else:
        rng = np.random.default_rng(seed)
        vals = (tex if tex.ndim == 2 else color.luminance(tex)).reshape(-1)
        a = rng.choice(vals, size=tex.shape[:2]).astype(np.float32)
        b = rng.choice(vals, size=tuple(out_shape)).astype(np.float32)
        if "src_weight" not in overrides:
            params = params.replace(src_weight=seed_weight)
    return create_image_analogy(a, tex, b, params)
