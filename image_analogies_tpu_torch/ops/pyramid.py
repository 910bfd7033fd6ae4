"""Gaussian pyramids on the host (a copy of the NumPy half of the JAX
package's ``ops/pyramid.py``).

The main path builds every pyramid with NumPy before the first level runs,
so this slice needs no torch blur: separable [1,4,6,4,1]/16 stencil,
edge-replicate padding, even-pixel decimation.  Index 0 = finest.
"""

from __future__ import annotations

from typing import List

import numpy as np

# 5-tap binomial approximation of a Gaussian, the classic pyrDown kernel.
KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def min_level_size(patch_size: int) -> int:
    """Smallest usable level edge: at least one full patch."""
    return max(patch_size, 4)


def num_feasible_levels(shape, levels: int, patch_size: int) -> int:
    """Clamp requested depth so the coarsest level stays >= one patch."""
    h, w = shape[:2]
    n = 1
    while (
        n < levels
        and (h + 1) // 2 >= min_level_size(patch_size)
        and (w + 1) // 2 >= min_level_size(patch_size)
    ):
        h, w = (h + 1) // 2, (w + 1) // 2
        n += 1
    return n


def blur_np(img: np.ndarray) -> np.ndarray:
    """Separable [1,4,6,4,1]/16 blur with edge-replicate padding, (H,W[,C])."""
    k = KERNEL_1D
    pad = [(2, 2), (0, 0)] + ([(0, 0)] if img.ndim == 3 else [])
    x = np.pad(img, pad, mode="edge")
    x = sum(k[i] * x[i : i + img.shape[0]] for i in range(5))
    pad = [(0, 0), (2, 2)] + ([(0, 0)] if img.ndim == 3 else [])
    x = np.pad(x, pad, mode="edge")
    x = sum(k[i] * x[:, i : i + img.shape[1]] for i in range(5))
    return x.astype(np.float32)


def downsample_np(img: np.ndarray) -> np.ndarray:
    return blur_np(img)[::2, ::2]


def build_pyramid_np(img: np.ndarray, levels: int) -> List[np.ndarray]:
    """[finest, ..., coarsest], length `levels`."""
    pyr = [np.asarray(img, dtype=np.float32)]
    for _ in range(levels - 1):
        pyr.append(downsample_np(pyr[-1]))
    return pyr
