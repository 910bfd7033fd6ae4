"""SSIM — the parity metric (BASELINE.json:2 "SSIM parity vs CPU").

Standard Wang et al. 2004 SSIM with an 11-tap Gaussian window (sigma=1.5),
implemented in NumPy so the eval has no device dependency.
"""

from __future__ import annotations

import numpy as np


def _gauss_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _filter2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    pad = len(k) // 2
    x = np.pad(img, pad, mode="edge")
    x = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 0, x)
    x = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, x)
    return x


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM of two images in [0, data_range]; RGB averaged per channel."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[-1])]))
    k = _gauss_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _filter2(a, k), _filter2(b, k)
    va = _filter2(a * a, k) - mu_a**2
    vb = _filter2(b * b, k) - mu_b**2
    cab = _filter2(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return float(np.mean(num / den))
