"""Color-space ops: RGB<->YIQ and luminance remapping (a copy of the JAX
package's ``ops/color.py``, which is NumPy-only).

Synthesis runs on luminance (Y of YIQ); B's IQ chroma is carried into B'
(Hertzmann §3.4).  These run once per image on the host.
"""

from __future__ import annotations

import numpy as np

# NTSC YIQ matrix
_RGB2YIQ = np.array(
    [[0.299, 0.587, 0.114],
     [0.59590059, -0.27455667, -0.32134392],
     [0.21153661, -0.52273617, 0.31119955]],
    dtype=np.float64,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ)


def as_float(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] or float -> float32 in [0,1] (H,W) or (H,W,C)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def rgb2yiq(rgb: np.ndarray) -> np.ndarray:
    """(H,W,3) float RGB in [0,1] -> (H,W,3) YIQ."""
    return (rgb.astype(np.float64) @ _RGB2YIQ.T).astype(np.float32)


def yiq2rgb(yiq: np.ndarray) -> np.ndarray:
    """(H,W,3) YIQ -> (H,W,3) RGB, clipped to [0,1]."""
    rgb = yiq.astype(np.float64) @ _YIQ2RGB.T
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def luminance(img: np.ndarray) -> np.ndarray:
    """(H,W) or (H,W,3) -> (H,W) float32 luminance."""
    img = as_float(img)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 1:
        return img[..., 0]
    return rgb2yiq(img[..., :3])[..., 0]


def remap_pair(y_a: np.ndarray, y_ap: np.ndarray | None,
               y_b: np.ndarray) -> tuple:
    """Remap A's luminance to B's statistics and apply the SAME affine
    transform to A' (Hertzmann §3.4) — remapping A' with its own statistics
    would cancel any affine filter A -> A'.

    Returns (remapped_A, remapped_A_or_None)."""
    ya64 = y_a.astype(np.float64)
    yb64 = y_b.astype(np.float64)
    mu_a, sigma_a = float(ya64.mean()), float(ya64.std())
    mu_b, sigma_b = float(yb64.mean()), float(yb64.std())
    if sigma_a < 1e-8:
        scale, shift = 0.0, mu_b
    else:
        scale = sigma_b / sigma_a
        shift = mu_b - scale * mu_a
    out_a = (scale * y_a + shift).astype(np.float32)
    out_ap = None if y_ap is None else (scale * y_ap + shift).astype(np.float32)
    return out_a, out_ap
