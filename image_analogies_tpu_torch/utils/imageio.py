"""Image load/save (counterpart of the JAX package's
``utils/imageio.py``).

Decode and encode stay on the host.  ``.npy`` files need only NumPy; PIL
is imported only for the other suffixes (PNG, JPG), so nothing on the
card's path needs it.
"""

from __future__ import annotations

import os

import numpy as np

from image_analogies_tpu_torch.ops.color import as_float


def load_image(path: str) -> np.ndarray:
    """Load an image as float32 in [0,1], (H,W) gray or (H,W,3) RGB."""
    if path.endswith(".npy"):
        return _to_float(np.load(path))
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("L", "RGB"):
            im = im.convert("RGB")
        arr = np.asarray(im)
    return _to_float(arr)


def _to_float(arr: np.ndarray) -> np.ndarray:
    arr = as_float(arr)
    if arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., :3]  # strip alpha
    return arr


def save_image(path: str, img: np.ndarray) -> None:
    """Save float [0,1] (H,W) or (H,W,3) as PNG/JPG (or .npy)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    if path.endswith(".npy"):
        np.save(path, img)
        return
    from PIL import Image

    u8 = (img * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(u8).save(path)
