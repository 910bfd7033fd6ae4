"""PyTorch/CUDA port of the image-analogies engine, for one NVIDIA H100.

The JAX package ``image_analogies_tpu`` is the reference; module names here
mirror it so each counterpart is easy to find.  This package imports
``torch`` and numpy only — never ``jax`` and nothing of the JAX package.

Entry points::

    from image_analogies_tpu_torch import create_image_analogy, PRESETS
    res = create_image_analogy(a, ap, b, PRESETS["npr_1024"])   # on the card
    res = modes.super_resolution(sharp, low)     # modes.artistic_filter, ...
    vid = video_analogy(a, ap, frames, PRESETS["video"])
    # python -m image_analogies_tpu_torch.cli run|video|sweep|eval ...
"""

import torch

# TF32 stays off everywhere: the parity scans need fp32-grade scores, and
# cuDNN defaults fp32 convolutions to TF32 (~3 decimal digits) — the reason
# the JAX package runs its blur at HIGHEST (image_analogies_tpu/ops/
# pyramid.py blur_jax).  Set once, where the package starts.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from image_analogies_tpu_torch.config import AnalogyParams, PRESETS  # noqa: E402
from image_analogies_tpu_torch.models import modes  # noqa: E402
from image_analogies_tpu_torch.models.analogy import (  # noqa: E402
    AnalogyResult,
    create_image_analogy,
)
from image_analogies_tpu_torch.models.video import (  # noqa: E402
    VideoResult,
    video_analogy,
)
from image_analogies_tpu_torch.utils.imageio import (  # noqa: E402
    load_image,
    save_image,
)

__all__ = ["AnalogyParams", "AnalogyResult", "PRESETS", "VideoResult",
           "create_image_analogy", "load_image", "modes", "save_image",
           "video_analogy"]
