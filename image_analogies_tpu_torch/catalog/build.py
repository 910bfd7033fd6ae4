"""Ahead-of-time catalog builds (`ia catalog build`; a copy of the JAX
package's ``catalog/build.py`` over the port's own host builds).

Precompute one style's per-level feature pyramid and persist it as
sealed artifacts BEFORE traffic arrives, mirroring the driver's own prep
exactly (same ``_prep_planes`` → ``build_pyramid_np`` →
``spec_for_level`` → ``build_features_np`` chain), so the keys — and the
bytes — match what a request would have built.

Luminance-remap caveat (Hertzmann §3.4): with ``remap_luminance`` on,
the A planes are affinely remapped to the TARGET's luminance stats, so
an AOT build needs a ``target`` anchor to produce the entries requests
will actually resolve (video clips anchor every frame on frame 0, so
one build with ``target=frame0`` covers the whole clip).  Without a
target the style's own A plane anchors the remap — an exact identity
transform — which matches requests whose target shares A's stats, or
any config with the remap off.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from image_analogies_tpu_torch.catalog import tiers
from image_analogies_tpu_torch.obs import metrics as obs_metrics


def build_style(a, ap, params=None, *, root_dir: Optional[str] = None,
                target=None) -> Dict[str, Any]:
    """Build + persist every level of one style's feature pyramid.

    Returns {style, levels, entries: [{level, key, rows, ms}]}.  Engine
    and ops imports stay lazy so the catalog package imports on any
    host (and `build` itself never touches the device — these are the
    host NumPy builds)."""
    from image_analogies_tpu_torch.config import AnalogyParams
    from image_analogies_tpu_torch.models.analogy import _prep_planes
    from image_analogies_tpu_torch.ops.features import (build_features_np,
                                                        spec_for_level)
    from image_analogies_tpu_torch.ops.pyramid import (build_pyramid_np,
                                                       num_feasible_levels)

    params = params or AnalogyParams()
    a = np.asarray(a)
    ap = np.asarray(ap)
    style = tiers.style_key(a, ap)
    b = np.asarray(target) if target is not None else a
    a_src, b_src, a_filt, _, _ = _prep_planes(a, ap, b, params)
    min_shape = (min(a_src.shape[0], b_src.shape[0]),
                 min(a_src.shape[1], b_src.shape[1]))
    levels = num_feasible_levels(min_shape, params.levels, params.patch_size)
    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]

    entries = []
    for level in range(levels - 1, -1, -1):
        spec = spec_for_level(params, level, levels, src_channels,
                              temporal=False)
        a_src_coarse = a_src_pyr[level + 1] if level + 1 < levels else None
        a_filt_coarse = a_filt_pyr[level + 1] if level + 1 < levels else None
        key = tiers.feature_key(spec, a_src_pyr[level], a_filt_pyr[level],
                                a_src_coarse, a_filt_coarse, None)
        t0 = time.perf_counter()
        db = build_features_np(spec, a_src_pyr[level], a_filt_pyr[level],
                               a_src_coarse, a_filt_coarse,
                               temporal_fine=None)
        ms = (time.perf_counter() - t0) * 1e3
        aff = np.asarray(a_filt_pyr[level], np.float32).reshape(-1)
        tiers.record_build(style, key, db, aff, build_ms=ms,
                           root_dir=root_dir)
        entry = {"level": level, "key": key,
                 "rows": int(db.shape[0]), "ms": ms}
        # Derived ANN state rides the build: seal the PCA basis for this
        # level's feature DB next to the entry so a request with
        # ann_prefilter on never pays the eigendecomposition on the
        # serving path.  numpy-only like the features themselves.
        r = root_dir or tiers.root()
        if r:
            from image_analogies_tpu_torch.catalog import ann as _ann
            from image_analogies_tpu_torch.tune import resolve as _tune_resolve

            mean, proj = _ann.build_projection(
                db, _tune_resolve.ann_proj_dims())
            _ann.save_artifact(r, key, mean, proj)
            obs_metrics.inc("ann.artifacts_built")
            entry["ann_dims"] = int(proj.shape[1])
        entries.append(entry)
    return {"style": style, "levels": levels, "entries": entries}
