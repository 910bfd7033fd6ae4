"""The synthesis loop (counterpart of the JAX package's
``models/analogy.py``): coarse-to-fine over pyramid levels on one device,
delegating feature building and the level scan to ``CudaMatcher``.

B' chains between levels as a device tensor; the host fetches once at the
end (the finest plane together with every level's coherence count and,
for the batched strategy, its refinement count).
Pipelining/prefetch, buffer donation, checkpoints, retries and the
watchdog, the exemplar catalog, chaos, observability and the temporal
(video) term are not ported yet (ROADMAP Queue 1 items 5-10).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from image_analogies_tpu_torch.backends.base import LevelJob
from image_analogies_tpu_torch.backends.cuda import CudaMatcher
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.ops import color
from image_analogies_tpu_torch.ops.features import spec_for_level
from image_analogies_tpu_torch.ops.pyramid import (
    build_pyramid_np,
    num_feasible_levels,
)


@dataclass
class AnalogyResult:
    bp: np.ndarray  # (H,W,3) or (H,W) final B'
    bp_y: np.ndarray  # (H,W) synthesized filtered plane (luminance)
    # (H,W) int32 flat indices into A (finest level); a device tensor until
    # first read through `source_map`
    source_map_raw: Any = None
    stats: List[Dict[str, Any]] = field(default_factory=list)
    # with keep_levels=True: every level's (bp, s) as NumPy, finest first —
    # the layout the tie-audit (utils/parity.py) reads
    levels: Optional[List] = None

    @property
    def source_map(self) -> np.ndarray:
        sm = self.source_map_raw
        if not isinstance(sm, np.ndarray):
            sm = sm.cpu().numpy().astype(np.int32)
            self.source_map_raw = sm
        return sm


def resolve_device(device) -> torch.device:
    """The run's device.  A CUDA device without a card raises: the port
    never drops to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "create_image_analogy runs on the card by default and CUDA is "
            "not available here; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _prep_planes(a, ap, b, params):
    """Build the src/filt planes per color mode.

    Returns (a_src, b_src, a_filt, ap_rgb, b_yiq): the matching planes
    ((H,W) or (H,W,C)), A' luminance (possibly remapped), A' as float RGB
    (for source_rgb) and B in YIQ (None when B is grayscale)."""
    a = color.as_float(np.asarray(a))
    ap = color.as_float(np.asarray(ap))
    b = color.as_float(np.asarray(b))
    if a.shape[:2] != ap.shape[:2]:
        raise ValueError(f"A {a.shape} and A' {ap.shape} must share H,W")

    a_filt = color.luminance(ap)
    b_yiq = color.rgb2yiq(b) if (b.ndim == 3 and b.shape[-1] == 3) else None

    if params.color_mode == "yiq_transfer":
        a_src = color.luminance(a)
        b_src = b_yiq[..., 0] if b_yiq is not None else color.luminance(b)
        if params.remap_luminance:
            # ONE affine transform (A's stats -> B's) on both A and A'
            a_src, a_filt = color.remap_pair(a_src, a_filt, b_src)
    else:  # source_rgb: keep label/source channels as-is
        a_src = a
        b_src = b
        a_nc = 1 if a_src.ndim == 2 else a_src.shape[-1]
        b_nc = 1 if b_src.ndim == 2 else b_src.shape[-1]
        if a_nc != b_nc:
            raise ValueError(
                f"A ({a_nc}ch) and B ({b_nc}ch) must have matching channels")
        if params.remap_luminance and a_src.ndim == 2:
            a_src, a_filt = color.remap_pair(a_src, a_filt, b_src)
    return a_src, b_src, a_filt, ap, b_yiq


def _finalize_stats(st: Dict[str, Any]) -> Dict[str, Any]:
    """Turn the fetched coherence (and refinement) counts into the
    documented coherence_ratio (and refined_ratio)."""
    if "_n_coh" in st:
        n = max(st.get("pixels", 1), 1)
        st["coherence_ratio"] = float(st.pop("_n_coh")) / n
        if "_n_ref" in st:
            st["refined_ratio"] = float(st.pop("_n_ref")) / n
    return st


def create_image_analogy(
    a: np.ndarray,
    ap: np.ndarray,
    b: np.ndarray,
    params: AnalogyParams = AnalogyParams(),
    device=None,
    keep_levels: bool = False,
    backend: Optional[CudaMatcher] = None,
) -> AnalogyResult:
    """Synthesize B' such that A : A' :: B : B' (Hertzmann §3).

    ``device`` None means ``params.device`` ("cuda" by default), which
    raises when no card is present; pass ``device="cpu"`` to run on the
    CPU.  ``keep_levels`` returns every level's (bp, s) for the tie-audit.
    ``backend`` replaces the matcher (as the JAX package's argument of the
    same name; ``device`` is then the matcher's).
    """
    if backend is None:
        backend = CudaMatcher(params, resolve_device(
            params.device if device is None else device))
    a_src, b_src, a_filt, ap_rgb, b_yiq = _prep_planes(a, ap, b, params)

    min_shape = (min(a_src.shape[0], b_src.shape[0]),
                 min(a_src.shape[1], b_src.shape[1]))
    levels = num_feasible_levels(min_shape, params.levels, params.patch_size)
    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    b_src_pyr = build_pyramid_np(b_src, levels)
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]

    bp_pyr: List[Optional[torch.Tensor]] = [None] * levels
    s_pyr: List[Optional[torch.Tensor]] = [None] * levels
    stats: List[Dict[str, Any]] = []
    for level in range(levels - 1, -1, -1):  # coarsest -> finest
        coarse = level + 1 < levels
        job = LevelJob(
            level=level,
            spec=spec_for_level(params, level, levels, src_channels),
            kappa_mult=params.kappa_factor(level) ** 2,
            a_src=a_src_pyr[level],
            a_filt=a_filt_pyr[level],
            b_src=b_src_pyr[level],
            a_src_coarse=a_src_pyr[level + 1] if coarse else None,
            a_filt_coarse=a_filt_pyr[level + 1] if coarse else None,
            b_src_coarse=b_src_pyr[level + 1] if coarse else None,
            b_filt_coarse=bp_pyr[level + 1] if coarse else None,
        )
        t0 = time.perf_counter()
        db = backend.build_features(job)
        bp, s, st = backend.synthesize_level(db, job)
        del db
        st["total_ms"] = (time.perf_counter() - t0) * 1e3
        bp_pyr[level], s_pyr[level] = bp, s
        stats.append(st)

    # ONE host fetch for the finest B' plane and every level's device
    # counts (counts <= 2^24 are exact in fp32)
    deferred = [(st, k) for st in stats for k in ("_n_coh", "_n_ref")
                if k in st]
    counts = torch.stack([st[k].reshape(()) for st, k in deferred]).to(
        torch.float32)
    fetched = torch.cat([bp_pyr[0].reshape(-1), counts]).cpu().numpy()
    hb, wb = b_src.shape[:2]
    bp_y = fetched[:hb * wb].reshape(hb, wb).astype(np.float32)
    for (st, k), c in zip(deferred, fetched[hb * wb:]):
        st[k] = float(c)
    for st in stats:
        _finalize_stats(st)

    need_s_host = params.color_mode == "source_rgb" or keep_levels
    s_raw = (s_pyr[0].cpu().numpy().astype(np.int32) if need_s_host
             else s_pyr[0])
    if params.color_mode == "source_rgb":
        ap_flat = ap_rgb.reshape(-1, ap_rgb.shape[-1]) if ap_rgb.ndim == 3 \
            else ap_rgb.reshape(-1)
        out = ap_flat[s_raw.reshape(-1)].reshape(
            bp_y.shape + (() if ap_rgb.ndim == 2 else (ap_rgb.shape[-1],)))
    elif b_yiq is not None:
        out = color.yiq2rgb(
            np.stack([bp_y, b_yiq[..., 1], b_yiq[..., 2]], axis=-1))
    else:
        out = np.clip(bp_y, 0.0, 1.0)
    levels_np = None
    if keep_levels:
        levels_np = [(bp_y, s_raw)] + [
            (bp_pyr[lv].cpu().numpy().astype(np.float32),
             s_pyr[lv].cpu().numpy().astype(np.int32))
            for lv in range(1, levels)]
    return AnalogyResult(bp=out, bp_y=bp_y, source_map_raw=s_raw,
                         stats=stats, levels=levels_np)
