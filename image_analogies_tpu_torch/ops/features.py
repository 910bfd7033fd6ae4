"""Neighborhood feature vectors — copies of the JAX package's shared spec
(``image_analogies_tpu/ops/features.py``) plus ``build_features_torch``, the
torch twin of its ``build_features_jax``.

A feature vector for pixel q at pyramid level l concatenates

    [ fine_src | fine_filt | coarse_src | coarse_filt | temporal ]

with ``fine_filt`` causally masked (offsets strictly before the center in
raster order), coarse windows centered at (i//2, j//2), every block scaled
elementwise by sqrt of its Gaussian weights, and edge-replicate (clamp)
handling everywhere.  The torch twin is bit-equal to the NumPy and JAX
builds: every element is a copied pixel times a mask and a weight.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


def window_offsets(p: int) -> np.ndarray:
    """(p*p, 2) int32 offsets (di, dj), row-major di-then-dj."""
    r = p // 2
    return np.array(
        [(di, dj) for di in range(-r, r + 1) for dj in range(-r, r + 1)],
        dtype=np.int32,
    )


def causal_mask(p: int) -> np.ndarray:
    """(p*p,) float32; 1.0 for offsets strictly before center in raster order."""
    off = window_offsets(p)
    m = (off[:, 0] < 0) | ((off[:, 0] == 0) & (off[:, 1] < 0))
    return m.astype(np.float32)


def gaussian_window(p: int) -> np.ndarray:
    """(p*p,) float32 Gaussian weights over the window (sigma = p/3),
    normalized to sum 1."""
    if p == 1:
        return np.ones((1,), dtype=np.float32)
    off = window_offsets(p).astype(np.float64)
    sigma = p / 3.0
    w = np.exp(-(off[:, 0] ** 2 + off[:, 1] ** 2) / (2.0 * sigma**2))
    return (w / w.sum()).astype(np.float32)


@dataclass(frozen=True)
class FeatureSpec:
    """Layout + weights of the feature space at one pyramid level."""

    fine_size: int  # P
    coarse_size: int  # C
    has_coarse: bool
    src_channels: int  # C_s
    src_weight: float = 1.0
    gaussian: bool = True
    temporal_weight: float = 0.0  # > 0 enables the temporal block

    @property
    def fine_n(self) -> int:
        return self.fine_size * self.fine_size

    @property
    def coarse_n(self) -> int:
        return self.coarse_size * self.coarse_size if self.has_coarse else 0

    @property
    def temporal_n(self) -> int:
        return self.fine_n if self.temporal_weight > 0 else 0

    @property
    def block_sizes(self) -> List[int]:
        return [
            self.fine_n * self.src_channels,  # fine_src
            self.fine_n,  # fine_filt (causal)
            self.coarse_n * self.src_channels,  # coarse_src
            self.coarse_n,  # coarse_filt
            self.temporal_n,  # temporal
        ]

    @property
    def total(self) -> int:
        return int(sum(self.block_sizes))

    def slices(self) -> List[slice]:
        out, start = [], 0
        for s in self.block_sizes:
            out.append(slice(start, start + s))
            start += s
        return out

    @property
    def fine_filt_slice(self) -> slice:
        return self.slices()[1]

    def _window_w(self, p: int) -> np.ndarray:
        return gaussian_window(p) if self.gaussian else (
            np.full((p * p,), 1.0 / (p * p), dtype=np.float32))

    def weight_vector(self) -> np.ndarray:
        """(F,) per-element weights w (pre-sqrt)."""
        wf = self._window_w(self.fine_size)
        parts = [np.tile(wf, self.src_channels)
                 * (self.src_weight / max(self.src_channels, 1)),
                 wf.copy()]
        if self.has_coarse:
            wc = self._window_w(self.coarse_size)
            parts.append(np.tile(wc, self.src_channels)
                         * (self.src_weight / max(self.src_channels, 1)))
            parts.append(wc.copy())
        else:
            parts.append(np.zeros((0,), np.float32))
            parts.append(np.zeros((0,), np.float32))
        if self.temporal_weight > 0:
            parts.append(wf * self.temporal_weight)
        else:
            parts.append(np.zeros((0,), np.float32))
        return np.concatenate(parts).astype(np.float32)

    def sqrt_weights(self) -> np.ndarray:
        return np.sqrt(self.weight_vector()).astype(np.float32)

    def fine_causal(self) -> np.ndarray:
        """(fine_n,) float32 causal mask for the fine_filt block."""
        return causal_mask(self.fine_size)

    def query_live_mask(self) -> np.ndarray:
        """(F,) bool: dims that can be NONZERO in a query vector.

        Queries zero the non-causal half of the fine_filt block by
        construction; every other block is live.  The packed scan streams
        only live dims — dead dims reach the score solely through the row
        norm, exactly (the query is zero there)."""
        live = np.ones((self.total,), bool)
        live[self.fine_filt_slice] = causal_mask(self.fine_size) > 0
        return live


def spec_for_level(params, level: int, levels: int, src_channels: int,
                   temporal: bool = False) -> FeatureSpec:
    """FeatureSpec at `level` (0 = finest) of an `levels`-deep pyramid."""
    return FeatureSpec(
        fine_size=params.patch_size,
        coarse_size=params.coarse_patch_size,
        has_coarse=(level < levels - 1),
        src_channels=src_channels,
        src_weight=params.src_weight,
        gaussian=params.gaussian_weights,
        temporal_weight=params.temporal_weight if temporal else 0.0,
    )


# ---------------------------------------------------------------- NumPy twin


def extract_patches_np(img: np.ndarray, p: int) -> np.ndarray:
    """(H,W) -> (H*W, p*p) edge-replicated windows, offset order = window_offsets."""
    h, w = img.shape
    r = p // 2
    x = np.pad(img, r, mode="edge")
    cols = [x[di : di + h, dj : dj + w] for di in range(p) for dj in range(p)]
    return np.stack(cols, axis=-1).reshape(h * w, p * p).astype(np.float32)


def coarse_index_map_np(h: int, w: int, hc: int, wc: int) -> np.ndarray:
    """(H*W,) flat index into the coarse grid for each fine pixel: (i//2, j//2)."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ic = np.minimum(ii // 2, hc - 1)
    jc = np.minimum(jj // 2, wc - 1)
    return (ic * wc + jc).reshape(-1).astype(np.int32)


def _as_channels(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img[..., None]
    return img


def build_features_np(
    spec: FeatureSpec,
    src_fine: np.ndarray,  # (H,W) or (H,W,C_s)
    filt_fine: Optional[np.ndarray],  # (H,W) or None (query static part)
    src_coarse: Optional[np.ndarray],
    filt_coarse: Optional[np.ndarray],
    temporal_fine: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(H*W, F) feature matrix.  fine_filt is always causally masked; pass
    filt_fine=None to leave that block zero (the per-pixel dynamic part)."""
    sf = _as_channels(np.asarray(src_fine, np.float32))
    h, w, cs = sf.shape
    assert cs == spec.src_channels, (cs, spec.src_channels)
    sw = spec.sqrt_weights()
    sl = spec.slices()
    out = np.zeros((h * w, spec.total), dtype=np.float32)

    for c in range(cs):
        blk = extract_patches_np(sf[..., c], spec.fine_size)
        s = sl[0].start + c * spec.fine_n
        out[:, s : s + spec.fine_n] = blk
    if filt_fine is not None:
        blk = extract_patches_np(np.asarray(filt_fine, np.float32),
                                 spec.fine_size)
        out[:, sl[1]] = blk * spec.fine_causal()[None, :]
    if spec.has_coarse:
        sc = _as_channels(np.asarray(src_coarse, np.float32))
        hc, wc, _ = sc.shape
        cmap = coarse_index_map_np(h, w, hc, wc)
        for c in range(cs):
            blk = extract_patches_np(sc[..., c], spec.coarse_size)[cmap]
            s = sl[2].start + c * spec.coarse_n
            out[:, s : s + spec.coarse_n] = blk
        blk = extract_patches_np(np.asarray(filt_coarse, np.float32),
                                 spec.coarse_size)[cmap]
        out[:, sl[3]] = blk
    if spec.temporal_n:
        tp = np.zeros((h, w), np.float32) if temporal_fine is None else (
            np.asarray(temporal_fine, np.float32))
        out[:, sl[4]] = extract_patches_np(tp, spec.fine_size)
    return out * sw[None, :]


def fine_gather_maps(h: int, w: int, p: int):
    """Static per-level index maps for the evolving fine_filt gathers:
    (flat_idx, valid, written), each (H*W, p*p) — clipped flat window
    indices, in-bounds-and-causal, and causal-and-already-written (clamped
    index < q).  The tie-audit rebuilds decision contexts from them."""
    off = window_offsets(p)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    qi = ii.reshape(-1, 1) + off[None, :, 0]
    qj = jj.reshape(-1, 1) + off[None, :, 1]
    inb = (qi >= 0) & (qi < h) & (qj >= 0) & (qj < w)
    ci = np.clip(qi, 0, h - 1)
    cj = np.clip(qj, 0, w - 1)
    flat = (ci * w + cj).astype(np.int32)
    causal = causal_mask(p)[None, :] > 0
    valid = (inb & causal).astype(np.float32)
    q = (ii * w + jj).reshape(-1, 1)
    written = (causal & (flat < q)).astype(np.float32)
    return flat, valid, written


# ---------------------------------------------------------------- torch twin


@functools.lru_cache(maxsize=64)
def _clip_window_idx(h: int, w: int, p: int) -> np.ndarray:
    """(H*W, p*p) int64 flat indices of edge-clamped windows (= edge pad)."""
    off = window_offsets(p)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ci = np.clip(ii.reshape(-1, 1) + off[None, :, 0], 0, h - 1)
    cj = np.clip(jj.reshape(-1, 1) + off[None, :, 1], 0, w - 1)
    return (ci * w + cj).astype(np.int64)


def extract_patches_torch(img: torch.Tensor, p: int) -> torch.Tensor:
    """(H,W) -> (H*W, p*p) edge-clamped windows as ONE clip-index gather
    (the same values as pad + shifted slices, copied bit for bit)."""
    h, w = img.shape
    idx = torch.from_numpy(_clip_window_idx(h, w, p)).to(img.device)
    return img.reshape(-1)[idx]


def build_features_torch(
    spec: FeatureSpec,
    src_fine: torch.Tensor,
    filt_fine: Optional[torch.Tensor],
    src_coarse: Optional[torch.Tensor],
    filt_coarse: Optional[torch.Tensor],
    temporal_fine: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Torch twin of ``build_features_jax`` (same layout, weights, masks,
    and operation order: blocks concatenated, then scaled by sqrt(w)).
    Inputs are float32 tensors on the target device."""
    dev = src_fine.device
    sf = src_fine if src_fine.dim() == 3 else src_fine[..., None]
    h, w, cs = sf.shape
    sw = torch.from_numpy(spec.sqrt_weights()).to(dev)
    parts = [extract_patches_torch(sf[..., c], spec.fine_size)
             for c in range(cs)]
    if filt_fine is not None:
        causal = torch.from_numpy(spec.fine_causal()).to(dev)
        parts.append(extract_patches_torch(filt_fine, spec.fine_size)
                     * causal[None, :])
    else:
        parts.append(torch.zeros((h * w, spec.fine_n), dtype=torch.float32,
                                 device=dev))
    if spec.has_coarse:
        sc = src_coarse if src_coarse.dim() == 3 else src_coarse[..., None]
        hc, wc, _ = sc.shape
        cmap = torch.from_numpy(
            coarse_index_map_np(h, w, hc, wc).astype(np.int64)).to(dev)
        for c in range(cs):
            parts.append(
                extract_patches_torch(sc[..., c], spec.coarse_size)[cmap])
        parts.append(extract_patches_torch(filt_coarse, spec.coarse_size)[cmap])
    if spec.temporal_n:
        tp = (torch.zeros((h, w), dtype=torch.float32, device=dev)
              if temporal_fine is None else temporal_fine)
        parts.append(extract_patches_torch(tp, spec.fine_size))
    return torch.cat(parts, dim=1) * sw[None, :]
