"""Synthetic inputs (a copy of the generators in ``examples/make_assets.py``).

- ``make_structured``: the perlin-ish A, its oil-filtered A' and a
  perlin-ish B.  ``make_structured(1024, 7)`` rebuilds exactly the inputs
  of the cached 1024^2 oracle (``bench_cache/oracle_1024_seed7.*``), whose
  ``input_digest`` this module reproduces.
- ``make_all``: the whole example set of every application (filter pair,
  texture-by-numbers label maps, super-resolution pair, texture exemplar,
  drifting-blob video frames) as arrays, drawn in the order
  ``examples/make_assets.py make_all`` draws them; ``png_round_trip``
  applies the 8-bit quantization those files go through, so that
  ``make_golden_assets`` rebuilds the committed golden inputs
  (``examples/golden/in_*.png``) without PIL.
"""

from __future__ import annotations

import hashlib

import numpy as np

from image_analogies_tpu_torch.ops.pyramid import blur_np


def _perlin_ish(h, w, rng, octaves=4):
    """Multi-octave value noise — a cheap natural-image stand-in."""
    out = np.zeros((h, w), np.float64)
    for o in range(octaves):
        step = max(2, min(h, w) >> (o + 1))
        gh, gw = h // step + 2, w // step + 2
        g = rng.standard_normal((gh, gw))
        ii = np.arange(h) / step
        jj = np.arange(w) / step
        i0 = ii.astype(int)
        j0 = jj.astype(int)
        fi = (ii - i0)[:, None]
        fj = (jj - j0)[None, :]
        v = (g[i0][:, j0] * (1 - fi) * (1 - fj)
             + g[i0 + 1][:, j0] * fi * (1 - fj)
             + g[i0][:, j0 + 1] * (1 - fi) * fj
             + g[i0 + 1][:, j0 + 1] * fi * fj)
        out += v * (0.6 ** o)
    out -= out.min()
    return (out / max(out.max(), 1e-9)).astype(np.float32)


def _oil_filter(img):
    """The A -> A' training filter: smoothing + posterization."""
    x = blur_np(blur_np(img))
    return (np.round(x * 6) / 6.0).astype(np.float32)


def make_structured(h, seed: int = 7):
    """Canonical structured A/A'/B triple (perlin A, oil-filtered A',
    perlin B) of side ``h``."""
    rng = np.random.default_rng(seed)
    a = _perlin_ish(h, h, rng)
    ap = _oil_filter(a)
    b = _perlin_ish(h, h, rng)
    return a, ap, b


def input_digest(a, ap, b) -> str:
    """sha256 prefix of the three planes' float32 bytes — the digest the
    cached oracle records."""
    h = hashlib.sha256()
    for x in (a, ap, b):
        h.update(np.ascontiguousarray(x, np.float32).tobytes())
    return h.hexdigest()[:16]


def _texture(h, w, rng, kind):
    """A texture plane: "stripes" (sine stripes bent by noise), "spots"
    (blurred thresholded noise) or value noise, plus a little grain."""
    if kind == "stripes":
        base = 0.5 + 0.35 * np.sin(
            np.arange(w)[None, :] * 0.55 + 3.0 * _perlin_ish(h, w, rng, 2))
    elif kind == "spots":
        base = _perlin_ish(h, w, rng, 2)
        base = (base > 0.55).astype(np.float32) * 0.6 + 0.2
        base = blur_np(base)
    else:
        base = _perlin_ish(h, w, rng)
    return (base + 0.05 * rng.standard_normal((h, w))).clip(0, 1).astype(
        np.float32)


def make_all(size: int = 256, seed: int = 0) -> dict:
    """Every application's example inputs at side ``size``, by name (the
    file stems ``examples/make_assets.py make_all`` writes): ``filter_{a,
    ap,b}``, ``tbn_{labels_a,texture,labels_b}``, ``sr_{sharp,low}``,
    ``texture`` and ``video_f0..3``.  Float32 arrays in [0, 1], before any
    8-bit quantization."""
    rng = np.random.default_rng(seed)
    h = w = size
    out = {}
    # the artistic filter pair and target
    a = _perlin_ish(h, w, rng)
    out.update(filter_a=a, filter_ap=_oil_filter(a),
               filter_b=_perlin_ish(h, w, rng))
    # texture-by-numbers: two-region label maps
    lab_a = np.zeros((h, w, 3), np.float32)
    split = _perlin_ish(h, w, rng, 2) > 0.5
    lab_a[..., 0] = split
    lab_a[..., 1] = ~split
    tex = np.where(split, _texture(h, w, rng, "stripes"),
                   _texture(h, w, rng, "spots")).astype(np.float32)
    lab_b = np.zeros((h, w, 3), np.float32)
    split_b = _perlin_ish(h, w, np.random.default_rng(seed + 7), 2) > 0.45
    lab_b[..., 0] = split_b
    lab_b[..., 1] = ~split_b
    out.update(tbn_labels_a=lab_a, tbn_texture=tex, tbn_labels_b=lab_b)
    # the super-resolution pair
    out["sr_sharp"] = _texture(h, w, rng, "stripes")
    out["sr_low"] = blur_np(blur_np(_texture(
        h, w, np.random.default_rng(seed + 3), "stripes")))
    # the texture-synthesis exemplar
    out["texture"] = _texture(h, w, rng, "spots")
    # video frames: a blob drifting over noise
    base = _perlin_ish(h, w, rng)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for t in range(4):
        cx = w * (0.3 + 0.1 * t)
        blob = np.exp(-((yy - h * 0.5) ** 2 + (xx - cx) ** 2)
                      / (2 * (0.08 * h) ** 2))
        out[f"video_f{t}"] = (0.7 * base + 0.5 * blob).clip(0, 1).astype(
            np.float32)
    return out


def png_round_trip(img: np.ndarray) -> np.ndarray:
    """What an 8-bit PNG keeps of a float image in [0, 1]: clipped,
    ``x * 255 + 0.5`` truncated to uint8, read back as ``/ 255``."""
    u8 = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0
          + 0.5).astype(np.uint8)
    return u8.astype(np.float32) / 255.0


def make_golden_assets(size_main: int = 64, size_video: int = 32,
                       seed: int = 0) -> dict:
    """The miniature golden inputs (``examples/make_golden.py
    make_assets_small``): ``make_all`` at ``size_main`` for the image
    configs and at ``size_video`` for the video frames and its
    ``video_filter_{a,ap}`` pair, each through ``png_round_trip``."""
    main = make_all(size_main, seed)
    small = make_all(size_video, seed)
    assets = {name: png_round_trip(main[name]) for name in (
        "filter_a", "filter_ap", "filter_b", "tbn_labels_a", "tbn_texture",
        "tbn_labels_b", "sr_sharp", "sr_low", "texture")}
    for t in range(4):
        assets[f"video_f{t}"] = png_round_trip(small[f"video_f{t}"])
    assets["video_filter_a"] = png_round_trip(small["filter_a"])
    assets["video_filter_ap"] = png_round_trip(small["filter_ap"])
    return assets
