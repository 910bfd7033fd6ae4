"""Structured synthetic inputs (a copy of the generator in
``examples/make_assets.py``): the perlin-ish A, its oil-filtered A' and a
perlin-ish B.  ``make_structured(1024, 7)`` rebuilds exactly the inputs of
the cached 1024^2 oracle (``bench_cache/oracle_1024_seed7.*``), whose
``input_digest`` this module reproduces."""

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
