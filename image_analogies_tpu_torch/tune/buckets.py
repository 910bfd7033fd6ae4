"""Shape buckets: canonical row counts (counterpart of the JAX package's
``tune/buckets.py``, whose functions these copy).

``bucket_rows`` snaps a row count up to a small canonical set — powers of
two plus the 3*2^k midpoints whose power-of-two divisor is still >= 256:

    256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, ...

Worst-case padding is just above a power of two (1025 -> 1536, ~1.5x);
the geometric spacing keeps the bucket count logarithmic in the largest
image.

In the port the ladder serves both sides of a level (``backends/cuda.py
CudaMatcher.build_features``):

- the DB side (the JAX package's ``db_rows_pad``), on the wavefront and
  batched strategies: the scan copies of the DB (``db_pad`` and
  ``dbn_pad``, ``db_pad2`` and ``dbnh_pad``, the bf16 copies) pad their
  rows up to ``bucket_rows(ha*wa)`` with rows that cannot win (+inf
  norms, or the packed layouts' ``_PAD_SCORE`` lanes), at the end, so the
  lowest-index rule never prefers one.  The kernels then see a few row
  counts across exemplar sizes (one launch plan, and later one captured
  graph, a bucket);
- the query side of the batched strategy: a level pads its ``static_q``
  and gather maps with zero rows up to ``bucket_rows(hb*wb)``, so targets
  of different heights (one width) share one lane run
  (``batch/engine.py``).  The scan's row loop stops at each lane's real
  height, so no real row reads a pad row, and :func:`pad_waste_frac`
  measures the dead rows the engine weighs against its ceiling
  (``tune.resolve.batch_pad_waste_pct``).

Bucketing is opt-in (``AnalogyParams.shape_buckets`` or
``IA_SHAPE_BUCKETS=1``): with it off, shapes and outputs are those of an
unbucketed run, bit for bit.
"""

from __future__ import annotations

import os
from typing import Any


def bucket_rows(n: int) -> int:
    """Smallest bucket >= n from {2^k} U {3*2^(k-2) : 2^(k-2) >= 256}."""
    if n <= 256:
        return 256
    k = (n - 1).bit_length()
    three = 3 << (k - 2)
    if three >= n and (three & -three) >= 256:
        return three
    return 1 << k


def pad_waste_frac(n: int, bucket: int = 0) -> float:
    """Fraction of a bucket that is padding for ``n`` real rows.  The lane
    engine compares this against its waste ceiling before admitting a
    batch (dead padded rows cost real work in every scan row)."""
    bucket = bucket or bucket_rows(n)
    if bucket <= 0 or n >= bucket:
        return 0.0
    return (bucket - n) / float(bucket)


def buckets_enabled(params: Any = None) -> bool:
    """Call-time gate: IA_SHAPE_BUCKETS env (non-empty wins outright,
    falsey spellings disable) > ``params.shape_buckets`` > off."""
    env = os.environ.get("IA_SHAPE_BUCKETS", "").strip().lower()
    if env:
        return env not in ("0", "false", "no", "off")
    return bool(getattr(params, "shape_buckets", False))
