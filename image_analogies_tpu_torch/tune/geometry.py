"""Default launch geometry of the port (counterpart of the JAX package's
``tune/geometry.py``): the values every knob of ``tune/resolve.py`` falls
back to when neither an override, the environment, the tune store nor a
packaged table gives one.

The JAX package's knobs are a TPU's (VMEM budgets, Pallas tile rows); the
port's are the free choices of its Hopper launch plans (``ops/match.py``)
and two host-side bounds:

- ``chunks_per_sm``: the DB tiles of a scan are cut into about
  ``chunks_per_sm * sm_count / query tiles`` chunks, one block each.  1 is
  the rule the plans were written with ("about one chunk per SM for each
  query tile": each block walks one long run of tiles and its ring fills
  once); more chunks trade a longer merge for shorter tails.
- ``ring_stages``: a cap on the depth of the Hopper core's TMA ring; 0
  means the deepest ring that fits beside the resident queries.
- ``scan_tile_cap``: the largest per-tile champion scan tile
  (scan_rescue).  The tile decides which rows the rescue re-scores, so it
  is part of the result, not only of the speed.  4096 gives level 0 of
  npr_1024 (Npad 1,048,576) 256 tiles, the tiling the JAX package resolves
  for F <= 128 without a tune store; it was measured on no device.
- ``wavefront_max_rows``: the wavefront scan's A-row bound.  The JAX scan
  carries source indices as exact f32 values, exact below 2^24 rows; the
  port keeps integer indices but holds the same ceiling, and a configured
  value may only lower it.
- ``batch_pad_waste_pct``: the lane engine's pad-waste ceiling.
- ``ann_top_m`` / ``ann_proj_dims``: the two-stage ANN matcher's candidate
  slab per query and the rank of the PCA basis its prefilter scores in
  (``ops/ann.py``): counts, not launch shapes, with the JAX package's
  defaults.

This module is pure: no torch, no environment, no store.  With an empty
store and no environment the launch plans are exactly those the port ran
before the funnel existed.
"""

from __future__ import annotations

# about one DB chunk per SM for each query tile (ops/match.py _hopper_grid,
# _argmin_plan)
DEFAULT_CHUNKS_PER_SM = 1
# 0: the deepest ring (of at most 8 stages) the shared memory allows
DEFAULT_RING_STAGES = 0

# per-tile champion scan tile cap (scan_rescue), rows
SCAN_TILE_CAP = 4096

# the wavefront scan's A-row ceiling (f32-exact source indices); a store or
# environment value may only lower it
WAVEFRONT_MAX_ROWS_CEILING = 1 << 24
DEFAULT_WAVEFRONT_MAX_ROWS = WAVEFRONT_MAX_ROWS_CEILING

# The lane engine's pad-waste ceiling, in percent (the JAX package's
# DEFAULT_BATCH_PAD_WASTE): a member whose finest-level query rows pad by
# more than this share of their bucket refuses the batch.  The worst
# bucket pad is ~33% (just past a 3*2^k midpoint), so 25 admits most
# bucket residents and refuses the just-past-an-edge shapes.
DEFAULT_BATCH_PAD_WASTE = 25

# The two-stage ANN matcher (the JAX package's defaults): the prefilter
# keeps a top-m candidate slab per query from PCA-projected distances,
# then the exact fp32 distance re-scores only the slab.  The JAX package
# chose 64 for recall at its probe sizes and 32 dims for the ~30-250-wide
# feature vectors; neither was measured on a card.
DEFAULT_ANN_TOP_M = 64
DEFAULT_ANN_PROJ_DIMS = 32


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def scan_tile_rows(npad: int, cap_rows: int = SCAN_TILE_CAP) -> int:
    """Per-tile scan tile for a DB padded to ``npad`` rows (the JAX
    package's ``scan_tile_rows``): the largest power of two that divides
    npad, bounded by ``cap_rows`` (snapped down to a power of two, floored
    at 256), then halved until there are at least 16 tiles."""
    p2_npad = npad & (-npad)
    cap = max(cap_rows, 256)
    cap = 1 << (cap.bit_length() - 1)
    tile = min(cap, p2_npad, npad)
    while npad // tile < 16 and tile >= 256:
        tile //= 2
    return tile
