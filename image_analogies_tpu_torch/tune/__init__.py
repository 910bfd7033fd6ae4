"""Shape buckets and the lane engine's pad-waste ceiling (the part of the
JAX package's ``tune/`` that the lane engine reads)."""
