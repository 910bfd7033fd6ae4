"""catalog/ — the content-addressed exemplar catalog (a copy of the JAX
package's ``catalog/``; the keys, the seals and the npz fields are its, so
each package reads the other's store).

- ``store``  — disk tier: per-style directories of sha256-sealed ``.npz``
  feature artifacts (checkpoint-style seal/quarantine: damaged entries go
  ``.corrupt``, never poison a load);
- ``ann``    — the sealed PCA bases of the two-stage ANN matcher
  (``<root>/_ann/<entry_key>.npz``), derived state beside the entries;
- ``tiers``  — the memory tiers and the tier-by-tier resolution a request
  walks: resident hit → host-RAM hit → disk load → full build, every path
  returning bit-identical features to a cold build;
- ``build``  — ahead-of-time ``ia catalog build``: precompute and persist
  a style's per-level feature pyramid and its ANN bases before traffic
  arrives.

Keying: a style is the exemplar sha1 the JAX package's serve batcher and
router use (``tiers.exemplar_digest``); one entry below it is a content
digest over (per-level FeatureSpec, post-prep A-side planes).

The package imports numpy only at module scope (grep-locked): no torch,
no jax.  On the card the driver does not read the feature tiers, as the
JAX package's TPU backend does not: there the catalog serves the sealed
ANN bases (``backends/cuda.py _resolve_ann_projection``).
"""

from image_analogies_tpu_torch.catalog import (  # noqa: F401
    ann, build, store, tiers)
