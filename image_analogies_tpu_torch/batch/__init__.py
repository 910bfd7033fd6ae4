"""The lane engine: one level scan synthesizes k B' planes against one
exemplar pair (counterpart of the JAX package's ``batch/``).

``create_image_analogy_batch`` runs k targets through one coarse-to-fine
loop, each wavefront step or scan row one launch for all k lanes
(``backends.cuda.CudaMatcher.synthesize_level_lanes``).  Every member is
bit-identical to its singleton run; a batch that cannot share one scan
raises ``BatchIncompatible`` with its reason.
"""

from image_analogies_tpu_torch.batch.engine import (
    BatchIncompatible,
    create_image_analogy_batch,
)

__all__ = ["BatchIncompatible", "create_image_analogy_batch"]
