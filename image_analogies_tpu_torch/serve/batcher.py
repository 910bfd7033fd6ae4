"""Batch-compatibility key (the port's copy of the JAX package's
``serve/batcher.py``).

Two requests may share one batched invocation iff one matcher can serve
both with the same launch plans and the same exemplar-side work:

- same ``AnalogyParams`` digest (``obs.trace.config_digest`` — the same
  digest the run manifest records, so batches are auditable from logs);
- same tune shape-bucket for the exemplar row count (``bucket_rows``,
  the granularity at which launch plans are keyed) and for the target;
- same exemplar *content* (sha1 of the A/A' planes).  Sharing a matcher
  across identical exemplars lets the CPU matcher reuse its KD-tree and
  the device matcher its upload cache, and lets the lane engine run the
  batch as one scan.  Requests with equal shapes but different exemplars
  still run — as singleton batches.

Odd shapes need no special casing: a key nobody else shares simply
coalesces with nobody, and the window expires into singleton dispatch.
"""

from __future__ import annotations

import hashlib
from typing import Any, Tuple

import numpy as np

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.tune import buckets as tune_buckets


def exemplar_digest(a: np.ndarray, ap: np.ndarray) -> str:
    h = hashlib.sha1()
    for arr in (a, ap):
        arr = np.ascontiguousarray(arr)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:12]


def key_str(key: Tuple[Any, ...]) -> str:
    """Canonical display form of a batch key (span attrs, trace labels):
    ``digest/a_bucket/b_bucket/exemplar``."""
    return "/".join(str(k) for k in key)


def batch_key(a: np.ndarray, ap: np.ndarray, b: np.ndarray,
              params: AnalogyParams) -> Tuple[Any, ...]:
    a_rows = int(a.shape[0]) * int(a.shape[1])
    b_rows = int(b.shape[0]) * int(b.shape[1])
    return (
        obs_trace.config_digest(params),
        tune_buckets.bucket_rows(a_rows),
        tune_buckets.bucket_rows(b_rows),
        exemplar_digest(a, ap),
    )
