"""Resolved tuning knobs (counterpart of the JAX package's
``tune/resolve.py``).  Only ``batch_pad_waste_pct``, the one knob the lane
engine reads, is ported: the environment over the default.  The tune
store, the packaged tables and their ``device_kind`` key wait for ROADMAP
Queue 1 item 7.
"""

from __future__ import annotations

import os
import threading

from image_analogies_tpu_torch.utils import logging as ialog

# The lane engine's pad-waste ceiling, in percent (the JAX package's
# tune/geometry.py DEFAULT_BATCH_PAD_WASTE): a member whose finest-level
# query rows pad by more than this share of their bucket refuses the
# batch.  The worst bucket pad is ~33% (just past a 3*2^k midpoint), so 25
# admits most bucket residents and refuses the just-past-an-edge shapes.
DEFAULT_BATCH_PAD_WASTE = 25
BATCH_PAD_WASTE_ENV = "IA_BATCH_PAD_WASTE"

_LOCK = threading.Lock()
_ENV_WARNED = set()  # variables already warned about


def batch_pad_waste_pct() -> int:
    """The lane engine's pad-waste ceiling in percent, read at call time:
    ``IA_BATCH_PAD_WASTE`` when it holds a positive integer, else
    ``DEFAULT_BATCH_PAD_WASTE``.  A bad value is ignored, with one warning
    a process (the JAX package's ``_env_int``)."""
    raw = os.environ.get(BATCH_PAD_WASTE_ENV, "").strip()
    if not raw:
        return DEFAULT_BATCH_PAD_WASTE
    try:
        value = int(raw)
        if value > 0:
            return value
    except ValueError:
        pass
    with _LOCK:
        seen = BATCH_PAD_WASTE_ENV in _ENV_WARNED
        _ENV_WARNED.add(BATCH_PAD_WASTE_ENV)
    if not seen:
        ialog.logger.warning(
            "%s=%r is not a positive integer; the default %d%% holds",
            BATCH_PAD_WASTE_ENV, raw, DEFAULT_BATCH_PAD_WASTE)
    return DEFAULT_BATCH_PAD_WASTE
