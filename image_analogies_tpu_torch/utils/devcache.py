"""Content-keyed device-upload cache (counterpart of the JAX package's
``utils/devcache.py``).

A warm engine should not pay again to move bit-identical inputs: the
exemplar pair A/A' and the B pyramid come back on every run of a serve
loop or a clip.  ``device_put_cached`` keys an upload on its CONTENT —
(sha1 of the bytes, shape, dtype, device) — never on object identity, so a
changed array hashes to a new key and can never be served a stale tensor.
``cached`` memoizes a value built on the device under a key the caller
derives from its inputs (the batched strategies' gather maps, keyed by
shape).  Arrays under 64 KiB pass through: hashing them gains nothing.

The cache is process-wide, thread-safe (the pipelined driver's prefetch
thread fills it while the main thread reads it) and byte-bounded, least
recently used first out: ``IA_DEVCACHE_BYTES`` in the environment, else
``set_max_bytes`` (``AnalogyParams.devcache_max_bytes``), else 1 GiB.
``clear()`` drops it (the retry wrapper does, so that a retry uploads
afresh).

Streams: an entry remembers the CUDA stream it was made on and the event
recorded after it.  A hit from another stream makes that stream wait on
the event and marks the tensors used there (``record_stream``), so the
caching allocator never hands their blocks out while that stream may still
read them.  Uploads stage through pinned host memory and copy without
blocking the host.  Every value is shared by every hit and MUST be treated
as immutable (no consumer in the port writes into one).

Counters, in the active metrics run, as the JAX package names them: an
upload of ``device_put_cached`` counts ``devcache.hits`` or
``devcache.misses`` with ``devcache.upload_bytes``; an entry pushed out by
the budget counts ``devcache.evictions`` and ``devcache.evicted_bytes``;
the ``devcache.bytes`` gauge follows every insert, eviction and clear.  A
cached tensor cannot be freed under the cache, so the JAX package's
``devcache.dead_evictions`` (a donated buffer found deleted) has no cause
here.  A miss visits the chaos site ``devcache.upload`` before it uploads.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.obs import metrics as obs_metrics

_DEFAULT_MAX_BYTES = 1 << 30  # 1 GiB of cached device values
_TINY_BYTES = 1 << 16  # arrays below this pass through


@dataclass
class _Entry:
    value: Any  # a tensor or a tuple of tensors
    nbytes: int
    stream: Optional[torch.cuda.Stream]  # where it was made (CUDA)
    event: Optional[torch.cuda.Event]  # recorded there after it


_LOCK = threading.Lock()
_cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
_bytes = 0
_configured_max: Optional[int] = None


def max_bytes() -> int:
    """The byte budget: env IA_DEVCACHE_BYTES > configured > 1 GiB, read
    at each insert so that a live process can change it."""
    env = os.environ.get("IA_DEVCACHE_BYTES", "").strip()
    if env:
        try:
            n = int(env)
            if n > 0:
                return n
        except ValueError:
            pass
    return _configured_max or _DEFAULT_MAX_BYTES


def set_max_bytes(n: Optional[int]) -> None:
    """Configure the budget (``AnalogyParams.devcache_max_bytes``); None
    restores the default.  The environment still wins."""
    global _configured_max
    _configured_max = int(n) if n else None


def clear() -> None:
    global _bytes
    with _LOCK:
        _cache.clear()
        _bytes = 0
    obs_metrics.set_gauge("devcache.bytes", 0)


def _tensors(value) -> Tuple[torch.Tensor, ...]:
    return value if isinstance(value, tuple) else (value,)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _ready(entry: _Entry, device: torch.device) -> None:
    """Make a hit safe to read on the current stream (see the module
    docstring)."""
    if entry.event is None:
        return
    cur = torch.cuda.current_stream(device)
    if cur != entry.stream:
        cur.wait_event(entry.event)
        for t in _tensors(entry.value):
            t.record_stream(cur)


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of host ``arr`` on ``device``: on the card staged through
    pinned memory and copied on the current stream without blocking the
    host (the pinned block is not reused before the copy ends); on the
    CPU a copy, so that the tensor never aliases the caller's array."""
    dev = _device(device)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cpu":
        return host.clone()
    return host.pin_memory().to(dev, non_blocking=True)


def cached(key: tuple, make: Callable[[], Any], device) -> Any:
    """The value ``make()`` builds on ``device`` (a tensor or a tuple of
    tensors), memoized under ``key``, which must name everything the value
    depends on, the device included."""
    return _cached(key, make, _device(device))[0]


def _cached(key: tuple, make: Callable[[], Any], dev: torch.device
            ) -> Tuple[Any, bool]:
    """``cached``'s value and whether it was a hit."""
    global _bytes
    with _LOCK:
        entry = _cache.get(key)
        if entry is not None:
            _cache.move_to_end(key)
    if entry is not None:
        _ready(entry, dev)
        return entry.value, True
    value = make()
    stream = event = None
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        event = torch.cuda.Event()
        event.record(stream)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(value))
    limit = max_bytes()
    evicted = []
    with _LOCK:
        old = _cache.pop(key, None)  # another thread made it meanwhile
        if old is not None:
            _bytes -= old.nbytes
        _cache[key] = _Entry(value, nbytes, stream, event)
        _bytes += nbytes
        while _bytes > limit and _cache:
            _, out = _cache.popitem(last=False)
            _bytes -= out.nbytes
            evicted.append(out.nbytes)
        total = _bytes
    for n in evicted:
        obs_metrics.inc("devcache.evictions")
        obs_metrics.inc("devcache.evicted_bytes", n)
    obs_metrics.set_gauge("devcache.bytes", total)
    return value, False


def device_put_cached(x, device) -> Optional[torch.Tensor]:
    """``x`` as a float32 tensor on ``device``, memoized by content.

    Host arrays of 64 KiB and more are cached; smaller ones are uploaded
    on every call; tensors pass through (``.to``); None stays None.  A
    miss uploads to ``device`` and nowhere else."""
    if x is None:
        return None
    dev = _device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    arr = np.ascontiguousarray(x, np.float32)
    if arr.nbytes < _TINY_BYTES:
        return upload(arr, dev)
    # sha1 releases the interpreter lock on buffers this size, so the
    # prefetch thread hashes beside the thread issuing launches
    key = (hashlib.sha1(arr).hexdigest(), arr.shape, str(arr.dtype),
           str(dev))

    def miss():
        chaos.site("devcache.upload", nbytes=arr.nbytes)
        return upload(arr, dev)

    value, hit = _cached(key, miss, dev)
    if hit:
        obs_metrics.inc("devcache.hits")
    else:
        obs_metrics.inc("devcache.misses")
        obs_metrics.inc("devcache.upload_bytes", arr.nbytes)
    return value
