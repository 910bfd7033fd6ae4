"""Fault implementations: what an armed site does (the port's copy of the
JAX package's ``chaos/faults.py``).

Raising kinds throw exception types chosen so that the REAL classification
paths are what a drill tests:

- ``transient`` raises :class:`ChaosTransient`, a subclass of
  ``utils.failure.InjectedFailure``: the retry wrapper's synthetic
  transient.
- ``oom`` raises :class:`ChaosOutOfMemory`, a subclass of
  ``torch.cuda.OutOfMemoryError`` with the JAX fault's
  ``RESOURCE_EXHAUSTED`` message, so the port's classifier
  (``utils/failure.py _is_transient``, which keys on that class) sees it
  as a real device OOM, and the retry frees the allocator's cache first.
  (The JAX fault is a class named ``XlaRuntimeError`` because the JAX
  classifier matches on that name; a class that borrowed the name here
  would never be seen as transient.)
- ``crash`` raises :class:`WorkerCrash`, NOT transient on purpose: retry
  wrappers must not absorb it; the serve worker's crash containment (the
  batch requeued) is its only recovery.
- ``process_death`` raises :class:`ProcessDeath`, a ``BaseException``
  that no containment catches.

``corrupt`` is not raised: the site returns the ``"corrupt"`` directive
and the call site applies it (:func:`corrupt_file` on a checkpoint:
deterministic byte flips seeded by the plan).
"""

from __future__ import annotations

import hashlib
import os
import random

import torch

from image_analogies_tpu_torch.utils.failure import InjectedFailure


def stream_seed(*parts) -> int:
    """Stable int seed from mixed parts.  ``hash()`` of a str is randomized
    per process (PYTHONHASHSEED), so seeding Random with a tuple holding
    site names would break the cross-process determinism: digest
    instead."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "big")


class ChaosTransient(InjectedFailure):
    """Injected transient device fault (retryable by design)."""


class ChaosOutOfMemory(torch.cuda.OutOfMemoryError):
    """Injected device OOM: a ``torch.cuda.OutOfMemoryError``, which the
    port's classifier treats as transient, with the JAX fault's
    ``RESOURCE_EXHAUSTED`` message."""


class WorkerCrash(RuntimeError):
    """Injected worker-thread crash: non-transient on purpose."""


class ProcessDeath(BaseException):
    """Injected process death: the whole process is gone, mid-write.

    A ``BaseException`` that the serve worker's crash containment lets
    through: a dead process cannot requeue its batch, resolve futures or
    append a journal line.  In-process drills model death by letting this
    escape the worker thread (it exits, futures unresolved) and then
    tearing the server down non-gracefully; the write-ahead journal's
    replay on restart is the only recovery, which is what the kill-restart
    drill verifies.
    """


def oom_error(site: str, visit: int) -> ChaosOutOfMemory:
    return ChaosOutOfMemory(
        f"RESOURCE_EXHAUSTED: chaos oom at {site} (visit {visit}): "
        "attempting to allocate 9.99G hbm")


def corrupt_file(path: str, seed: int, n_flips: int = 16) -> int:
    """Deterministically flip ``n_flips`` bytes of ``path`` in place.

    Returns the number of bytes flipped (0 when the file is empty or
    missing: corrupting nothing is a no-op, not an error).  Flips land in
    the back half of the file so that container headers survive and the
    damage surfaces as payload corruption (a truncated or garbled npz),
    the realistic partial-write failure.  The same (seed, file name, size)
    flips the same bytes as the JAX package's."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    rng = random.Random(stream_seed(seed, os.path.basename(path), size))
    offsets = sorted({rng.randrange(size // 2, size)
                      for _ in range(min(n_flips, size))})
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    return len(offsets)
