"""Failure detection and level-granular recovery (counterpart of the JAX
package's ``utils/failure.py``).

The recovery unit is the pyramid LEVEL: all cross-level state is the B'
plane and the source map, which ``utils/checkpoint.py`` already saves.  So
the driver runs each level's dispatch inside ``run_with_retry``, and with
``dispatch_timeout_s`` inside ``run_with_watchdog`` too.

Which faults are transient (worth a retry in the same process), walked
through ``__cause__``/``__context__`` with a cycle guard, the first link
that decides winning:

- transient: ``InjectedFailure`` (the fault injector), ``WatchdogTimeout``
  (a dispatch past its deadline) and ``torch.cuda.OutOfMemoryError`` (the
  retry frees the caches first, so fragmentation can clear);
- not transient: a CUDA error, which a kernel's launch check raises as
  ``RuntimeError("<kernel> launch: CUDA error N (...)")``
  (``ops/_build.check``) and torch raises as ``"CUDA error: ..."``.  The
  sticky ones (an illegal address, a launch failure, an ECC error) leave
  the context unusable, so a retry in the same process cannot succeed;
  the rest are program faults.  They surface, and a restarted process
  resumes from the checkpoints;
- not transient: everything else (a build failure, ValueError,
  TypeError, ...): retrying a bug only hides it.

Before a retry the wrapper resets what a failed or abandoned attempt may
have left behind: the device-upload cache, the allocator's cached blocks,
and ``argmin_l2``'s merge workspaces (the state every launch leaves reset,
which a launch that faulted or was abandoned may not have).

``inject_failures`` makes the next ``n`` wrapped calls raise the synthetic
transient ``InjectedFailure``, so recovery is exercised deterministically
without real faults (the chaos plane's ``ChaosTransient`` is one too).

Counters, in the active metrics run, the JAX package's names at its places:
``level_retry`` for each retried fault, ``retry.exhausted`` for a fault past
a budget that was given, ``watchdog.timeouts`` for each deadline passed and
``watchdog.abandoned`` when an abandoned body ends later.  A timeout also
dumps the current scope's flight-recorder ring (``obs/recorder.py
dump_current``) before the transient surfaces.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, Optional

import torch

from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import recorder as obs_recorder
from image_analogies_tpu_torch.utils import logging as ialog

# armed synthetic faults (fault injection for tests and drills); the lock
# makes each armed fault fire in exactly one body when threads retry side
# by side (serve's workers)
_INJECT = {"n": 0}
_INJECT_LOCK = threading.Lock()


class InjectedFailure(RuntimeError):
    """Synthetic transient fault raised by ``inject_failures``."""


class WatchdogTimeout(RuntimeError):
    """A watchdogged dispatch passed its deadline: the dispatch is presumed
    wedged, and the timeout surfaces as a TRANSIENT fault, so a hang
    becomes a retry instead of a stuck process."""


def inject_failures(n: int) -> None:
    """Arm the injector: the next ``n`` ``run_with_retry`` bodies raise
    ``InjectedFailure`` before their real work."""
    with _INJECT_LOCK:
        _INJECT["n"] = int(n)


def _take_injected() -> bool:
    """Consume one armed fault, if any."""
    with _INJECT_LOCK:
        if _INJECT["n"] > 0:
            _INJECT["n"] -= 1
            return True
        return False


def _is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is worth a retry in this process (the rule in the
    module docstring)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (InjectedFailure, WatchdogTimeout,
                            torch.cuda.OutOfMemoryError)):
            return True
        if "CUDA error" in str(exc):
            return False
        exc = exc.__cause__ or exc.__context__
    return False


def backoff_delay(attempt: int, *, backoff_s: float = 0.5,
                  backoff_cap_s: float = 8.0,
                  jitter_seed: Optional[int] = None) -> float:
    """Delay before retry ``attempt`` (1-based): ``backoff_s *
    2**(attempt - 1)`` capped at ``backoff_cap_s``, times a jitter in
    [0.5, 1) drawn from ``Random(seed * 1000003 + attempt)`` — the same
    (seed, attempt) always sleeps the same time, and distinct seeds
    de-correlate callers that retry together."""
    base = min(backoff_s * (2.0 ** max(attempt - 1, 0)), backoff_cap_s)
    if base <= 0:
        return 0.0
    frac = random.Random((jitter_seed or 0) * 1000003 + attempt).random()
    return base * (0.5 + 0.5 * frac)


def reset_device_state() -> None:
    """Drop what an attempt may have left dirty before the next one: the
    upload cache, the caching allocator's free blocks (on the card) and
    ``argmin_l2``'s per-stream merge workspaces."""
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.utils import devcache

    devcache.clear()
    with match._ARGMIN_LOCK:  # never between a launch's fetch and enqueue
        match._ARGMIN_WORKSPACE.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def run_with_retry(
    fn: Callable[[], Any],
    *,
    retries: int = 0,
    context: Optional[dict] = None,
    log_path: Optional[str] = None,
    backoff_s: float = 0.5,
    backoff_cap_s: float = 8.0,
    jitter_seed: Optional[int] = None,
) -> Any:
    """``fn()``, retried up to ``retries`` times on transient faults.

    Each retried fault emits a ``level_retry`` record (error type, attempt
    number, ``context``) and waits ``backoff_delay`` after
    ``reset_device_state``.  A fault that is not transient propagates at
    once; one past the budget emits ``retry_exhausted`` (when a budget was
    given) and propagates the ORIGINAL exception."""
    attempt = 0
    while True:
        try:
            if _take_injected():
                raise InjectedFailure("synthetic fault (inject_failures)")
            return fn()
        except BaseException as exc:  # noqa: BLE001 - filtered below
            if not _is_transient(exc):
                raise
            if attempt >= retries:
                if retries > 0:
                    # only a budget that was given counts: a retries=0
                    # caller never asked for recovery
                    obs_metrics.inc("retry.exhausted")
                    ialog.emit({
                        "event": "retry_exhausted",
                        "attempts": attempt + 1,
                        "error": type(exc).__name__,
                        **(context or {}),
                    }, log_path)
                raise
            attempt += 1
            obs_metrics.inc("level_retry")
            ialog.emit({
                "event": "level_retry",
                "attempt": attempt,
                "error": type(exc).__name__,
                "detail": str(exc)[:200],
                **(context or {}),
            }, log_path)
            reset_device_state()
            time.sleep(backoff_delay(attempt, backoff_s=backoff_s,
                                     backoff_cap_s=backoff_cap_s,
                                     jitter_seed=jitter_seed))


def run_with_watchdog(
    fn: Callable[[], Any],
    timeout_s: float,
    *,
    context: Optional[dict] = None,
    log_path: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> Any:
    """``fn()`` under a wall-clock deadline.

    The body runs on a daemon thread; past ``timeout_s`` the caller emits
    a ``watchdog_timeout`` record and raises ``WatchdogTimeout``
    (transient, so ``run_with_retry`` is its recovery), after counting
    ``watchdog.timeouts`` and dumping the current scope's flight-recorder
    ring.  Python threads cannot be killed: the wedged body is ABANDONED
    and runs on, its result or error dropped, and counts
    ``watchdog.abandoned`` when it ends.  On a CUDA ``device`` each
    attempt runs on a stream of its own, so an abandoned attempt's late
    launches never share a stream, or ``argmin_l2``'s per-stream merge
    workspace, with the retry; the body waits for its stream before it
    returns, so the deadline covers the device work.  ``timeout_s <= 0``
    runs the body inline: no thread, no stream."""
    if timeout_s <= 0:
        return fn()
    cuda = device is not None and torch.device(device).type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    box: dict = {}
    done = threading.Event()

    def body():
        try:
            with (torch.cuda.stream(stream) if cuda
                  else contextlib.nullcontext()):
                box["result"] = fn()
                if cuda:
                    stream.synchronize()
        except BaseException as exc:  # noqa: BLE001 - forwarded or dropped
            box["error"] = exc
        finally:
            if done.is_set():  # the caller timed out: a late end
                obs_metrics.inc("watchdog.abandoned")
            done.set()

    t = threading.Thread(target=body, name="ia-watchdog-body", daemon=True)
    t.start()
    if not done.wait(timeout_s):
        done.set()  # marks the body abandoned before it ends
        obs_metrics.inc("watchdog.timeouts")
        ialog.emit({
            "event": "watchdog_timeout",
            "timeout_s": timeout_s,
            **(context or {}),
        }, log_path)
        # a wedge is when the ring matters: dump it (the record above
        # included) before the transient surfaces
        obs_recorder.dump_current("watchdog_timeout",
                                  extra={"timeout_s": timeout_s,
                                         **(context or {})})
        raise WatchdogTimeout(
            f"dispatch exceeded watchdog timeout {timeout_s:g}s "
            "(presumed wedged; surfacing as transient)")
    if "error" in box:
        raise box["error"]
    return box["result"]
