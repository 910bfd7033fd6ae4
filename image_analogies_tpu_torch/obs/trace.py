"""Run-scoped span tracing (the port's counterpart of the JAX package's
``obs/trace.py``).

``run_scope(params, ...)`` opens a run: it mints a ``run_id``, installs a
per-run :class:`~image_analogies_tpu_torch.obs.metrics.ObsScope` (registry
plus flight recorder) as the process-default scope, registers a record
stamper with ``utils.logging`` (every record written while the run is
active gains ``run_id`` and a monotonically increasing ``seq``), and emits
a ``run_manifest`` record (config hash, strategy, levels, the device and
git revision, plus the caller's extras: the tune store and its entries).
On exit it emits a ``run_end`` record carrying the metrics snapshot.

``span(name, **attrs)`` is a context manager producing one ``{"event":
"span", "name": ..., "wall_ms": ..., "depth": ..., "parent": ...}``
record per exit; spans nest through a thread-local stack.

The module is inert unless a run is active: ``run_scope`` with
``params.metrics`` false and no ``log_path`` argument yields None, and
``span`` then returns a singleton no-op context manager (no record, no
allocation, no clock read).  ``run_scope`` is reentrant: a nested call (a
video clip's per-frame synthesis, the bf16 gate's probe) joins the
enclosing run instead of minting a second ``run_id``.

``request_context(**attrs)`` sets ambient attrs on the calling thread that
every span and ``emit_record`` inside inherits (a serve request's id flows
from the worker into the engine's own level spans); ``capture_trace`` /
``ensure_trace`` carry a trace id across threads in the request itself,
and ``parse_trace_header`` / ``format_trace_header`` across the HTTP
front's process boundary (the ``X-IA-Trace`` header).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, Optional

from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.utils import logging as _logging

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RunContext:
    """State of one observed run (one engine invocation or one clip)."""

    __slots__ = ("run_id", "log_path", "scope", "registry", "seq",
                 "_seq_lock", "depth", "owner_thread", "_joined_threads")

    def __init__(self, run_id: str, log_path: Optional[str],
                 scope: _metrics.ObsScope):
        self.run_id = run_id
        self.log_path = log_path
        self.scope = scope
        self.registry = scope.registry
        self.seq = 0
        self._seq_lock = threading.Lock()
        self.depth = 0  # run_scope reentrancy count
        self.owner_thread = threading.get_ident()
        self._joined_threads: set = set()  # foreign threads already warned

    def next_seq(self) -> int:
        with self._seq_lock:
            s = self.seq
            self.seq += 1
            return s


_CURRENT: Optional[RunContext] = None
_SPANS = threading.local()  # per-thread span stack
_REQ_CTX = threading.local()  # per-thread ambient request attrs


def current_run_id() -> Optional[str]:
    return _CURRENT.run_id if _CURRENT is not None else None


def _stamp(record: Dict[str, Any]) -> None:
    ctx = _CURRENT
    if ctx is not None:
        record.setdefault("run_id", ctx.run_id)
        record.setdefault("seq", ctx.next_seq())
        scope = _metrics.current_scope() or ctx.scope
        if scope.recorder is not None:
            scope.recorder.record(record)


# Registered once at import: utils.logging calls it on every emit; it is a
# no-op check while no run is active.
_logging.set_record_stamper(_stamp)


@contextlib.contextmanager
def request_context(**attrs: Any):
    """Ambient trace attributes for the current thread.

    Every span exit and :func:`emit_record` inside the scope inherits
    ``attrs`` (explicit span attrs win): the serve worker wraps each
    request's path once, and every record below it, the engine's own
    ``level`` and ``fetch`` spans included, carries the request's id.
    Nests: an inner scope overlays the outer and restores it on exit."""
    prev = getattr(_REQ_CTX, "attrs", None)
    merged = dict(prev) if prev else {}
    merged.update(attrs)
    _REQ_CTX.attrs = merged
    try:
        yield
    finally:
        _REQ_CTX.attrs = prev


def context_attrs() -> Optional[Dict[str, Any]]:
    """The current thread's ambient request attrs (or None)."""
    return getattr(_REQ_CTX, "attrs", None)


# The ambient keys that cross a thread or process boundary with a request
# (a worker thread through the request, an HTTP hop through the X-IA-Trace
# header): "trace" is the end-to-end trace id, "parent_span" names the hop
# that forwarded it, "origin_request" pins the id the client saw at
# admission.
TRACE_HEADER = "X-IA-Trace"
TRACE_KEYS = ("trace", "parent_span", "origin_request")
_TOKEN_OK = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_-")


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _token_ok(part: str) -> bool:
    return 0 < len(part) <= 64 and all(c in _TOKEN_OK for c in part)


def parse_trace_header(value: Optional[str]) -> Optional[Dict[str, str]]:
    """Parse an ``X-IA-Trace`` header: ``trace/parent_span/request``
    (``-`` marks an absent field).  Returns the context dict or None for
    anything malformed — a bad header degrades to a fresh trace, never
    an error."""
    if not value:
        return None
    parts = value.strip().split("/")
    if len(parts) != 3 or not all(_token_ok(p) for p in parts):
        return None
    ctx: Dict[str, str] = {}
    for key, part in zip(TRACE_KEYS, parts):
        if part != "-":
            ctx[key] = part
    return ctx if "trace" in ctx else None


def format_trace_header(ctx: Optional[Dict[str, Any]] = None
                        ) -> Optional[str]:
    """Render a trace context (default: the ambient one) as the
    ``X-IA-Trace`` header value, or None when there is no trace."""
    if ctx is None:
        ctx = capture_trace()
    if not ctx or "trace" not in ctx:
        return None
    parts = []
    for key in TRACE_KEYS:
        part = str(ctx.get(key, "") or "-")
        parts.append(part if _token_ok(part) else "-")
    return "/".join(parts)


def capture_trace() -> Optional[Dict[str, str]]:
    """The portable subset of the ambient request attrs, what a hop
    carries in the request before another thread runs it.  None when the
    calling thread carries no trace."""
    ambient = getattr(_REQ_CTX, "attrs", None)
    if not ambient or "trace" not in ambient:
        return None
    return {k: str(ambient[k]) for k in TRACE_KEYS if ambient.get(k)}


@contextlib.contextmanager
def ensure_trace(parent_span: Optional[str] = None, **extra: Any):
    """Run the block under a trace: adopt the thread's ambient trace id
    if one is set, else mint one.  ``parent_span`` (and any extra attrs)
    overlay the context either way."""
    ambient = getattr(_REQ_CTX, "attrs", None)
    attrs: Dict[str, Any] = dict(extra)
    if not ambient or not ambient.get("trace"):
        attrs["trace"] = mint_trace_id()
    if parent_span is not None:
        attrs["parent_span"] = parent_span
    with request_context(**attrs):
        yield


_UNSET = object()
_GIT_REV: Any = _UNSET
_POWER: Any = _UNSET


def _git_rev() -> Optional[str]:
    """The checkout's short revision (None outside a git checkout)."""
    global _GIT_REV
    if _GIT_REV is _UNSET:
        try:
            _GIT_REV = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], cwd=_REPO,
                capture_output=True, text=True, timeout=5,
                check=True).stdout.strip() or None
        except Exception:  # noqa: BLE001 - no git, no checkout: no rev
            _GIT_REV = None
    return _GIT_REV


def _power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, once a
    process (None where it does not answer)."""
    global _POWER
    if _POWER is _UNSET:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=10, check=True).stdout.strip().splitlines()
            _POWER = out[0].strip() if out else None
        except Exception:  # noqa: BLE001 - no nvidia-smi here
            _POWER = None
    return _POWER


def _device_info(device: Optional[str]) -> Dict[str, Any]:
    """The run's device: the card's name, capability and count for a CUDA
    run (plus its power limit where ``nvidia-smi`` answers), the CPU for a
    CPU run.  A CUDA run's card is the one it is about to use, so naming
    it is no extra initialization."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    info: Dict[str, Any] = {"torch_version": torch.__version__}
    try:
        if str(device or "").startswith("cuda") and \
                torch.cuda.is_available():
            d = torch.device(device)
            idx = d.index if d.index is not None else \
                torch.cuda.current_device()
            major, minor = torch.cuda.get_device_capability(idx)
            info.update(platform="gpu",
                        device_kind=torch.cuda.get_device_name(idx),
                        device_count=torch.cuda.device_count(),
                        capability=f"{major}.{minor}")
            power = _power_limit()
            if power:
                info["power_limit"] = power
        elif device is not None:
            info.update(platform="cpu", device_kind="cpu", device_count=1)
    except Exception:  # noqa: BLE001 - a manifest never fails a run
        pass
    return info


def config_digest(params: Any) -> str:
    """Stable short hash of every field of the params dataclass."""
    try:
        d = dataclasses.asdict(params)
    except TypeError:
        d = dict(getattr(params, "__dict__", {"repr": repr(params)}))
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


def build_manifest(params: Any = None,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The ``run_manifest`` record (the JAX record's keys; ``backend`` is
    the run's device, ``mesh`` [data_shards, db_shards])."""
    extra = dict(extra or {})
    device = extra.pop("device", None) or getattr(params, "device", None)
    man: Dict[str, Any] = {"event": "run_manifest"}
    if params is not None:
        man["config_hash"] = config_digest(params)
        man["backend"] = str(device) if device is not None else None
        man["strategy"] = getattr(params, "strategy", None)
        man["mesh"] = [getattr(params, "data_shards", 1),
                       getattr(params, "db_shards", 1)]
        man["levels"] = getattr(params, "levels", None)
        man["metrics"] = bool(getattr(params, "metrics", False))
    rev = _git_rev()
    if rev:
        man["git_rev"] = rev
    man.update(_device_info(device))
    man.update(extra)
    return man


@contextlib.contextmanager
def run_scope(params: Any = None, log_path: Optional[str] = None,
              manifest_extra: Optional[Dict[str, Any]] = None):
    """Open an observed run, or join the active one (reentrant).  Inert
    (yields None, no side effects) unless ``params.metrics`` is truthy or
    a ``log_path`` argument is given; the run's records go to that path,
    else to ``params.log_path``.  (The JAX package opens a run on
    ``params.log_path`` alone; the port keeps a plain log, one record per
    level and the driver's events, until metrics are asked for.)"""
    global _CURRENT
    want = bool(getattr(params, "metrics", False) or log_path)
    if log_path is None and params is not None:
        log_path = getattr(params, "log_path", None)

    ctx = _CURRENT
    if ctx is not None:
        # a second thread entering run_scope shares the first one's run:
        # make that visible with one run_join warning per foreign thread
        tid = threading.get_ident()
        if tid != ctx.owner_thread and tid not in ctx._joined_threads:
            ctx._joined_threads.add(tid)
            _logging.emit({"event": "run_join", "severity": "warning",
                           "owner_thread": ctx.owner_thread,
                           "joined_thread": tid}, ctx.log_path)
        ctx.depth += 1
        try:
            yield ctx
        finally:
            ctx.depth -= 1
        return
    if not want:
        yield None
        return

    run_id = uuid.uuid4().hex[:16]
    scope = _metrics.ObsScope(scope_id=f"run:{run_id}")
    ctx = RunContext(run_id, log_path, scope)
    _CURRENT = ctx
    _metrics.install_process_scope(scope)
    # one append handle per log path for the whole run
    _logging.begin_handle_cache()
    try:
        _logging.emit(build_manifest(params, manifest_extra), log_path)
        yield ctx
    finally:
        snap = ctx.registry.snapshot()
        _logging.emit({"event": "run_end", "metrics": snap}, log_path)
        _logging.end_handle_cache()
        _metrics.uninstall_process_scope(scope)
        _CURRENT = None


class _NoopSpan:
    """Singleton no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0", "ctx")

    def __init__(self, name: str, attrs: Dict[str, Any], ctx: RunContext):
        self.name = name
        self.attrs = attrs
        self.ctx = ctx
        self.t0 = 0.0

    def __enter__(self):
        stack = getattr(_SPANS, "stack", None)
        if stack is None:
            stack = _SPANS.stack = []
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        stack = _SPANS.stack
        stack.pop()
        rec: Dict[str, Any] = {"event": "span", "name": self.name,
                               "wall_ms": round(wall_ms, 3),
                               "depth": len(stack)}
        if stack:
            rec["parent"] = stack[-1].name
        if exc and exc[0] is not None:
            rec["error"] = getattr(exc[0], "__name__", str(exc[0]))
        rec.update(self.attrs)
        ambient = getattr(_REQ_CTX, "attrs", None)
        if ambient:
            for k, v in ambient.items():
                rec.setdefault(k, v)
        _logging.emit(rec, self.ctx.log_path)
        return False


def span(name: str, **attrs: Any):
    """Wall-clock span; the no-op singleton when no run is active."""
    ctx = _CURRENT
    if ctx is None:
        return _NOOP
    return _Span(name, attrs, ctx)


def emit_record(record: Dict[str, Any]) -> None:
    """Emit a structured record, with the thread's ambient request attrs,
    into the active run's log (with no run active it still goes to the
    standard logging module)."""
    ctx = _CURRENT
    ambient = getattr(_REQ_CTX, "attrs", None)
    if ambient:
        for k, v in ambient.items():
            record.setdefault(k, v)
    _logging.emit(record, ctx.log_path if ctx is not None else None)


def current_span_attrs() -> Optional[Dict[str, Any]]:
    """Merged attrs of this thread's open spans (innermost wins), so an
    out-of-band record (a library build) names the enclosing level.  None
    when no span is open."""
    stack = getattr(_SPANS, "stack", None)
    if not stack:
        return None
    merged: Dict[str, Any] = {}
    for sp in stack:
        merged.update(sp.attrs)
    return merged
