"""Geometry resolution: one funnel for every launch-geometry knob of the
port (counterpart of the JAX package's ``tune/resolve.py``).

A :class:`TuneConfig` is resolved per key ``device|strategy|dtype|f<fp>|
b<bucket>`` (the device kind, the level's strategy, its scan copy's pad
mode as the dtype, the copy's lane width rounded to 128 and the DB rows'
shape bucket), knob by knob:

    tuner override (thread-local)  >  env var  >  store entry (exact key,
        then the bucket wildcard ``...|b*``)  >  packaged device-class
        table (tune.tables)  >  default (tune.geometry)

- **override**: ``ia tune`` brackets its timed candidates with
  :func:`override`, so a swept value flows through the same funnel and
  wrappers production uses.
- **env**: ``IA_CHUNKS_PER_SM`` / ``IA_RING_STAGES`` /
  ``IA_SCAN_TILE_CAP`` / ``IA_WAVEFRONT_ROWS`` / ``IA_BATCH_PAD_WASTE`` /
  ``IA_ANN_TOP_M`` / ``IA_ANN_PROJ_DIMS``, read at call time; a value
  that is not a positive integer is ignored, with one warning a process.
- **store**: :mod:`tune.store`, the persistent JSON of measured winners.
- **packaged**: :mod:`tune.tables`, winners shipped per card class.
- **default**: :mod:`tune.geometry`: with an empty store and no
  environment every launch plan is the one the port ran before the funnel.

``wavefront_max_rows`` is a correctness ceiling: any configured value is
clamped to 2^24.  ``PACKED_CROSSOVER_ROWS`` (``backends/cuda.py``) stays
a constant, as in the JAX package.

The port's launch plans are computed per launch, so the funnel must not
be: a level resolves its config once (``CudaMatcher.build_features``)
and carries it on its ``LevelDB``; a run resolves under :func:`pin_scope`,
so a key consults the store once a run.  Every resolution records its
origin in a process-local provenance registry
(:func:`provenance_snapshot`), emits one ``tune_resolved`` record into an
active run's log the first time a key resolves, and bumps the
``tune.store_hits`` / ``tune.packaged`` / ``tune.fallbacks`` /
``tune.env_overrides`` counters while a metrics run is active.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import trace as _trace
from image_analogies_tpu_torch.tune import buckets as _buckets
from image_analogies_tpu_torch.tune import geometry as _geometry
from image_analogies_tpu_torch.tune import store as _store
from image_analogies_tpu_torch.tune import tables as _tables
from image_analogies_tpu_torch.utils import logging as _logging

_ENV_VARS = {
    "chunks_per_sm": "IA_CHUNKS_PER_SM",
    "ring_stages": "IA_RING_STAGES",
    "scan_tile_cap": "IA_SCAN_TILE_CAP",
    "wavefront_max_rows": "IA_WAVEFRONT_ROWS",
    "batch_pad_waste_pct": "IA_BATCH_PAD_WASTE",
    "ann_top_m": "IA_ANN_TOP_M",
    "ann_proj_dims": "IA_ANN_PROJ_DIMS",
}

_DEFAULTS = {
    "chunks_per_sm": _geometry.DEFAULT_CHUNKS_PER_SM,
    "ring_stages": _geometry.DEFAULT_RING_STAGES,
    "scan_tile_cap": _geometry.SCAN_TILE_CAP,
    "wavefront_max_rows": _geometry.DEFAULT_WAVEFRONT_MAX_ROWS,
    "batch_pad_waste_pct": _geometry.DEFAULT_BATCH_PAD_WASTE,
    "ann_top_m": _geometry.DEFAULT_ANN_TOP_M,
    "ann_proj_dims": _geometry.DEFAULT_ANN_PROJ_DIMS,
}

_TLS = threading.local()  # .overrides while the tuner runs; .pins
_LOCK = threading.Lock()
_PROV: Dict[str, Dict[str, Any]] = {}  # store_key -> provenance record
_ENV_WARNED = set()  # variables already warned about


@dataclass(frozen=True)
class TuneConfig:
    """One resolved geometry: the knobs plus where each came from
    (``origin``: knob -> override|env|store|store_wildcard|packaged|
    default, as pairs so the config stays hashable)."""

    key: str
    chunks_per_sm: int = _geometry.DEFAULT_CHUNKS_PER_SM
    ring_stages: int = _geometry.DEFAULT_RING_STAGES
    scan_tile_cap: int = _geometry.SCAN_TILE_CAP
    wavefront_max_rows: int = _geometry.DEFAULT_WAVEFRONT_MAX_ROWS
    batch_pad_waste_pct: int = _geometry.DEFAULT_BATCH_PAD_WASTE
    ann_top_m: int = _geometry.DEFAULT_ANN_TOP_M
    ann_proj_dims: int = _geometry.DEFAULT_ANN_PROJ_DIMS
    origin: Tuple[Tuple[str, str], ...] = field(default=())
    store_key: str = ""

    def origin_of(self, knob: str) -> str:
        return dict(self.origin).get(knob, "default")

    def knobs(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in _DEFAULTS}


def device_kind() -> str:
    """The current card's name for the store key, without initializing
    anything: "any" unless CUDA is already initialized in this process
    (resolution must never be what initializes the card; a key made
    before and after that would differ)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "any"
    try:
        if not torch.cuda.is_initialized():
            return "any"
        return torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:  # noqa: BLE001 - a key never fails a run
        return "any"


def make_key(device: str, strategy: str, dtype: str, fp: int,
             bucket: Any) -> str:
    return f"{device}|{strategy}|{dtype}|f{fp}|b{bucket}"


def _env_int(knob: str) -> Optional[int]:
    var = _ENV_VARS[knob]
    raw = os.environ.get(var, "").strip()
    if not raw:
        return None
    try:
        v = int(raw)
        if v > 0:
            return v
    except ValueError:
        pass
    with _LOCK:
        seen = var in _ENV_WARNED
        _ENV_WARNED.add(var)
    if not seen:
        _logging.logger.warning("%s=%r is not a positive integer; ignored",
                                var, raw)
        ctx = _trace._CURRENT
        if ctx is not None:
            _logging.emit({"event": "tune_env_error", "severity": "warning",
                           "var": var, "value": raw}, ctx.log_path)
    return None


@contextlib.contextmanager
def pin_scope():
    """Pin geometry for a scope: the first resolution of each key walks the
    whole chain (store I/O, provenance, counters, records); repeats inside
    the scope return the pinned config with no consult.  Reentrant (an
    inner scope joins the outer pin cache) and thread-local."""
    prev = getattr(_TLS, "pins", None)
    if prev is None:
        _TLS.pins = {}
    try:
        yield
    finally:
        _TLS.pins = prev


@contextlib.contextmanager
def override(**knobs: int):
    """Thread-locally pin knobs (the tuner's sweep lever); nests."""
    bad = set(knobs) - set(_ENV_VARS)
    if bad:
        raise ValueError(f"unknown tune knobs {sorted(bad)}")
    prev = getattr(_TLS, "overrides", None)
    merged = dict(prev or {})
    merged.update(knobs)
    _TLS.overrides = merged
    try:
        yield
    finally:
        _TLS.overrides = prev


def _record(cfg: TuneConfig, fp: int, bucket: int) -> None:
    origins = dict(cfg.origin)
    with _LOCK:
        fresh = cfg.store_key not in _PROV
        if fresh:
            _PROV[cfg.store_key] = {"key": cfg.store_key, **cfg.knobs(),
                                    "origin": origins}
    if _metrics._ACTIVE:
        values = origins.values()
        if any(o.startswith("store") for o in values):
            _metrics.inc("tune.store_hits")
        elif "packaged" in values:
            _metrics.inc("tune.packaged")
        else:
            _metrics.inc("tune.fallbacks")
        if "env" in values:
            _metrics.inc("tune.env_overrides")
    if fresh and _trace._CURRENT is not None:
        _logging.emit({"event": "tune_resolved", "key": cfg.store_key,
                       **cfg.knobs(), "origin": origins, "fp": fp,
                       "bucket": bucket}, _trace._CURRENT.log_path)


def provenance_snapshot() -> Dict[str, Dict[str, Any]]:
    with _LOCK:
        return {k: dict(v) for k, v in _PROV.items()}


def reset_provenance() -> None:
    with _LOCK:
        _PROV.clear()


def resolve(*, strategy: str, dtype: str, fp: int, n_rows: int = 0,
            store: Optional[str] = None) -> TuneConfig:
    """The TuneConfig of one key.  ``fp`` is the scan copy's lane width
    (rounded up to 128 here), ``n_rows`` the DB row count its shape bucket
    comes from (0: unknown, bucket 0)."""
    fp = max(_geometry.round_up(max(int(fp), 1), 128), 128)
    bucket = _buckets.bucket_rows(int(n_rows)) if n_rows else 0
    dev = device_kind()
    key = make_key(dev, strategy, dtype, fp, bucket)

    overrides = getattr(_TLS, "overrides", None) or {}
    pins = getattr(_TLS, "pins", None)
    pin_key = (key, store, tuple(sorted(overrides.items())))
    if pins is not None:
        pinned = pins.get(pin_key)
        if pinned is not None:
            return pinned

    entries = _store.load_entries(store)
    exact = entries.get(key)
    wildcard = entries.get(make_key(dev, strategy, dtype, fp, "*"))
    packaged = _tables.lookup(dev, strategy, dtype)
    values: Dict[str, int] = {}
    origin: Dict[str, str] = {}
    for knob, dflt in _DEFAULTS.items():
        if knob in overrides:
            values[knob], origin[knob] = int(overrides[knob]), "override"
            continue
        env = _env_int(knob)
        if env is not None:
            values[knob], origin[knob] = env, "env"
        elif exact is not None and knob in exact:
            values[knob], origin[knob] = int(exact[knob]), "store"
        elif wildcard is not None and knob in wildcard:
            values[knob] = int(wildcard[knob])
            origin[knob] = "store_wildcard"
        elif knob in packaged:
            values[knob], origin[knob] = int(packaged[knob]), "packaged"
        else:
            values[knob], origin[knob] = dflt, "default"
    # a correctness ceiling, not a speed knob: configured values may only
    # lower it
    values["wavefront_max_rows"] = min(
        values["wavefront_max_rows"], _geometry.WAVEFRONT_MAX_ROWS_CEILING)

    cfg = TuneConfig(key=key, store_key=key,
                     origin=tuple(sorted(origin.items())), **values)
    _record(cfg, fp, bucket)
    if pins is not None:
        pins[pin_key] = cfg
    return cfg


# ---------------------------------------------------------------------------
# Call-site conveniences


def level_config(strategy: str, pad_mode: Optional[str], fp: int,
                 n_rows: int) -> TuneConfig:
    """The config of one level: its strategy, its scan copy's pad mode as
    the dtype ("none" without a copy), the copy's width and the DB rows."""
    return resolve(strategy=strategy, dtype=pad_mode or "none", fp=fp,
                   n_rows=n_rows)


def wavefront_max_rows(*, strategy: str = "wavefront", dtype: str = "f32",
                       fp: int = 128, n_rows: int = 0,
                       store: Optional[str] = None) -> int:
    """The wavefront scan's A-row bound, clamped to the 2^24 ceiling."""
    return resolve(strategy=strategy, dtype=dtype, fp=fp, n_rows=n_rows,
                   store=store).wavefront_max_rows


def batch_pad_waste_pct(*, strategy: str = "batched", dtype: str = "f32",
                        fp: int = 128, n_rows: int = 0,
                        store: Optional[str] = None) -> int:
    """The lane engine's pad-waste ceiling in percent (``IA_BATCH_PAD_WASTE``
    over the store over the default 25): a member whose query rows pad by
    more than this share of their bucket refuses the batch."""
    return resolve(strategy=strategy, dtype=dtype, fp=fp, n_rows=n_rows,
                   store=store).batch_pad_waste_pct


def ann_top_m(*, strategy: str = "wavefront", dtype: str = "f32",
              fp: int = 128, n_rows: int = 0,
              store: Optional[str] = None) -> int:
    """The two-stage ANN matcher's candidate slab per query
    (``IA_ANN_TOP_M``): how many prefilter survivors the exact fp32
    re-score takes.  A count, not a launch shape, so every call site
    resolves it at these defaults (one wildcard store row, as ``ia tune
    --knob ann`` writes it, covers both strategies and every width)."""
    return resolve(strategy=strategy, dtype=dtype, fp=fp, n_rows=n_rows,
                   store=store).ann_top_m


def ann_proj_dims(*, strategy: str = "wavefront", dtype: str = "f32",
                  fp: int = 128, n_rows: int = 0,
                  store: Optional[str] = None) -> int:
    """The rank of the PCA basis the ANN prefilter scores in
    (``IA_ANN_PROJ_DIMS``); ``catalog/build.py`` resolves it when it seals
    a basis, so build time and request time agree."""
    return resolve(strategy=strategy, dtype=dtype, fp=fp, n_rows=n_rows,
                   store=store).ann_proj_dims


def scan_tile(npad: int, fp: int = 128, cap_rows: int = 0, *,
              strategy: str = "wavefront", dtype: str = "bf16",
              store: Optional[str] = None) -> int:
    """The per-tile champion scan tile of a DB padded to ``npad`` rows: the
    resolved ``scan_tile_cap`` (or ``cap_rows``) through
    ``geometry.scan_tile_rows``."""
    if not cap_rows:
        cap_rows = resolve(strategy=strategy, dtype=dtype, fp=fp,
                           n_rows=npad, store=store).scan_tile_cap
    return _geometry.scan_tile_rows(npad, cap_rows)


def snap_tile_to_divisor(tile: int, npad: int) -> int:
    """Largest value <= tile that divides npad (>= 1), so a configured tile
    can never trip a kernel's divisibility check."""
    tile = max(min(int(tile), int(npad)), 1)
    if math.gcd(tile, npad) == tile:
        return tile
    best = 1
    d = 1
    while d * d <= npad:
        if npad % d == 0:
            if d <= tile:
                best = max(best, d)
            if npad // d <= tile:
                best = max(best, npad // d)
        d += 1
    return best


def manifest_info(store: Optional[str] = None) -> Dict[str, Any]:
    """Run-manifest extras: where the store lives and how many entries it
    holds."""
    path = _store.store_path(store)
    return {"tune_store": path, "tune_entries": len(_store.load_entries(path))}
