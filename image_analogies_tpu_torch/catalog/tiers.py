"""Memory tiers + tier-by-tier resolution of exemplar features (a copy of
the JAX package's ``catalog/tiers.py``, with its keys).

A request resolves a level's A-side features through the tier stack:

    resident ("HBM") hit → host-RAM hit → disk load → full build

- **resident tier** — a small count-capped LRU of consumer-ready
  :class:`Entry` handles (feature DB + flat A' luminance + a consumer
  scratch slot the CPU backend parks its KD-tree in).
- **host tier** — a byte-bounded LRU of decoded arrays between the
  resident tier and disk; ``ia catalog warm`` / fleet join pre-stage a
  worker's styles here before traffic arrives.
- **disk tier** — the sealed artifacts (store.py).

Every path returns the SAME bytes: an entry is a stored
``build_features_np`` output, so bit-identity to a cold build holds by
construction at every tier — a miss anywhere only costs time.

As in the JAX package, the card's driver does not consult the feature
tiers (its backend builds each level's DB on the device); on the card the
catalog serves the sealed ANN bases (``catalog/ann.py``) through
:func:`root` and :func:`feature_key`.  The chaos site ``devcache.tier``
opens each resolution; its ``corrupt`` directive is a mid-request
:func:`evict` of the key (``catalog.chaos_evictions``).

Configuration mirrors devcache: env ``IA_CATALOG_DIR`` /
``IA_CATALOG_HOST_BYTES`` win over the per-run ``AnalogyParams`` knobs
(``catalog_dir`` / ``catalog_host_bytes``, wired by
``tune.warmup.apply_runtime_config``).  Tiers are process-local and
survive across runs — that is the point: the second request for a
cataloged style finds warm tiers no matter which engine instance serves
it.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.catalog import store
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace

_RESIDENT_CAP = 32  # consumer-ready handles (per-level, so ~6 styles deep)
_DEFAULT_HOST_BYTES = 256 << 20

_LOCK = threading.Lock()
_resident: "OrderedDict[str, Entry]" = OrderedDict()
_host: "OrderedDict[str, Tuple[np.ndarray, np.ndarray, int]]" = OrderedDict()
_host_bytes = 0
_configured_root: Optional[str] = None
_configured_host: Optional[int] = None


@dataclass
class Entry:
    """A consumer-ready catalog entry (resident-tier handle)."""

    db: np.ndarray  # (Na, F) stored build_features_np output
    a_filt_flat: np.ndarray  # (Na,) flat A' luminance
    # Consumer scratch keyed by the consumer (the CPU backend parks its
    # cKDTree here so a resident hit skips index construction too).
    # Derived state only — never feeds the stored bytes.
    state: Dict[str, Any] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return int(self.db.nbytes) + int(self.a_filt_flat.nbytes)


@dataclass
class CatalogRef:
    """One level's catalog resolution, attached to LevelJob.a_features.

    ``entry`` is the tier hit (None = every tier missed); the backend
    that then builds cold calls :meth:`record` so every tier above
    fills and the next request skips the build."""

    style: str
    key: str
    entry: Optional[Entry]

    def record(self, db: np.ndarray, a_filt_flat: np.ndarray, *,
               build_ms: float = 0.0) -> Entry:
        self.entry = record_build(self.style, self.key, db, a_filt_flat,
                                  build_ms=build_ms)
        return self.entry


# ------------------------------------------------------------------
# configuration


def root() -> Optional[str]:
    """Effective catalog root: env IA_CATALOG_DIR > configured > None.
    Read at call time so operators can flip it on a live process."""
    env = os.environ.get("IA_CATALOG_DIR", "").strip()
    if env:
        return env
    return _configured_root


def host_budget() -> int:
    env = os.environ.get("IA_CATALOG_HOST_BYTES", "").strip()
    if env:
        try:
            n = int(env)
            if n > 0:
                return n
        except ValueError:
            pass
    if _configured_host:
        return _configured_host
    return _DEFAULT_HOST_BYTES


def configure(root_dir: Optional[str] = None,
              host_bytes: Optional[int] = None) -> None:
    """Per-run wiring (AnalogyParams.catalog_dir / catalog_host_bytes
    plumb here); None clears the configured value.  Env still wins.
    The tiers themselves are NOT dropped — warmth survives runs."""
    global _configured_root, _configured_host
    _configured_root = root_dir or None
    _configured_host = int(host_bytes) if host_bytes else None


def active() -> bool:
    """Catalog consultation is root-gated: no disk tier, no catalog."""
    return root() is not None


# ------------------------------------------------------------------
# keys


def exemplar_digest(a: np.ndarray, ap: np.ndarray) -> str:
    """sha1 of the exemplar pair's shapes, dtypes and bytes (a copy of the
    JAX package's ``serve.batcher.exemplar_digest``, the key its serve
    batcher and router use)."""
    h = hashlib.sha1()
    for arr in (a, ap):
        arr = np.ascontiguousarray(arr)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:12]


def style_key(a, ap) -> str:
    """The style identity: the SAME exemplar sha1 the JAX package's serve
    batcher and router key on, so `ia catalog warm` and ring placement
    agree with where the traffic for this style actually lands."""
    return exemplar_digest(np.asarray(a), np.asarray(ap))


def feature_key(spec, a_src, a_filt, a_src_coarse=None, a_filt_coarse=None,
                a_temporal=None) -> str:
    """Content digest of everything one level's A-side build consumes.

    The POST-prep planes go in (with luminance remap on they depend on
    the target's stats — Hertzmann §3.4), so a catalog entry can only
    resolve for a request that would have built the same bytes."""
    h = hashlib.sha1()
    h.update(repr(spec).encode())
    for arr in (a_src, a_filt, a_src_coarse, a_filt_coarse, a_temporal):
        if arr is None:
            h.update(b"-")
        else:
            x = np.ascontiguousarray(np.asarray(arr))
            h.update(str((x.shape, x.dtype)).encode())
            h.update(x.tobytes())
    return h.hexdigest()[:24]


def lookup(style: str, job) -> CatalogRef:
    """Resolve one LevelJob's A-side through the tiers (driver entry)."""
    key = feature_key(job.spec, job.a_src, job.a_filt, job.a_src_coarse,
                      job.a_filt_coarse, job.a_temporal)
    return CatalogRef(style, key, resolve(style, key, level=job.level))


# ------------------------------------------------------------------
# tier plumbing


def _gauges() -> None:
    obs_metrics.set_gauge("catalog.host.bytes", _host_bytes)
    obs_metrics.set_gauge("catalog.hbm.entries", len(_resident))


def _insert_resident(key: str, ent: Entry) -> None:
    evicted = 0
    with _LOCK:
        _resident[key] = ent
        _resident.move_to_end(key)
        while len(_resident) > _RESIDENT_CAP:
            _resident.popitem(last=False)
            evicted += 1
    for _ in range(evicted):
        obs_metrics.inc("catalog.hbm.evictions")
    _gauges()


def _insert_host(key: str, db: np.ndarray, aff: np.ndarray) -> None:
    global _host_bytes
    n = int(db.nbytes) + int(aff.nbytes)
    budget = host_budget()
    evicted = []
    with _LOCK:
        old = _host.pop(key, None)
        if old is not None:
            _host_bytes -= old[2]
        _host[key] = (db, aff, n)
        _host_bytes += n
        # keep at least the newest entry even when it alone exceeds the
        # budget (evicting it would thrash every request)
        while _host_bytes > budget and len(_host) > 1:
            _, (_, _, en) = _host.popitem(last=False)
            _host_bytes -= en
            evicted.append(en)
    for en in evicted:
        obs_metrics.inc("catalog.host.evictions")
        obs_metrics.inc("catalog.host.evicted_bytes", en)
    _gauges()


def evict(key: str) -> bool:
    """Drop ``key`` from BOTH memory tiers (the chaos directive /
    operator).
    Disk entries stay — the next resolution falls through to them."""
    global _host_bytes
    hit = False
    with _LOCK:
        if _resident.pop(key, None) is not None:
            hit = True
        h = _host.pop(key, None)
        if h is not None:
            hit = True
            _host_bytes -= h[2]
    _gauges()
    return hit


def clear() -> None:
    """Drop all memory tiers (tests / operator reset).  Disk untouched."""
    global _host_bytes
    with _LOCK:
        _resident.clear()
        _host.clear()
        _host_bytes = 0
    _gauges()


def snapshot() -> Dict[str, Any]:
    with _LOCK:
        return {"root": root(), "resident_entries": len(_resident),
                "host_entries": len(_host), "host_bytes": _host_bytes,
                "host_budget": host_budget()}


# ------------------------------------------------------------------
# resolution


def resolve(style: str, key: str, *, level: int = -1) -> Optional[Entry]:
    """Tier-by-tier resolution; None means every tier missed and the
    caller builds cold (then records through :meth:`CatalogRef.record`).
    """
    directive = chaos.site("devcache.tier", style=style, level=level)
    if directive == "corrupt":
        # the "corrupt" directive doubles as the mid-request tier
        # eviction order: drop the key from both memory tiers NOW, so
        # the resolution below must recover through disk or a rebuild
        evict(key)
        obs_metrics.inc("catalog.chaos_evictions")
    with _LOCK:
        ent = _resident.get(key)
        if ent is not None:
            _resident.move_to_end(key)
    if ent is not None:
        obs_metrics.inc("catalog.hbm.hits")
        return ent
    obs_metrics.inc("catalog.hbm.misses")
    with _LOCK:
        hot = _host.get(key)
        if hot is not None:
            _host.move_to_end(key)
    if hot is not None:
        obs_metrics.inc("catalog.host.hits")
        ent = Entry(db=hot[0], a_filt_flat=hot[1])
        _insert_resident(key, ent)
        return ent
    obs_metrics.inc("catalog.host.misses")
    r = root()
    if r:
        got = store.load_entry(r, style, key)
        if got is not None:
            db, aff = got
            obs_metrics.inc("catalog.disk.hits")
            obs_metrics.inc("catalog.disk.read_bytes",
                            int(db.nbytes) + int(aff.nbytes))
            ent = Entry(db=db, a_filt_flat=aff)
            _insert_host(key, db, aff)
            _insert_resident(key, ent)
            return ent
    obs_metrics.inc("catalog.disk.misses")
    return None


def record_build(style: str, key: str, db: np.ndarray,
                 a_filt_flat: np.ndarray, *, build_ms: float = 0.0,
                 root_dir: Optional[str] = None) -> Entry:
    """Record a cold build: fill every tier (and persist a sealed
    artifact when a disk root is configured) so the NEXT resolution of
    this key is a hit.  ``build_ms`` feeds the cold-start histogram."""
    db = np.asarray(db, np.float32)
    aff = np.asarray(a_filt_flat, np.float32)
    ent = Entry(db=db, a_filt_flat=aff)
    _insert_host(key, db, aff)
    _insert_resident(key, ent)
    obs_metrics.inc("catalog.builds")
    obs_metrics.observe("catalog.cold_start_ms", build_ms)
    r = root_dir or root()
    if r:
        store.save_entry(r, style, key, db, aff)
    return ent


# ------------------------------------------------------------------
# prefetch / warm


def warm(style: str, *, root_dir: Optional[str] = None) -> Dict[str, int]:
    """Pre-stage one style's disk entries into the host tier (the `ia
    catalog warm` / fleet-join path).  Returns {entries, bytes} newly
    staged; already-warm entries are skipped."""
    r = root_dir or root()
    out = {"entries": 0, "bytes": 0}
    if not r:
        return out
    for key, _sz in store.list_entries(r, style):
        with _LOCK:
            present = key in _host or key in _resident
        if present:
            continue
        got = store.load_entry(r, style, key)
        if got is None:
            continue
        db, aff = got
        _insert_host(key, db, aff)
        out["entries"] += 1
        out["bytes"] += int(db.nbytes) + int(aff.nbytes)
        obs_metrics.inc("catalog.warmed")
    return out


def warm_for_fleet(router, *, root_dir: Optional[str] = None,
                   only_worker: Optional[str] = None) -> Dict[str, Any]:
    """Ring-placement-aware pre-staging (fleet join / `ia catalog warm`):
    for every cataloged style, ask the router which worker owns it
    (``home_for_style``) and stage its entries into host RAM.  In a
    single-process fleet all workers share one host tier, so everything
    warms; ``only_worker`` restricts to one worker's home styles (the
    multi-host shape, where each host stages only what it owns)."""
    r = root_dir or root()
    report: Dict[str, Any] = {"styles": 0, "entries": 0, "bytes": 0,
                              "placements": {}}
    if not r:
        return report
    for style in store.list_styles(r):
        home = getattr(router, "home_for_style", None)
        wid = home(style) if home is not None else None
        if only_worker is not None and wid != only_worker:
            continue
        got = warm(style, root_dir=r)
        report["styles"] += 1
        report["entries"] += got["entries"]
        report["bytes"] += got["bytes"]
        report["placements"][style] = wid
        obs_metrics.inc("catalog.prefetch.styles")
        obs_metrics.inc("catalog.prefetch.bytes", got["bytes"])
        obs_trace.emit_record({"event": "catalog_prefetch", "style": style,
                               "worker": wid or "",
                               "entries": got["entries"],
                               "bytes": got["bytes"]})
    return report
