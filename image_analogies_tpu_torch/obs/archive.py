"""Durable telemetry archive: the witness plane for soak (the port's copy
of the JAX package's ``obs/archive.py``: the same sealed lines, segment
names and summary tier, so an archive written by either package reads in
the other).

Every observability surface before this one is deliberately fixed-memory
and in-RAM — the timeline ring folds closed windows away after its
1s->10s->60s tiers, the cost ledger is a bounded deque, anomaly hints
live in a 64-entry ring.  A week-long soak needs a *witness*: what did
the fleet look like six hours ago, what did p99.9 do across the night,
which shed decision preceded the RSS knee.  This module streams those
documents to disk and reads them back offline.

On-disk shape (journal idiom throughout):

- Append-only raw segments ``archive-%06d.jsonl`` under one root.  Each
  line is one sealed record ``{"seal", "ts", "seq", "kind", "doc"}``
  where ``seal`` is sha256 over the canonical JSON of the rest
  (``sort_keys`` + compact separators, first 32 hex chars) — exactly
  serve/journal.py's per-line seal, so a torn tail or a flipped bit
  fails verification on read: the valid prefix is kept, the damaged
  file moves aside as ``<name>.corrupt`` (never deleted — evidence).
- Record kinds: ``timeline`` / ``tenants`` (full endpoint documents —
  the replay contract is that the LAST sealed doc is returned verbatim,
  so round-trip is bit-identical by construction), ``cost`` (per-request
  ledger vectors), ``decision``, ``anomaly``.
- Bounded disk: segments rotate at ``max_segment_bytes``; when the raw
  tier exceeds ``max_total_bytes`` (or a segment outlives ``max_age_s``)
  the oldest raw segment is FOLDED into the coarser summary tier
  (``summary-%06d.jsonl``, rewritten tmp+rename): one sealed line per
  folded segment carrying the span, per-kind counts, and the last
  timeline/tenants doc — so even after compaction eats every raw byte,
  ``replay`` still reconstructs the newest state and ``inspect`` still
  accounts for every record ever written.

The module-level plane mirrors obs/timeline.py: ``_ARMED`` is one bool
and every producer helper checks it first — the disarmed path allocates
nothing (tracemalloc-locked in tests).  Producers: the standalone
timeline sampler calls :func:`sample` per tick (throttled here);
obs/ledger.py streams ``decision`` records and obs/ceilings.py
``anomaly`` ones.  Consumers: ``ia archive inspect|replay|diff`` and the
``/archive/stats`` endpoint.

Pure stdlib, no torch: offline readers and sidecars import this without
a device runtime.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import trace as _trace

_SEGMENT_FMT = "archive-%06d.jsonl"
_SEGMENT_RE = re.compile(r"^archive-(\d{6})\.jsonl$")
_SUMMARY_FMT = "summary-%06d.jsonl"
_SUMMARY_RE = re.compile(r"^summary-(\d{6})\.jsonl$")

DEFAULT_MAX_SEGMENT_BYTES = 1 << 20   # rotate raw segments at 1 MiB
DEFAULT_MAX_TOTAL_BYTES = 64 << 20    # raw tier cap before compaction
DEFAULT_MAX_AGE_S = 7 * 24 * 3600.0   # fold segments older than a week
DEFAULT_SAMPLE_INTERVAL_S = 5.0       # sample() throttle

# Doc kinds whose latest instance a summary line preserves, so replay
# survives total compaction of the raw tier.
_WITNESS_KINDS = ("timeline", "tenants")


def _seal(record: Dict[str, Any]) -> str:
    blob = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _quarantine(path: str) -> str:
    """Journal-style quarantine: damaged evidence moves aside, never
    deleted.  Same contract as utils/checkpoint.quarantine with this
    plane's telemetry names (local so the offline reader does not drag
    in the checkpoint module's numpy import)."""
    qpath = path + ".corrupt"
    os.replace(path, qpath)
    _metrics.inc("obs.archive.quarantined")
    _trace.emit_record({"event": "archive_quarantined", "path": path})
    return qpath


def _read_sealed_lines(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    """Verified records of one segment file (valid prefix) plus a
    damaged flag.  First seal failure stops the scan: everything after
    an unverifiable line is untrusted."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return records, False
    for raw in lines:
        if not raw.strip():
            continue
        try:
            # binary read: a flipped byte may not even be valid UTF-8
            rec = json.loads(raw.decode())
            seal = rec.pop("seal")
            if _seal(rec) != seal:
                return records, True
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            return records, True
        records.append(rec)
    return records, False


class TelemetryArchive:
    """One archive root: sealed ring segments plus the summary tier.

    Thread-safe writer; readers (:meth:`read`, :meth:`replay`) operate
    on whatever is durable, so a separate process can inspect a live
    archive.  The clock is injectable for deterministic tests."""

    def __init__(self, root: str,
                 max_segment_bytes: int = DEFAULT_MAX_SEGMENT_BYTES,
                 max_total_bytes: int = DEFAULT_MAX_TOTAL_BYTES,
                 max_age_s: float = DEFAULT_MAX_AGE_S,
                 sample_interval_s: float = DEFAULT_SAMPLE_INTERVAL_S,
                 clock: Callable[[], float] = time.time):
        self.root = root
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_total_bytes = int(max_total_bytes)
        self.max_age_s = float(max_age_s)
        self.sample_interval_s = float(sample_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        # Writer always opens a fresh segment above every existing index
        # (raw or summary): single-writer per segment, like the journal.
        taken = [i for i, _ in self._indexed(_SEGMENT_RE)]
        taken += [i for i, _ in self._indexed(_SUMMARY_RE)]
        self._seg_index = (max(taken) + 1) if taken else 0
        self._seg_bytes = 0
        self._seq = 0
        self._appended = 0
        self._dropped = 0
        self._compactions = 0
        self._last_sample = 0.0
        self._last_anomaly: Tuple[float, str] = (-1.0, "")
        self._seen_costs = 0

    # ----------------------------------------------------------- paths
    def _indexed(self, pat: re.Pattern) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            m = pat.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def _seg_path(self) -> str:
        return os.path.join(self.root, _SEGMENT_FMT % self._seg_index)

    # ----------------------------------------------------------- write
    def append(self, kind: str, doc: Any,
               now: Optional[float] = None) -> bool:
        """Seal one record onto the current segment.  Returns False when
        the record was dropped (injected or real disk trouble) — the
        archive is a witness, never a request-path dependency, so write
        failures count (``obs.archive.append_errors``) and drop rather
        than raise."""
        if now is None:
            now = self._clock()
        try:
            directive = chaos.site("archive.append", kind=kind)
        except Exception:  # noqa: BLE001 - an injected write failure
            # raising fault kinds model disk-full / EIO on the write
            with self._lock:
                self._dropped += 1
            _metrics.inc("obs.archive.append_errors")
            return False
        with self._lock:
            rec = {"ts": round(now, 3), "seq": self._seq,
                   "kind": kind, "doc": doc}
            line = json.dumps({"seal": _seal(rec), **rec},
                              sort_keys=True, separators=(",", ":"))
            path = self._seg_path()
            try:
                with open(path, "a") as f:
                    f.write(line + "\n")
            except (OSError, ValueError):
                self._dropped += 1
                _metrics.inc("obs.archive.append_errors")
                return False
            self._seq += 1
            self._appended += 1
            self._seg_bytes += len(line) + 1
            _metrics.inc("obs.archive.appended")
            if directive == "corrupt":
                # damage lands AFTER a successful-looking write — the
                # torn-segment drill's realistic failure shape.
                from image_analogies_tpu_torch.chaos import faults as _faults
                _faults.corrupt_file(path, seed=self._seq, n_flips=1)
            if self._seg_bytes >= self.max_segment_bytes:
                self._seg_index += 1
                self._seg_bytes = 0
            self._compact_locked(now)
        return True

    def _compact_locked(self, now: float) -> None:
        """Fold oldest closed raw segments into the summary tier until
        the raw tier fits ``max_total_bytes`` and nothing closed is
        older than ``max_age_s``.  The summary file is rewritten
        tmp+rename, so a crash mid-compaction leaves either the old
        summary or the new one — never a torn hybrid."""
        while True:
            segs = self._indexed(_SEGMENT_RE)
            closed = [(i, p) for i, p in segs if i < self._seg_index]
            if not closed:
                return
            total = 0
            for _i, p in segs:
                try:
                    total += os.path.getsize(p)
                except OSError:
                    pass
            oldest_i, oldest_p = closed[0]
            try:
                age = now - os.path.getmtime(oldest_p)
            except OSError:
                age = 0.0
            if total <= self.max_total_bytes and age <= self.max_age_s:
                return
            self._fold_locked(oldest_i, oldest_p)

    def _fold_locked(self, seg_i: int, seg_path: str) -> None:
        records, damaged = _read_sealed_lines(seg_path)
        summ_doc: Dict[str, Any] = {"segment": seg_i,
                                    "records": len(records),
                                    "kinds": {}, "last": {}}
        if records:
            summ_doc["span"] = [records[0].get("ts"),
                                records[-1].get("ts")]
        for rec in records:
            k = str(rec.get("kind"))
            summ_doc["kinds"][k] = summ_doc["kinds"].get(k, 0) + 1
            if k in _WITNESS_KINDS:
                summ_doc["last"][k] = rec.get("doc")
        srec = {"ts": round(self._clock(), 3), "kind": "summary",
                "doc": summ_doc}
        sline = json.dumps({"seal": _seal(srec), **srec},
                           sort_keys=True, separators=(",", ":"))
        spath = os.path.join(self.root, _SUMMARY_FMT % 0)
        tmp = spath + ".tmp"
        try:
            existing = ""
            if os.path.exists(spath):
                with open(spath) as f:
                    existing = f.read()
            with open(tmp, "w") as f:
                f.write(existing + sline + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, spath)
        except OSError:
            _metrics.inc("obs.archive.append_errors")
            return
        if damaged:
            _quarantine(seg_path)
        else:
            try:
                os.remove(seg_path)
            except OSError:
                pass
        self._compactions += 1
        _metrics.inc("obs.archive.compactions")

    # ------------------------------------------------------------ read
    def read(self) -> Iterator[Dict[str, Any]]:
        """Every verified record on disk, summaries first, then raw
        segments in index order.  Damaged files yield their valid
        prefix and are quarantined ``.corrupt`` in place."""
        for _i, path in self._indexed(_SUMMARY_RE):
            records, damaged = _read_sealed_lines(path)
            if damaged:
                _quarantine(path)
            for rec in records:
                yield rec
        for _i, path in self._indexed(_SEGMENT_RE):
            records, damaged = _read_sealed_lines(path)
            if damaged:
                _quarantine(path)
            for rec in records:
                yield rec

    def history(self, kind: str) -> List[Dict[str, Any]]:
        """All archived docs of one kind, oldest first (summary-folded
        segments contribute their preserved last doc)."""
        out: List[Dict[str, Any]] = []
        for rec in self.read():
            if rec.get("kind") == kind:
                out.append(rec.get("doc"))
            elif rec.get("kind") == "summary":
                last = (rec.get("doc") or {}).get("last") or {}
                if kind in last:
                    out.append(last[kind])
        return out

    def replay(self) -> Dict[str, Any]:
        """Reconstruct the latest ``/timeline`` + ``/tenants`` documents
        (verbatim — the round-trip contract) plus totals over
        everything the archive witnessed."""
        timeline_doc: Optional[Dict[str, Any]] = None
        tenants_doc: Optional[Dict[str, Any]] = None
        kinds: Dict[str, int] = {}
        decisions: List[Dict[str, Any]] = []
        anomalies: List[Dict[str, Any]] = []
        span: List[Optional[float]] = [None, None]
        for rec in self.read():
            kind = str(rec.get("kind"))
            ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                span[0] = ts if span[0] is None else min(span[0], ts)
                span[1] = ts if span[1] is None else max(span[1], ts)
            if kind == "summary":
                doc = rec.get("doc") or {}
                for k, n in (doc.get("kinds") or {}).items():
                    kinds[k] = kinds.get(k, 0) + int(n)
                last = doc.get("last") or {}
                if "timeline" in last:
                    timeline_doc = last["timeline"]
                if "tenants" in last:
                    tenants_doc = last["tenants"]
                continue
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind == "timeline":
                timeline_doc = rec.get("doc")
            elif kind == "tenants":
                tenants_doc = rec.get("doc")
            elif kind == "decision":
                decisions.append(rec.get("doc"))
            elif kind == "anomaly":
                anomalies.append(rec.get("doc"))
        return {"timeline": timeline_doc, "tenants": tenants_doc,
                "kinds": kinds, "decisions": decisions,
                "anomalies": anomalies, "span": span}

    def stats(self) -> Dict[str, Any]:
        """The ``/archive/stats`` document + the ceilings watchdog's
        archive-disk-usage series."""
        segs = self._indexed(_SEGMENT_RE)
        summs = self._indexed(_SUMMARY_RE)
        total = 0
        for _i, p in segs + summs:
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        quarantined = 0
        try:
            quarantined = sum(1 for n in os.listdir(self.root)
                              if n.endswith(".corrupt"))
        except OSError:
            pass
        with self._lock:
            return {"root": self.root, "segments": len(segs),
                    "summary_segments": len(summs), "bytes": total,
                    "appended": self._appended, "dropped": self._dropped,
                    "compactions": self._compactions,
                    "quarantined": quarantined,
                    "max_segment_bytes": self.max_segment_bytes,
                    "max_total_bytes": self.max_total_bytes}

    # --------------------------------------------------------- sampling
    def sample(self, now: Optional[float] = None,
               force: bool = False) -> bool:
        """One witness tick: seal the current ``/timeline`` and
        ``/tenants`` documents plus any new anomaly hints and ledger
        cost vectors.  Throttled to ``sample_interval_s`` so the fleet
        health loop / timeline sampler can call it every poll; returns
        True when a sample was taken."""
        from image_analogies_tpu_torch.obs import ledger as _ledger
        from image_analogies_tpu_torch.obs import timeline as _timeline

        if now is None:
            now = self._clock()
        with self._lock:
            if not force and now - self._last_sample < self.sample_interval_s:
                return False
            self._last_sample = now
        tl_doc = _timeline.snapshot_json()
        if tl_doc.get("armed"):
            self.append("timeline", tl_doc, now=now)
            for hint in tl_doc.get("anomalies") or []:
                key = (float(hint.get("window_start", 0.0)),
                       str(hint.get("series", "")))
                if key > self._last_anomaly:
                    self._last_anomaly = key
                    self.append("anomaly", hint, now=now)
        led = _ledger.current()
        if led is not None:
            tn_doc = _ledger.tenants_doc()
            self.append("tenants", tn_doc, now=now)
            recorded = int(tn_doc.get("recorded") or 0)
            fresh = recorded - self._seen_costs
            if fresh > 0:
                # best-effort: the deque bounds how far back we can see
                for vec in led.recent(fresh):
                    self.append("cost", vec, now=now)
                self._seen_costs = recorded
        return True


# --- archive diffing ---------------------------------------------------------

def diff_replays(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Compare two :meth:`TelemetryArchive.replay` documents — the
    regression-hunting view behind ``ia archive diff``.  Pure function
    of the two docs so tests and the CLI share it."""
    out: Dict[str, Any] = {"kinds": {}, "series": {}, "tenants": {}}
    ka, kb = a.get("kinds") or {}, b.get("kinds") or {}
    for k in sorted(set(ka) | set(kb)):
        if ka.get(k, 0) != kb.get(k, 0):
            out["kinds"][k] = [ka.get(k, 0), kb.get(k, 0)]

    def last_points(doc: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        pts: Dict[str, Any] = {}
        for name, ent in ((doc or {}).get("series") or {}).items():
            points = (ent or {}).get("points") or []
            if points:
                pts[name] = points[-1][1]
        return pts

    sa, sb = last_points(a.get("timeline")), last_points(b.get("timeline"))
    for name in sorted(set(sa) | set(sb)):
        va, vb = sa.get(name), sb.get(name)
        if va is None or vb is None:
            out["series"][name] = {"a": va, "b": vb}
        elif isinstance(va, dict) or isinstance(vb, dict):
            da = va if isinstance(va, dict) else {}
            db = vb if isinstance(vb, dict) else {}
            delta = {k: [da.get(k), db.get(k)]
                     for k in ("p50", "p95", "p99", "p999", "count")
                     if da.get(k) != db.get(k)
                     and (k in da or k in db)}
            if delta:
                out["series"][name] = delta
        elif va != vb:
            out["series"][name] = {"a": va, "b": vb}

    def tenant_rows(doc: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        return {str(r.get("tenant")): r
                for r in ((doc or {}).get("tenants") or [])}

    ta, tb = tenant_rows(a.get("tenants")), tenant_rows(b.get("tenants"))
    for t in sorted(set(ta) | set(tb)):
        ra, rb = ta.get(t), tb.get(t)
        if ra is None or rb is None:
            out["tenants"][t] = {"a": "present" if ra else "absent",
                                 "b": "present" if rb else "absent"}
    out["empty"] = not (out["kinds"] or out["series"] or out["tenants"])
    return out


def render_diff(d: Dict[str, Any]) -> str:
    lines = ["ia archive diff"]
    if d.get("empty"):
        lines.append("  (no differences)")
    for k, (na, nb) in sorted((d.get("kinds") or {}).items()):
        lines.append(f"  records[{k}]: {na} -> {nb}")
    for name, delta in sorted((d.get("series") or {}).items()):
        lines.append(f"  series {name}: {json.dumps(delta, sort_keys=True)}")
    for t, delta in sorted((d.get("tenants") or {}).items()):
        lines.append(f"  tenant {t}: {delta.get('a')} -> {delta.get('b')}")
    return "\n".join(lines) + "\n"


# --- module-level armed plane ------------------------------------------------
#
# Mirrors obs/timeline.py: one bool, producer helpers check it first,
# the disarmed path allocates nothing (tracemalloc-locked in tests).

_ARMED = False
_ARM_LOCK = threading.Lock()
_ARM_COUNT = 0
_ARCHIVE: Optional[TelemetryArchive] = None


def arm(root: Optional[str] = None,
        archive: Optional[TelemetryArchive] = None,
        **kwargs: Any) -> TelemetryArchive:
    """Install (or join) the process archive.  Arming registers a
    timeline-sampler feeder so a standalone ``ia serve --http`` persists
    without extra wiring; the fleet health loop calls :func:`sample`
    itself."""
    from image_analogies_tpu_torch.obs import timeline as _timeline

    global _ARMED, _ARM_COUNT, _ARCHIVE
    with _ARM_LOCK:
        if _ARCHIVE is None:
            if archive is not None:
                _ARCHIVE = archive
            else:
                if root is None:
                    raise ValueError("archive.arm() needs a root "
                                     "directory or an archive instance")
                _ARCHIVE = TelemetryArchive(root, **kwargs)
        _ARM_COUNT += 1
        _ARMED = True
        _timeline.register_feeder(_feed)
        return _ARCHIVE


def disarm() -> None:
    from image_analogies_tpu_torch.obs import timeline as _timeline

    global _ARMED, _ARM_COUNT, _ARCHIVE
    with _ARM_LOCK:
        _ARM_COUNT = max(_ARM_COUNT - 1, 0)
        if _ARM_COUNT == 0:
            _ARCHIVE = None
            _ARMED = False
            _timeline.unregister_feeder(_feed)


def current() -> Optional[TelemetryArchive]:
    return _ARCHIVE if _ARMED else None


def record(kind: str, doc: Any) -> None:
    """Producer fast path: one bool check when disarmed."""
    if not _ARMED:
        return
    ar = _ARCHIVE
    if ar is not None:
        ar.append(kind, doc)


def sample(force: bool = False) -> None:
    if not _ARMED:
        return
    ar = _ARCHIVE
    if ar is not None:
        ar.sample(force=force)


def _feed() -> None:
    sample()


def stats_doc() -> Dict[str, Any]:
    """The ``/archive/stats`` endpoint body; disarmed shape mirrors the
    other planes."""
    ar = _ARCHIVE if _ARMED else None
    if ar is None:
        return {"armed": False, "segments": 0, "bytes": 0}
    return dict(ar.stats(), armed=True)
